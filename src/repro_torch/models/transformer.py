"""Unified transformer: dense / GQA / MQA / MLA / MoE, with the vision and
audio stub frontends; train/encoder forward, prefill and decode over a
stacked KV cache (port of ``repro.models.transformer``).

The JAX package ``lax.scan``s a block over stacked ``(layers, ...)`` leaves;
here the stack is split once per forward with ``torch.unbind`` (whose
backward is a single ``stack``, so the gradient of each stacked leaf comes
back as one contiguous ``(layers, ...)`` tensor — the view the LAMB kernels
take) and a Python loop runs the blocks.  Indexing ``p[i]`` per layer
instead would make every ``select`` backward allocate a zero tensor the size
of the whole stack.  ``scan_layers`` has no effect: there is one path.

Two stacked segments, as in the reference: ``dense_blocks`` (DeepSeek's
``n_dense_layers`` leading dense blocks) run first, then ``blocks`` (the
other ``n_layers - n_dense_layers``, MoE when ``cfg.n_experts``).  Each
segment averages its blocks' aux losses over its own layers, and a key that
both report is averaged pairwise (only MoE blocks report any).

``cfg.remat == "full"`` recomputes each block's forward in the backward
(``torch.utils.checkpoint``, non-reentrant: the reference's
``jax.checkpoint`` on the scanned block body), so only the blocks' inputs
stay alive between the passes; the flash ``autograd.Function`` runs its
forward (K3) again per layer in the backward and saves the same residuals.

Caches are the reference's ``_stacked_cache``, a segment each: ``{"main":
..., "dense": ...}`` with ``{"k", "v", "index"}`` leaves ((layers, B, T, Hkv,
Dh) k/v) or, with ``cfg.use_mla``, ``{"c_kv", "k_rope", "index"}``, and an
(layers,) int32 index ((layers, B) in the serving slot pool); layer i
reads and writes its slice ``cache[i]`` in place.

Attention is ``layers/attention.py`` or, with ``cfg.use_mla``,
``layers/mla.py``.  The head is the tied embedding or an untied ``unembed``
(D, V), with the final logits soft-capped where ``cfg.logit_softcap``.
With ``cfg.use_mtp`` the forward also returns the post-final-norm hidden
states as ``aux["mtp_hidden"]`` (not on decode), which the loss feeds to
:func:`mtp_logits`.  The ``audio_stub`` frontend takes ``frame_embeds``
(frames under ``mask`` replaced by the learned ``mask_embed``), the
``vision_stub`` one prepends ``image_embeds`` to the token embeddings.  The
``hybrid`` and ``ssm`` families are ``models/hybrid.py`` and
``models/xlstm_model.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import attention, attention_defs, init_kv_cache
from repro_torch.models.layers.embeddings import (
    embed,
    embed_defs,
    tied_unembed,
    unembed,
    unembed_defs,
)
from repro_torch.models.layers.mla import init_mla_cache, mla_attention, mla_defs
from repro_torch.models.layers.mlp import mlp, mlp_defs
from repro_torch.models.layers.moe import moe, moe_defs
from repro_torch.models.layers.norms import apply_norm, norm_defs
from repro_torch.models.layers.tensor_parallel import row_matmul, split_axis
from repro_torch.sharding.collectives import copy_to_model
from repro_torch.sharding.context import model_parallel


def check_flash_softcap(cfg: ModelConfig) -> None:
    """Refuse flash attention with a logit softcap (the kernels take raw
    scores; the reference warns and takes dense attention instead)."""
    if cfg.use_flash_kernel and cfg.logit_softcap is not None:
        raise ValueError(
            "use_flash_kernel cannot apply logit_softcap (the flash kernels "
            "take raw scores); disable one of the two"
        )


def _block_defs(cfg: ModelConfig, *, is_moe: bool) -> dict:
    d = cfg.d_model
    block = {
        "ln1": norm_defs(d, cfg.norm_type),
        "ln2": norm_defs(d, cfg.norm_type),
        "attn": mla_defs(cfg) if cfg.use_mla else attention_defs(cfg),
    }
    if is_moe:
        block["moe"] = moe_defs(cfg)
    else:
        block["mlp"] = mlp_defs(d, cfg.d_ff, cfg.gated_mlp, cfg.act_fn)
    return block


def _n_main(cfg: ModelConfig) -> int:
    return cfg.n_layers - cfg.n_dense_layers


def transformer_defs(cfg: ModelConfig) -> dict:
    check_flash_softcap(cfg)
    defs: Dict[str, Any] = {
        "embed": embed_defs(cfg.vocab_size, cfg.d_model),
        "blocks": nn.stack(_block_defs(cfg, is_moe=cfg.n_experts > 0), _n_main(cfg)),
        "final_norm": norm_defs(cfg.d_model, cfg.norm_type),
    }
    if cfg.n_dense_layers:
        defs["dense_blocks"] = nn.stack(_block_defs(cfg, is_moe=False), cfg.n_dense_layers)
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_defs(cfg.d_model, cfg.vocab_size)
    if cfg.frontend == "audio_stub" and cfg.mask_ratio > 0:
        defs["mask_embed"] = nn.Param((cfg.d_model,), ("embed",), init="normal", scale=0.02)
    if cfg.use_mtp:
        defs["mtp"] = {
            "proj": nn.Param((2 * cfg.d_model, cfg.d_model), ("inner", "embed")),
            "block": _block_defs(cfg, is_moe=False),
            "norm": norm_defs(cfg.d_model, cfg.norm_type),
        }
    return defs


def unreachable_leaves(cfg: ModelConfig) -> frozenset:
    """The leaves no loss reaches: the token embedding of an ``audio_stub``
    model with an untied head (its inputs are frame embeddings).  The train
    step gives them a zero gradient, as ``jax.grad`` does."""
    if cfg.frontend == "audio_stub" and not cfg.tie_embeddings:
        return frozenset({"embed"})
    return frozenset()


def _one_block(
    bp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
    valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = apply_norm(nn.subtree(bp, "ln1"), x, cfg.norm_type)
    attend = mla_attention if cfg.use_mla else attention
    x = x + attend(nn.subtree(bp, "attn"), h, positions, cfg, cache=cache, decode=decode,
                   valid_len=valid_len)
    h = apply_norm(nn.subtree(bp, "ln2"), x, cfg.norm_type)
    if "moe/router" in bp:
        ff_out, aux = moe(nn.subtree(bp, "moe"), h, cfg)
        return x + ff_out, aux
    return x + mlp(nn.subtree(bp, "mlp"), h, cfg), {}


def _segment(
    stacked: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    caches: Optional[Dict[str, torch.Tensor]],
    decode: bool,
    valid_len: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run a homogeneous stack of blocks (stacked ``(layers, ...)`` leaves)
    over x, each layer on its slice of ``caches``; returns x and each aux
    entry averaged over the stack's layers (empty when no block has any)."""
    layers = {k: torch.unbind(v, 0) for k, v in stacked.items()}
    auxs = []
    for i in range(next(iter(stacked.values())).shape[0]):
        bp = {k: v[i] for k, v in layers.items()}
        cache = None if caches is None else {k: v[i] for k, v in caches.items()}
        if cfg.remat == "full" and cache is None:
            # the block draws no random numbers: no RNG state to stash
            x, aux = torch.utils.checkpoint.checkpoint(
                _one_block, bp, x, positions, cfg, valid_len=valid_len,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _one_block(bp, x, positions, cfg, cache=cache, decode=decode,
                                valid_len=valid_len)
        auxs.append(aux)
    return x, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def _embed_inputs(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """Token or prefix-embedding entry, per modality frontend."""
    if cfg.frontend == "audio_stub":
        x = batch["frame_embeds"].to(dtype)
        if cfg.mask_ratio > 0 and "mask" in batch:
            x = torch.where(batch["mask"][..., None], params["mask_embed"].to(dtype), x)
        return x
    x = embed(params["embed"], batch["tokens"], dtype, cfg.vocab_size)
    if cfg.frontend == "vision_stub" and "image_embeds" in batch:
        # decode steps carry no image prefix (it already lives in the cache)
        x = torch.cat([batch["image_embeds"].to(dtype), x], dim=1)
    return x


def forward(
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    caches: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    decode: bool = False,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(logits, aux)``: (B, S, V) logits of the output head and the MoE
    aux losses averaged over the layers (empty for a dense model).

    With ``caches`` (from :func:`make_cache`), prefill (``decode=False``)
    fills them and decode writes each layer's k/v at its index, in place;
    ``positions`` (B, S) default to 0..S-1, and ``valid_len`` is ignored on
    decode as in the reference.  ``return_hidden=True`` skips the vocab
    projection and returns the post-final-norm hidden states (B, S, D)
    instead: the fused CE head's path, which projects only the supervised
    positions (``train/loss.py``).
    """
    dtype = nn.torch_dtype(cfg.activation_dtype)
    x = _embed_inputs(params, batch, cfg, dtype)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    valid_len = None if decode else batch.get("valid_len")
    aux: Dict[str, torch.Tensor] = {}
    if cfg.n_dense_layers:
        x, aux = _segment(nn.subtree(params, "dense_blocks"), x, positions, cfg,
                          None if caches is None else caches["dense"], decode, valid_len)
    x, a = _segment(nn.subtree(params, "blocks"), x, positions, cfg,
                    None if caches is None else caches["main"], decode, valid_len)
    # a key both segments report is averaged pairwise, as in the reference
    aux.update({k: (aux[k] + v) / 2 if k in aux else v for k, v in a.items()})

    x = apply_norm(nn.subtree(params, "final_norm"), x, cfg.norm_type)
    if cfg.use_mtp and not decode:
        aux["mtp_hidden"] = x   # the MTP head's input, read by the loss
    if return_hidden:
        return x, aux
    if cfg.tie_embeddings:
        logits = tied_unembed(x, params["embed"], cfg.vocab_size)
    else:
        logits = unembed(x, params["unembed"], cfg.vocab_size)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, aux


def mtp_logits(params: Dict[str, torch.Tensor], hidden: torch.Tensor,
               batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3's single-depth MTP head: predict token t+2 from
    [h_t ; emb(t+1)] through one extra block (no cache, no window), its
    norm and the model's head.  The last position takes the first token's
    embedding, as ``jnp.roll`` wraps.  Over a ``model`` axis the logits are
    this rank's vocab columns, as the main head's."""
    dtype = hidden.dtype
    mp = nn.subtree(params, "mtp")
    nxt = torch.roll(embed(params["embed"], batch["tokens"], dtype, cfg.vocab_size), -1, dims=1)
    joined = torch.cat([hidden, nxt], dim=-1)
    # ``proj`` (2·D, D) splits its rows over model: a row-parallel product
    # of the rank's columns of the joined input, whose gradient (the rank's
    # columns only) is summed over model
    rows = mp["proj"].shape[0]
    tp = split_axis(rows, joined.shape[-1], model_parallel())
    if tp is not None:
        joined = copy_to_model(joined, tp.group)[..., tp.index * rows:(tp.index + 1) * rows]
    h = row_matmul(joined, mp["proj"].to(dtype), tp)
    b, s = h.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
    # window None, as the reference passes it
    h, _ = _one_block(nn.subtree(mp, "block"), h, positions, cfg.replace(sliding_window=None))
    h = apply_norm(nn.subtree(mp, "norm"), h, cfg.norm_type)
    if cfg.tie_embeddings:
        return tied_unembed(h, params["embed"], cfg.vocab_size)
    return unembed(h, params["unembed"], cfg.vocab_size)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The zeroed stacked cache of every layer, a segment each: ``{"main":
    ..., "dense": ...}`` (``dense`` only with a dense prefix), each leaf
    with a leading (layers,) axis: ``{"k", "v", "index"}``, or the MLA's
    ``{"c_kv", "k_rope", "index"}``."""
    init = init_mla_cache if cfg.use_mla else init_kv_cache
    one = init(batch, max_len, cfg, dtype, device)

    def stacked(n):
        return {k: v.expand((n,) + v.shape).clone() for k, v in one.items()}

    caches = {"main": stacked(_n_main(cfg))}
    if cfg.n_dense_layers:
        caches["dense"] = stacked(cfg.n_dense_layers)
    return caches
