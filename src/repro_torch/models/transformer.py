"""Unified transformer: dense / GQA / MQA / MoE, with the vision and audio
stub frontends; train/encoder forward, prefill and decode over a stacked KV
cache (port of ``repro.models.transformer``).

The JAX package ``lax.scan``s a block over stacked ``(layers, ...)`` leaves;
here the stack is split once per forward with ``torch.unbind`` (whose
backward is a single ``stack``, so the gradient of each stacked leaf comes
back as one contiguous ``(layers, ...)`` tensor — the view the LAMB kernels
take) and a Python loop runs the blocks.  Indexing ``p[i]`` per layer
instead would make every ``select`` backward allocate a zero tensor the size
of the whole stack.

``cfg.remat == "full"`` recomputes each block's forward in the backward
(``torch.utils.checkpoint``, non-reentrant: the reference's
``jax.checkpoint`` on the scanned block body), so only the blocks' inputs
stay alive between the passes; the flash ``autograd.Function`` runs its
forward (K3) again per layer in the backward and saves the same residuals.

Caches are the reference's ``_stacked_cache``: ``{"main": {"k", "v",
"index"}}`` with (n_layers, B, T, Hkv, Dh) k/v and an (n_layers,) int32
index ((n_layers, B) in the serving slot pool); layer i reads and writes
its slice ``cache[i]`` in place.

A block's MLP is the MoE layer when ``cfg.n_experts`` (every block: the
reference has no dense interleave outside DeepSeek's prefix); each MoE block
returns its aux losses and :func:`forward` averages every entry over the
layers, as the reference's ``jnp.mean`` over the scanned stack.  The head is
the tied embedding or an untied ``unembed`` (D, V), with the final logits
soft-capped where ``cfg.logit_softcap``.  The ``audio_stub`` frontend takes
``frame_embeds`` (frames under ``mask`` replaced by the learned
``mask_embed``), the ``vision_stub`` one prepends ``image_embeds`` to the
token embeddings.  Still unported, and raising (ROADMAP.md queue 1, item
10): MLA, a dense prefix and MTP.  The ``hybrid`` and ``ssm`` families are
``models/hybrid.py`` and ``models/xlstm_model.py``.
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
from repro_torch.models.layers.mlp import mlp, mlp_defs
from repro_torch.models.layers.moe import moe, moe_defs
from repro_torch.models.layers.norms import apply_norm, norm_defs

_UNPORTED = {
    "use_mla": "MLA",
    "n_dense_layers": "dense prefix blocks",
    "use_mtp": "MTP",
}


def check_flash_softcap(cfg: ModelConfig) -> None:
    """Refuse flash attention with a logit softcap (the kernels take raw
    scores; the reference warns and takes dense attention instead)."""
    if cfg.use_flash_kernel and cfg.logit_softcap is not None:
        raise ValueError(
            "use_flash_kernel cannot apply logit_softcap (the flash kernels "
            "take raw scores); disable one of the two"
        )


def _check_ported(cfg: ModelConfig) -> None:
    check_flash_softcap(cfg)
    for field, what in _UNPORTED.items():
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{what} is not ported (ROADMAP.md queue 1, item 10)"
            )


def _block_defs(cfg: ModelConfig, *, is_moe: bool) -> dict:
    d = cfg.d_model
    block = {
        "ln1": norm_defs(d, cfg.norm_type),
        "ln2": norm_defs(d, cfg.norm_type),
        "attn": attention_defs(cfg),
    }
    if is_moe:
        block["moe"] = moe_defs(cfg)
    else:
        block["mlp"] = mlp_defs(d, cfg.d_ff, cfg.gated_mlp, cfg.act_fn)
    return block


def transformer_defs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    defs: Dict[str, Any] = {
        "embed": embed_defs(cfg.vocab_size, cfg.d_model),
        "blocks": nn.stack(_block_defs(cfg, is_moe=cfg.n_experts > 0), cfg.n_layers),
        "final_norm": norm_defs(cfg.d_model, cfg.norm_type),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_defs(cfg.d_model, cfg.vocab_size)
    if cfg.frontend == "audio_stub" and cfg.mask_ratio > 0:
        defs["mask_embed"] = nn.Param((cfg.d_model,), ("embed",), init="normal", scale=0.02)
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
    x = x + attention(nn.subtree(bp, "attn"), h, positions, cfg, cache=cache, decode=decode,
                      valid_len=valid_len)
    h = apply_norm(nn.subtree(bp, "ln2"), x, cfg.norm_type)
    if "moe/router" in bp:
        ff_out, aux = moe(nn.subtree(bp, "moe"), h, cfg)
        return x + ff_out, aux
    return x + mlp(nn.subtree(bp, "mlp"), h, cfg), {}


def _embed_inputs(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """Token or prefix-embedding entry, per modality frontend."""
    if cfg.frontend == "audio_stub":
        x = batch["frame_embeds"].to(dtype)
        if cfg.mask_ratio > 0 and "mask" in batch:
            x = torch.where(batch["mask"][..., None], params["mask_embed"].to(dtype), x)
        return x
    x = embed(params["embed"], batch["tokens"], dtype)
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
    main = None if caches is None else caches["main"]

    stacked = {k: torch.unbind(v, 0) for k, v in nn.subtree(params, "blocks").items()}
    auxs = []
    for i in range(cfg.n_layers):
        bp = {k: v[i] for k, v in stacked.items()}
        cache = None if main is None else {k: v[i] for k, v in main.items()}
        if cfg.remat == "full" and cache is None:
            # the block draws no random numbers: no RNG state to stash
            x, aux = torch.utils.checkpoint.checkpoint(
                _one_block, bp, x, positions, cfg, valid_len=valid_len,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _one_block(bp, x, positions, cfg, cache=cache, decode=decode,
                                valid_len=valid_len)
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

    x = apply_norm(nn.subtree(params, "final_norm"), x, cfg.norm_type)
    if return_hidden:
        return x, aux
    if cfg.tie_embeddings:
        logits = tied_unembed(x, params["embed"])
    else:
        logits = unembed(x, params["unembed"])
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The zeroed stacked cache of every layer: ``{"main": {"k", "v", "index"}}``
    with a leading (n_layers,) axis on each leaf."""
    one = init_kv_cache(batch, max_len, cfg, dtype, device)
    return {"main": {k: v.expand((cfg.n_layers,) + v.shape).clone() for k, v in one.items()}}
