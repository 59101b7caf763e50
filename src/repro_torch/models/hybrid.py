"""Jamba-style hybrid model: Mamba and attention interleaved 7:1, MoE every
other layer (arXiv:2403.19887); port of ``repro.models.hybrid``.

The stacked unit is a period of ``attn_period`` heterogeneous sub-layers
(``groups/sub{i}`` leaves stacked ``(n_layers / attn_period, ...)``): the
attention layer mid-period (``attn_period // 2``: NoPE, GQA, flash K3–K5
when ``use_flash_kernel``, through the port's ``attention``), Mamba
elsewhere; the FFN is the MoE layer where ``i % moe_period_in_block == 1``
(with experts) and the MLP elsewhere.  Each period sums its MoE layers' aux
losses and :func:`forward` averages those over the periods, as the
reference's ``jnp.mean`` over its scanned periods.  As in
``transformer.py`` the stack is split once per forward and a Python loop
runs the periods (one path for ``scan_layers`` either way);
``remat="full"`` recomputes each period in the backward.

The cache mixes the two: the attention sub-layer's ``{"k", "v", "index"}``
(written in place by ``attention``) and each Mamba sub-layer's ``{"ssm",
"conv"}`` state (overwritten in place with the state after the call), every
leaf stacked ``(n_groups, B, ...)``.

Over a ``model`` axis each sub-layer splits as its module says (Mamba's
``inner``, the attention's heads, the MoE's experts, the MLP's ff) and the
embedding and head their vocab rows (``cfg.vocab_size`` is the whole).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import attention, attention_defs, init_kv_cache
from repro_torch.models.layers.embeddings import embed, embed_defs, unembed, unembed_defs
from repro_torch.models.layers.mamba import init_mamba_state, mamba, mamba_defs
from repro_torch.models.layers.mlp import mlp, mlp_defs
from repro_torch.models.layers.moe import moe, moe_defs
from repro_torch.models.layers.norms import apply_norm, norm_defs
from repro_torch.models.transformer import check_flash_softcap

Cache = Dict[str, Dict[str, torch.Tensor]]


def _attn_index(cfg: ModelConfig) -> int:
    # the attention layer mid-period (Jamba: 1 attention per 8 layers)
    return cfg.attn_period // 2


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.n_experts > 0 and i % cfg.moe_period_in_block == 1


def hybrid_defs(cfg: ModelConfig) -> dict:
    check_flash_softcap(cfg)
    d = cfg.d_model
    period: Dict[str, Any] = {}
    for i in range(cfg.attn_period):
        sub = {
            "ln1": norm_defs(d, cfg.norm_type),
            "ln2": norm_defs(d, cfg.norm_type),
            "mixer": attention_defs(cfg) if i == _attn_index(cfg) else mamba_defs(cfg),
        }
        if _is_moe_layer(cfg, i):
            sub["ffn_moe"] = moe_defs(cfg)
        else:
            sub["ffn"] = mlp_defs(d, cfg.d_ff, cfg.gated_mlp, cfg.act_fn)
        period[f"sub{i}"] = sub
    return {
        "embed": embed_defs(cfg.vocab_size, d),
        "groups": nn.stack(period, cfg.n_layers // cfg.attn_period),
        "final_norm": norm_defs(d, cfg.norm_type),
        "unembed": unembed_defs(d, cfg.vocab_size),
    }


def _period(gp: Dict[str, torch.Tensor], x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, caches, decode: bool, chunk: Optional[int]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One period on x: ``(x, aux summed over its MoE layers)``; ``caches``
    (or None) holds each sub-layer's cache, written in place."""
    aux: Dict[str, torch.Tensor] = {}
    for i in range(cfg.attn_period):
        key = f"sub{i}"
        cache = None if caches is None else caches[key]
        h = apply_norm(nn.subtree(gp, f"{key}/ln1"), x, cfg.norm_type)
        mixer = nn.subtree(gp, f"{key}/mixer")
        if i == _attn_index(cfg):
            out = attention(mixer, h, positions, cfg, cache=cache, decode=decode)
        else:
            out, new = mamba(mixer, h, cfg, state=cache, decode=decode, chunk=chunk)
            if cache is not None:
                for k, v in new.items():
                    cache[k].copy_(v)
        x = x + out
        h = apply_norm(nn.subtree(gp, f"{key}/ln2"), x, cfg.norm_type)
        if f"{key}/ffn_moe/router" in gp:
            out, sub_aux = moe(nn.subtree(gp, f"{key}/ffn_moe"), h, cfg)
            for k, v in sub_aux.items():
                aux[k] = aux[k] + v if k in aux else v
        else:
            out = mlp(nn.subtree(gp, f"{key}/ffn"), h, cfg)
        x = x + out
    return x, aux


def forward(
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    caches: Optional[Cache] = None,
    decode: bool = False,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(logits (B, S, V), aux)``: the aux losses averaged over the periods
    (empty without experts).  With ``caches`` a prefill (or, with
    ``decode``, a step at ``positions``) that fills them in place.  The
    Mamba scans run in chunks of ``cfg.mamba_chunk`` where it is set."""
    chunk = cfg.mamba_chunk
    dtype = nn.torch_dtype(cfg.activation_dtype)
    x = embed(params["embed"], batch["tokens"], dtype, cfg.vocab_size)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    stacked = {k: torch.unbind(v, 0) for k, v in nn.subtree(params, "groups").items()}
    auxs = []
    for g in range(cfg.n_layers // cfg.attn_period):
        gp = {k: v[g] for k, v in stacked.items()}
        cache = None if caches is None else {
            seg: {k: v[g] for k, v in leaves.items()} for seg, leaves in caches.items()}
        if cfg.remat == "full" and cache is None:
            # the period draws no random numbers: no RNG state to stash
            x, aux = torch.utils.checkpoint.checkpoint(
                _period, gp, x, positions, cfg, None, decode, chunk,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _period(gp, x, positions, cfg, cache, decode, chunk)
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    x = apply_norm(nn.subtree(params, "final_norm"), x, cfg.norm_type)
    return unembed(x, params["unembed"], cfg.vocab_size), aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device=None) -> Cache:
    """The attention sub-layer's zeroed k/v cache (``max_len`` positions,
    ``dtype``) and each Mamba sub-layer's zero state (conv ring in
    ``dtype``), stacked ``(n_groups, B, ...)``."""
    n_groups = cfg.n_layers // cfg.attn_period
    cache: Cache = {}
    for i in range(cfg.attn_period):
        one = (init_kv_cache(batch, max_len, cfg, dtype, device) if i == _attn_index(cfg)
               else init_mamba_state(batch, cfg, dtype, device))
        cache[f"sub{i}"] = {k: v.expand((n_groups,) + v.shape).clone() for k, v in one.items()}
    return cache
