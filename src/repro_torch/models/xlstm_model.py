"""xLSTM language model (arXiv:2405.04517): alternating mLSTM / sLSTM blocks
(port of ``repro.models.xlstm_model``).

The stacked unit is an (mLSTM, sLSTM) pair when ``slstm_ratio`` > 0 (the
350M config), all-mLSTM pairs otherwise: ``pairs/sub0`` and ``pairs/sub1``
leaves stacked ``(n_layers / 2, ...)``, each sub-block a pre-norm residual
``x + cell(norm(x))``, then the final norm and the tied unembedding.  As in
``transformer.py`` the stack is split once per forward and a Python loop
runs the pairs (the reference's ``lax.scan``, or its unrolled loop under
``scan_layers=False``: one path here, the same result); ``remat="full"``
recomputes each pair in the backward (``torch.utils.checkpoint``).

Decode is fully recurrent: the cache is the cells' state, O(1) in sequence
length (``make_cache`` ignores ``max_len``), ``{"sub0": {"c", "n", "m"},
"sub1": {"c", "n", "m", "h"}}`` with each leaf stacked ``(n_pairs, B, ...)``
in fp32, and no ``index`` leaf.  A prefill or decode step writes each
pair's new state into its slice of the cache, in place.

Over a ``model`` axis the cells split as ``layers/xlstm.py`` says and the
tied embedding its vocab rows (``cfg.vocab_size`` is the whole).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.embeddings import embed, embed_defs, tied_unembed
from repro_torch.models.layers.norms import apply_norm, norm_defs
from repro_torch.models.layers.xlstm import (
    init_mlstm_state,
    init_slstm_state,
    mlstm_block,
    mlstm_defs,
    slstm_block,
    slstm_defs,
)

Cache = Dict[str, Dict[str, torch.Tensor]]


def _pair_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.slstm_ratio and cfg.slstm_ratio > 0:
        return ("mlstm", "slstm")
    return ("mlstm", "mlstm")


def xlstm_defs(cfg: ModelConfig) -> dict:
    pair: Dict[str, Any] = {}
    for i, kind in enumerate(_pair_kinds(cfg)):
        pair[f"sub{i}"] = {
            "ln": norm_defs(cfg.d_model, cfg.norm_type),
            "cell": mlstm_defs(cfg) if kind == "mlstm" else slstm_defs(cfg),
        }
    return {
        "embed": embed_defs(cfg.vocab_size, cfg.d_model),
        "pairs": nn.stack(pair, cfg.n_layers // 2),
        "final_norm": norm_defs(cfg.d_model, cfg.norm_type),
    }


def _pair(pp: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, caches,
          decode: bool) -> torch.Tensor:
    """One (mLSTM, sLSTM) pair on x; ``caches`` (or None) holds each
    sub-block's state, overwritten in place with the state after it."""
    for i, kind in enumerate(_pair_kinds(cfg)):
        key = f"sub{i}"
        h = apply_norm(nn.subtree(pp, f"{key}/ln"), x, cfg.norm_type)
        fn = mlstm_block if kind == "mlstm" else slstm_block
        state = None if caches is None else caches[key]
        out, new = fn(nn.subtree(pp, f"{key}/cell"), h, cfg, state=state, decode=decode)
        if state is not None:
            for k, v in new.items():
                state[k].copy_(v)
        x = x + out
    return x


def forward(
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    caches: Optional[Cache] = None,
    decode: bool = False,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(logits (B, S, V), {})``; with ``caches`` a prefill (or, with
    ``decode``, a one-token step) that leaves the state after it in the
    cache.  ``positions`` is unused: the model has no position encoding."""
    del positions
    dtype = nn.torch_dtype(cfg.activation_dtype)
    x = embed(params["embed"], batch["tokens"], dtype, cfg.vocab_size)
    stacked = {k: torch.unbind(v, 0) for k, v in nn.subtree(params, "pairs").items()}
    for i in range(cfg.n_layers // 2):
        pp = {k: v[i] for k, v in stacked.items()}
        cache = None if caches is None else {
            seg: {k: v[i] for k, v in leaves.items()} for seg, leaves in caches.items()}
        if cfg.remat == "full" and cache is None:
            # the pair draws no random numbers: no RNG state to stash
            x = torch.utils.checkpoint.checkpoint(_pair, pp, x, cfg, None, decode,
                                                  use_reentrant=False,
                                                  preserve_rng_state=False)
        else:
            x = _pair(pp, x, cfg, cache, decode)
    x = apply_norm(nn.subtree(params, "final_norm"), x, cfg.norm_type)
    return tied_unembed(x, params["embed"], cfg.vocab_size), {}


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Each sub-block's zero state (m at -1e9) stacked ``(n_pairs, B, ...)``,
    fp32 whatever ``dtype``; ``max_len`` is unused (O(1) state)."""
    del max_len, dtype
    n_pairs = cfg.n_layers // 2
    cache: Cache = {}
    for i, kind in enumerate(_pair_kinds(cfg)):
        one = (init_mlstm_state if kind == "mlstm" else init_slstm_state)(batch, cfg, device)
        cache[f"sub{i}"] = {k: v.expand((n_pairs,) + v.shape).clone() for k, v in one.items()}
    return cache
