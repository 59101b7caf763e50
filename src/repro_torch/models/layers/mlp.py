"""Feed-forward blocks: gated (SwiGLU/GeGLU) and vanilla."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.module import Param

# jax.nn.gelu defaults to the tanh approximation
_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def mlp_defs(d_model: int, d_ff: int, gated: bool, act_fn: str) -> dict:
    if act_fn not in _ACTS:
        # the reference refuses it too (a KeyError in its activation table)
        raise ValueError(f"unknown MLP act_fn {act_fn!r}; accepted: {sorted(_ACTS)}")
    defs = {
        "wi": Param((d_model, d_ff), ("embed", "ff")),
        "wo": Param((d_ff, d_model), ("ff", "embed")),
    }
    if gated:
        defs["wg"] = Param((d_model, d_ff), ("embed", "ff"))
    return defs


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x @ wi) @ wo``; gated: ``(act(x @ wg) * (x @ wi)) @ wo``, the
    gate being ``wg`` as in the reference."""
    dtype = x.dtype
    act = _ACTS[cfg.act_fn]
    h = x @ p["wi"].to(dtype)
    if "wg" in p:
        h = act(x @ p["wg"].to(dtype)) * h
    else:
        h = act(h)
    return h @ p["wo"].to(dtype)
