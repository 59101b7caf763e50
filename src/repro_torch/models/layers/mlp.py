"""Feed-forward blocks: gated (SwiGLU/GeGLU) and vanilla.

Over a ``model`` axis whose specs split ``ff``, ``wi``/``wg`` are
column-parallel and ``wo`` row-parallel (``layers/tensor_parallel.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.tensor_parallel import column_matmul, row_matmul, split_axis
from repro_torch.nn.module import Param
from repro_torch.sharding.context import model_parallel

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


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """``act(x @ wi) @ wo``; gated: ``(act(x @ wg) * (x @ wi)) @ wo``, the
    gate being ``wg`` as in the reference.  ``d_ff`` is the whole width
    (``cfg.d_ff`` by default; the MoE's shared expert has its own)."""
    dtype = x.dtype
    act = _ACTS[cfg.act_fn]
    tp = split_axis(p["wi"].shape[1], d_ff or cfg.d_ff, model_parallel())
    h = column_matmul(x, p["wi"].to(dtype), tp)
    if "wg" in p:
        h = act(column_matmul(x, p["wg"].to(dtype), tp)) * h
    else:
        h = act(h)
    return row_matmul(h, p["wo"].to(dtype), tp)
