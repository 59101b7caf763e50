"""Feed-forward block: the vanilla GELU MLP of bert-large (gated variants and
other activations are not ported)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.module import Param

def mlp_defs(d_model: int, d_ff: int, gated: bool, act_fn: str) -> dict:
    if gated or act_fn != "gelu":
        raise NotImplementedError(
            f"MLP gated={gated} act_fn={act_fn!r} is not ported (ROADMAP.md "
            "queue 1, item 10)"
        )
    return {
        "wi": Param((d_model, d_ff), ("embed", "ff")),
        "wo": Param((d_ff, d_model), ("ff", "embed")),
    }


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dtype = x.dtype
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["wi"].to(dtype), approximate="tanh")
    return h @ p["wo"].to(dtype)
