"""Normalization layers: LayerNorm and RMSNorm (param defs + pure apply)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.nn.module import Param


def norm_defs(d_model: int, norm_type: str) -> dict:
    scale = Param((d_model,), ("embed",), init="ones",
                  no_weight_decay=True, no_trust_ratio=True)
    if norm_type == "layernorm":
        bias = Param((d_model,), ("embed",), init="zeros",
                     no_weight_decay=True, no_trust_ratio=True)
        return {"scale": scale, "bias": bias}
    return {"scale": scale}


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, norm_type: str,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm, or RMSNorm for any other ``norm_type`` as in the reference:
    in fp32 with eps 1e-6 (not torch's 1e-5), cast back; the reference's
    formulas, term for term."""
    x32 = x.to(torch.float32)
    if norm_type == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) / torch.sqrt(var + eps) * p["scale"].to(torch.float32)
        y = y + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 / torch.sqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)
