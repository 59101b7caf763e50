"""LayerNorm (param defs + pure apply); RMSNorm is not ported."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.nn.module import Param


def norm_defs(d_model: int, norm_type: str) -> dict:
    if norm_type != "layernorm":
        raise NotImplementedError(
            f"norm {norm_type!r} is not ported (ROADMAP.md queue 1, item 10)"
        )
    return {
        "scale": Param((d_model,), ("embed",), init="ones",
                       no_weight_decay=True, no_trust_ratio=True),
        "bias": Param((d_model,), ("embed",), init="zeros",
                      no_weight_decay=True, no_trust_ratio=True),
    }


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """LayerNorm in fp32 with eps 1e-6 (not torch's 1e-5), cast back; the
    reference's formula, term for term."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) / torch.sqrt(var + eps) * p["scale"].to(torch.float32)
    return (y + p["bias"].to(torch.float32)).to(x.dtype)
