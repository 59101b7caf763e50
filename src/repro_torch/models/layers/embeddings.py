"""Token embeddings, output heads (tied and untied) and rotary position
embeddings."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.module import Param


def embed_defs(vocab_size: int, d_model: int) -> Param:
    return Param((vocab_size, d_model), ("vocab", "embed"), init="embed", scale=0.02)


def unembed_defs(d_model: int, vocab_size: int) -> Param:
    return Param((d_model, vocab_size), ("embed", "vocab"), init="fan_in")


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(tokens.long(), table.to(dtype))


def unembed(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dv->bsv")`` against the (D, V) untied head."""
    return x @ proj.to(x.dtype)


def tied_unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,vd->bsv")`` against the (V, D) embedding table."""
    return x @ table.to(x.dtype).t()


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for half the head dim."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    *,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Rotate the first ``dim`` (default: all) features of x, half-split.

    x: (B, S, H, D); positions: (B, S) int.  The rotation runs in fp32 and
    casts back to x's dtype.
    """
    d = dim or x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    angles = positions.to(torch.float32)[..., None] * inv  # (B, S, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr, rest = x[..., :d], x[..., d:]
    x1, x2 = torch.chunk(xr.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out
