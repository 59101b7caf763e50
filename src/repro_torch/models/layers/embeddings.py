"""Token embeddings, output heads (tied and untied) and rotary position
embeddings.

Over a ``model`` axis whose specs split ``vocab``, this rank's table holds
V/M rows: the lookup reads zero for a token outside them and sums over
``model``, and the heads are column-parallel over the vocab, giving this
rank's (B, S, V/M) slice of the logits (``train/loss.py`` reduces them)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers.tensor_parallel import column_matmul, split_axis
from repro_torch.nn.module import Param
from repro_torch.sharding.collectives import reduce_from_model
from repro_torch.sharding.context import model_parallel


def embed_defs(vocab_size: int, d_model: int) -> Param:
    return Param((vocab_size, d_model), ("vocab", "embed"), init="embed", scale=0.02)


def unembed_defs(d_model: int, vocab_size: int) -> Param:
    return Param((d_model, vocab_size), ("embed", "vocab"), init="fan_in")


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype,
          vocab: Optional[int] = None) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  ``vocab`` is the whole
    vocabulary: a table of fewer rows is this rank's slice over ``model``,
    where a token outside it reads zero and the ranks' lookups are summed
    (exactly: one rank holds each row), and each rank's gradient lands on
    its own rows."""
    tp = split_axis(table.shape[0], vocab or table.shape[0], model_parallel())
    if tp is None:
        return F.embedding(tokens.long(), table.to(dtype))
    rows = table.shape[0]
    local = tokens.long() - tp.index * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(mine, local, 0), table.to(dtype))
    return reduce_from_model(torch.where(mine[..., None], x, 0), tp.group)


def unembed(x: torch.Tensor, proj: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """``einsum("bsd,dv->bsv")`` against the (D, V) untied head (this
    rank's vocab columns when ``proj`` holds fewer than ``vocab``)."""
    tp = split_axis(proj.shape[1], vocab or proj.shape[1], model_parallel())
    return column_matmul(x, proj.to(x.dtype), tp)


def tied_unembed(x: torch.Tensor, table: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """``einsum("bsd,vd->bsv")`` against the (V, D) embedding table (this
    rank's vocab rows when ``table`` holds fewer than ``vocab``)."""
    tp = split_axis(table.shape[0], vocab or table.shape[0], model_parallel())
    return column_matmul(x, table.to(x.dtype).t(), tp)


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
