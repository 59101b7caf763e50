"""Megatron-style products over the ambient ``model`` axis.

A layer whose weight the mesh splits over ``model`` computes on this rank's
heads, ff columns or vocab rows (the step gathers each leaf over the
data-parallel ranks only).  A column-parallel product (``wq``, ``wk``,
``wv``, ``wi``, ``wg``, the vocab head) takes the whole input and gives this
rank's columns; its input's gradient is a partial over the rank's columns,
summed over ``model``.  A row-parallel product (``wo``) takes this rank's
columns and gives a partial of the whole output, summed over ``model``.

Every product runs in the operands' own dtype, as on one device.  Where
the ranks split a contraction (the row-parallel forward, the
column-parallel input gradient), each rank keeps its partial as the fp32
accumulator, unrounded (:func:`_mm32`: on the card one tensor-core GEMM of
the 16-bit operands with an fp32 output), the partials are summed in fp32
and the sum is rounded once, as one device rounds its accumulator once.
Only the order of the fp32 sums then differs from one device.  The other
products split nothing and are the plain ones.  With ``tp`` None (no mesh,
or one ``model`` rank) both are the plain product.  On the ranks of
``collectives.run_plain_ranks`` each is its differentiable plain version
(the row-parallel sum of fp32 partials, rounded once, by the plain
collective), so that autograd takes the gradients across the ranks.

A leaf whose ``(…, 2·half)`` columns a layer splits into two inputs (Mamba's
``in_proj``, the mLSTM's ``up_proj``: ``x`` and the gate ``z``) is stored
as the spec splits the ``2·half`` columns, contiguously over ``model``; the
rank computes on its slice of each half (:func:`paired_columns`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.collectives import (
    all_reduce,
    gather_leaf,
    is_plain,
    reduce_from_model_plain,
    scatter_grad,
    shard_leaf,
)
from repro_torch.sharding.context import ModelAxis


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands as its fp32 accumulator.  A 16-bit pair on
    the card runs as one GEMM with an fp32 output; elsewhere it is the fp32
    product of the exact upcasts (the same products, summed in fp32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


class _Column(torch.autograd.Function):
    """``x @ w``; backward ``dx = Σ_model g @ wᵀ`` from fp32 partials."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = all_reduce(_mm32(_rows(g), w.t()), "sum", ctx.group)
            dx = dx.to(x.dtype).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _rows(x).t() @ _rows(g)
        return dx, dw, None


class _Row(torch.autograd.Function):
    """``Σ_model h @ w`` from fp32 partials; backward the plain product's."""

    @staticmethod
    def forward(ctx, h, w, group):
        ctx.save_for_backward(h, w)
        y = all_reduce(_mm32(_rows(h), w), "sum", group).to(h.dtype)
        return y.view(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = (g @ w.t()) if ctx.needs_input_grad[0] else None
        dw = _rows(h).t() @ _rows(g) if ctx.needs_input_grad[1] else None
        return dh, dw, None


def column_matmul(x: torch.Tensor, w: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """``x @ w`` for this rank's columns of ``w`` (2-D); ``x`` is whole on
    every ``model`` rank and its gradient's partials are summed over them."""
    if tp is None or is_plain(tp.group):
        return x @ w
    return _Column.apply(x, w, tp.group)


def row_matmul(h: torch.Tensor, w: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """``h @ w`` summed over the ``model`` ranks, each holding its columns
    of ``h`` and rows of ``w`` (2-D)."""
    if tp is None:
        return h @ w
    if is_plain(tp.group):
        part = h.to(torch.float32) @ w.to(torch.float32)
        tp.group.record("all-reduce", part)
        return reduce_from_model_plain(tp.group.exchange(part)).to(h.dtype)
    return _Row.apply(h, w, tp.group)


class _KvHeads(torch.autograd.Function):
    """The whole kv heads' rows for this rank's q heads; backward adds each
    q head's rows into its kv head in fp32, sums the ranks' partials over
    ``model`` and rounds once."""

    @staticmethod
    def forward(ctx, k, idx, group):
        ctx.save_for_backward(idx)
        ctx.group, ctx.shape, ctx.dtype = group, k.shape, k.dtype
        return k.index_select(2, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_add_(2, idx, g.to(torch.float32))
        return all_reduce(acc, "sum", ctx.group).to(ctx.dtype), None, None


def kv_head_index(heads: int, n_heads: int, n_kv_heads: int, tp: ModelAxis,
                  device=None) -> torch.Tensor:
    """The global kv head of each of this rank's ``heads`` q heads: q head
    ``h0 + j`` (``h0`` the rank's first) reads kv head
    ``(h0 + j)·Hkv // H``, as on one device.  Made on ``device`` (no host
    copy)."""
    q = torch.arange(heads, device=device) + tp.index * heads
    return q * n_kv_heads // n_heads


def kv_heads_for_rank(k: torch.Tensor, idx: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """``k`` (B, T, Hkv, Dh), whole on every ``model`` rank, as the rows of
    this rank's q heads (B, T, h, Dh): attention then runs as MHA on the
    rank's heads.  Each rank back-propagates only its own q heads' share,
    so the kv heads' gradient is summed over ``model`` (in fp32, rounded
    once); everything upstream of ``k`` (the projection, its weight and
    bias, and ``x``) then sees the whole gradient on every rank."""
    if is_plain(tp.group):
        return k.index_select(2, idx)
    return _KvHeads.apply(k, idx, tp.group)


def split_axis(local: int, whole: int, tp: Optional[ModelAxis]) -> Optional[ModelAxis]:
    """``tp`` when a dimension of ``whole`` is split over it (this rank
    holds ``local`` of it), else None: a dimension the specs keep whole
    (not divisible by the ``model`` size) runs replicated on every rank."""
    if tp is None or local == whole:
        return None
    if local * tp.size != whole:
        raise ValueError(f"a dimension of {whole} holds {local} on one of {tp.size} "
                         "model ranks")
    return tp


class _PairedColumns(torch.autograd.Function):
    """The whole leaf gathered over ``model``, then this rank's columns of
    each half (``split``) or all of them; backward: the columns' gradient
    placed in a whole-shaped zero leaf and reduce-scattered over ``model``
    (each column from one rank: the sum is exact), or, on a layer every
    rank runs whole (its gradient whole on every rank), the rank's own
    block of it."""

    @staticmethod
    def forward(ctx, w, half, split, tp):
        ctx.half, ctx.split, ctx.tp = half, split, tp
        whole = gather_leaf(w, w.dim() - 1, tp.group)
        return _pair_slice(whole, half, tp) if split else whole

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, g.dim() - 1
        if not ctx.split:
            return shard_leaf(g, dim, tp.size, tp.index), None, None, None
        # summed in fp32 (every backend carries it), exact: one rank a column
        n = ctx.half // tp.size
        whole = g.new_zeros(*g.shape[:-1], 2 * ctx.half, dtype=torch.float32)
        whole[..., tp.index * n:(tp.index + 1) * n] = g[..., :n]
        whole[..., ctx.half + tp.index * n:ctx.half + (tp.index + 1) * n] = g[..., n:]
        return scatter_grad(whole, dim, tp.group).to(g.dtype), None, None, None


def _pair_slice(whole: torch.Tensor, half: int, tp: ModelAxis) -> torch.Tensor:
    n = half // tp.size
    lo = tp.index * n
    return torch.cat([whole[..., lo:lo + n], whole[..., half + lo:half + lo + n]], -1)


def paired_columns(w: torch.Tensor, half: int, tp: Optional[ModelAxis]) -> torch.Tensor:
    """The columns of a ``(…, 2·half)`` leaf that this rank computes on,
    from its stored block ``w``: ``[its slice of the first half | its slice
    of the second half]`` where ``half`` splits over ``tp``, else (the
    layer runs whole on every rank) all ``2·half`` of them.  A leaf the
    spec keeps whole is ``w`` itself; a split one is gathered over
    ``model`` first (at ``model=2`` rank 0 stores the whole first half and
    rank 1 the second)."""
    if tp is None or w.shape[-1] == 2 * half:
        return w
    split = half % tp.size == 0
    if is_plain(tp.group):
        whole = gather_leaf(w, w.dim() - 1, tp.group)
        return _pair_slice(whole, half, tp) if split else whole
    return _PairedColumns.apply(w, half, split, tp)
