"""Mamba (S6) selective state-space layer, used by Jamba's hybrid blocks
(port of ``repro.models.layers.mamba``).

Training/prefill runs the diagonal recurrence h_t = a_t·h_{t−1} + bx_t as a
parallel scan over time; decode keeps O(1) recurrent state: the ssm state
(B, Di, N) in fp32 and the causal conv's ring buffer (B, d_conv − 1, Di).
The reference's ``jax.lax.associative_scan`` becomes a log-depth
Hillis–Steele scan over axis 1 in plain PyTorch (``_scan``): the same
combine, (a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2), over another tree, so the
fp32 sums round in another order.  ``chunk`` bounds the (B, S, Di, N)
intermediates as the reference's does: the scan runs chunk by chunk,
carrying the state across, and S must be a multiple of ``chunk`` (the
reference's reshape refuses anything else).  No TPU kernel of the reference
covers this layer.

Over a ``model`` axis of M ranks whose specs split ``inner`` (d_inner),
each rank computes on its d_inner/M slice: ``in_proj``'s stored block (the
spec splits its 2·d_inner columns contiguously, so at M=2 rank 0 holds all
of x's columns and rank 1 all of z's) is gathered over ``model`` and the
rank takes its slice of x's and of z's columns
(``tensor_parallel.paired_columns``), a column-parallel product.  The
conv, ``dt_proj``'s columns, ``dt_bias``, ``A_log``, ``D`` and the scan
are elementwise over d_inner and so local; ``x_proj`` contracts d_inner:
its partials are summed over ``model`` in fp32 and rounded once before the
split into dt, B and C, whose gradients (from the rank's slice only) are
summed over ``model``; ``out_proj`` is row-parallel.  Where d_inner is no
multiple of M the layer runs whole on every rank.

State on such a mesh (serving): where the cache's specs split ``inner``
(the dry-run's rule ``inner=("model",)``) the rank's ``ssm`` (B, Di/M, N)
and ``conv`` (B, d_conv − 1, Di/M) are its slice, and the conv and scan
are local.  Where they do not (the reference's default activation rules
have no ``inner`` rule) the state is whole on every rank: the rank steps
its slice of it and gathers the new state over ``model``, so that every
rank holds the whole logical state, as the reference's array is.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.tensor_parallel import (
    column_matmul,
    paired_columns,
    row_matmul,
    split_axis,
)
from repro_torch.nn.module import Param
from repro_torch.sharding.collectives import copy_to_model, gather_leaf
from repro_torch.sharding.context import model_parallel

State = Dict[str, torch.Tensor]


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba_dt_rank or math.ceil(cfg.d_model / 16)


def mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    r = dt_rank(cfg)
    norm = dict(no_weight_decay=True, no_trust_ratio=True)
    return {
        "in_proj": Param((d, 2 * di), ("embed", "inner")),
        "conv_w": Param((cfg.mamba_d_conv, di), ("conv", "inner"), init="fan_in"),
        "conv_b": Param((di,), ("inner",), init="zeros", **norm),
        "x_proj": Param((di, r + 2 * n), ("inner", "state")),
        "dt_proj": Param((r, di), ("state", "inner")),
        "dt_bias": Param((di,), ("inner",), init="uniform_scalar", scale=0.1, **norm),
        # A stored as log(-A) for stability; shape (d_inner, n)
        "A_log": Param((di, n), ("inner", "state"), init="uniform_scalar", scale=1.0,
                       no_weight_decay=True),
        "D": Param((di,), ("inner",), init="ones", **norm),
        "out_proj": Param((di, d), ("inner", "embed")),
    }


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t·h_{t−1} + b_t over axis 1 from h = 0:
    log2(S) rounds, round k combining each position with the one 2^k
    before it."""
    step, s = 1, a.shape[1]
    while step < s:
        a_hi, b_hi = a[:, step:], b[:, step:]
        b = torch.cat([b[:, :step], a_hi * b[:, :-step] + b_hi], 1)
        if 2 * step < s:   # the last round's products of a are not used
            a = torch.cat([a[:, :step], a[:, :-step] * a_hi], 1)
        step *= 2
    return b


def _ssm_scan(
    a: torch.Tensor,    # (B, S, Di, N) decay terms exp(dt·A)
    bx: torch.Tensor,   # (B, S, Di, N) input terms dt·B·x
    h0: Optional[torch.Tensor] = None,   # (B, Di, N)
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t·h_{t−1} + bx_t from h0 (zero when None): (all h, final h)."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    s = a.shape[1]
    if chunk is None or chunk >= s:
        h = _scan(a, bx)
        return h, h[:, -1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of mamba chunk {chunk}")
    # chunked: carry the final state across fixed-size chunks (memory bound by
    # chunk instead of S)
    carry = torch.zeros_like(a[:, 0])
    hs = []
    for c0 in range(0, s, chunk):
        ac, bc = a[:, c0:c0 + chunk], bx[:, c0:c0 + chunk]
        bc = torch.cat([bc[:, :1] + ac[:, :1] * carry[:, None], bc[:, 1:]], 1)
        h = _scan(ac, bc)
        carry = h[:, -1]
        hs.append(h)
    return torch.cat(hs, 1), carry


def mamba(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
    decode: bool = False,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d) → (out (B, S, d), new state or None).  State:
    ``{"ssm": (B, Di, N) fp32, "conv": (B, d_conv − 1, Di)}``; decode (with a
    state) takes one token."""
    dtype = x.dtype
    whole = cfg.mamba_expand * cfg.d_model
    n, r, dc = cfg.mamba_d_state, dt_rank(cfg), cfg.mamba_d_conv
    b, s, _ = x.shape
    # this rank's d_inner: all of it, or d_inner/M over a model axis
    di = p["D"].shape[0]
    axis = model_parallel()
    tp = split_axis(di, whole, axis)
    gathered = tp is not None and state is not None and state["ssm"].shape[1] == whole
    if gathered:   # a whole state: this rank's slice of it
        lo = tp.index * di
        state = {"ssm": state["ssm"][:, lo:lo + di], "conv": state["conv"][..., lo:lo + di]}

    w_in = paired_columns(p["in_proj"], whole, axis)
    xi, z = column_matmul(x, w_in.to(dtype), tp).chunk(2, dim=-1)
    conv_w = p["conv_w"].to(dtype)

    # depthwise causal conv over time (einsums over the window, as the
    # reference's: one rounding of the d_conv-term sum)
    if decode and state is not None:
        hist = torch.cat([state["conv"].to(dtype), xi], 1)          # (B, dc-1+s, Di)
        new_conv = hist[:, -(dc - 1):]
        conv = torch.einsum("bcd,cd->bd", hist[:, -dc:], conv_w)[:, None]
    else:
        hist = torch.cat([xi.new_zeros((b, dc - 1, di)), xi], 1)
        idx = torch.arange(s, device=x.device)[:, None] + torch.arange(dc, device=x.device)
        conv = torch.einsum("bscd,cd->bsd", hist[:, idx], conv_w)
        new_conv = hist[:, -(dc - 1):] if state is not None else None
    conv = F.silu(conv + p["conv_b"].to(dtype))

    # data-dependent dt, B, C
    xdb = row_matmul(conv, p["x_proj"].to(dtype), tp)
    if tp is not None:   # the rank's d_inner slice's share of their gradients
        xdb = copy_to_model(xdb, tp.group)
    dt_in, b_in, c_in = xdb.split([r, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].to(dtype) + p["dt_bias"].to(dtype)).to(torch.float32)

    a_mat = -torch.exp(p["A_log"].to(torch.float32))                  # (Di, N)
    a = torch.exp(dt[..., None] * a_mat)                               # (B, S, Di, N)
    bx = (dt * conv.to(torch.float32))[..., None] * b_in.to(torch.float32)[:, :, None, :]

    if decode and state is not None:
        h = a[:, 0] * state["ssm"] + bx[:, 0]                          # (B, Di, N)
        new_state = {"ssm": h, "conv": new_conv.to(state["conv"].dtype)}
        y = (h @ c_in[:, 0].to(torch.float32)[..., None])[..., 0][:, None]
    else:
        hs, h_final = _ssm_scan(a, bx, None if state is None else state["ssm"], chunk)
        y = (hs @ c_in.to(torch.float32)[..., None])[..., 0]           # einsum bsdn,bsn->bsd
        new_state = (None if state is None
                     else {"ssm": h_final, "conv": new_conv.to(state["conv"].dtype)})

    y = (y + conv.to(torch.float32) * p["D"].to(torch.float32)).to(dtype)
    y = y * F.silu(z)
    if gathered:   # every rank's slice of the new state, whole on every rank
        new_state = {"ssm": gather_leaf(new_state["ssm"].contiguous(), 1, tp.group),
                     "conv": gather_leaf(new_state["conv"].contiguous(), 2, tp.group)}
    return row_matmul(y, p["out_proj"].to(dtype), tp), new_state


def init_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> State:
    di = cfg.mamba_expand * cfg.d_model
    return {
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype, device=device),
    }
