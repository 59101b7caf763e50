"""xLSTM layers (Beck et al., 2024): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, a sequential scan with exponential gating); port
of ``repro.models.layers.xlstm``.

mLSTM train/prefill runs the paper's parallel (attention-like) form with
log-gate stabilisation over a (B, H, S, S) decay matrix in fp32; decode is
the O(d²) recurrent form: the matrix memory C (B, H, dh, dh), the
normaliser n and the stabiliser m, all fp32.  A prefill with state rolls the
whole prompt through the recurrence to build it, as the reference's
``lax.scan`` does (``layers/scan.scan``: a Python loop over time).

sLSTM is sequential (the recurrent R_z/R_i/R_f/R_o are block-diagonal per
head): a loop over time in fp32 (``layers/scan.scan``), the reference's
``lax.scan``.  No TPU kernel of the reference covers either cell: they run
as PyTorch ops.

Layouts and paths are the reference's, so the bridge carries weights over
by path; casts sit where the reference's do (weights cast to the
activation dtype where used; the mLSTM score product in that dtype, then
fp32).  The functions return ``(out, new_state)``; the caller writes a
cache's state in place.

Over a ``model`` axis of M ranks (the ambient sharding context):

* mLSTM, where ``inner`` (the up-projection's width) splits: the rank
  computes on its up/M columns.  ``up_proj``'s stored block is gathered
  over ``model`` and the rank takes its slice of x's and of z's columns
  (``tensor_parallel.paired_columns``).  ``wq``/``wk``/``wv`` and the gate
  weights split ``inner`` (it takes ``model`` before ``heads``), so q, k, v
  and the gate pre-activations are row-parallel sums over ``model``, whole
  on every rank, their gradients summed over ``model``; the rank runs the
  cell for its H/M heads (``b_igate``/``b_fgate`` split by heads), whose
  ``h`` columns are its ``inner`` slice, or, where M does not divide H,
  every head, keeping its ``inner`` columns of ``h``.  The RMS over the
  whole up-projection sums the squares over ``model``; ``out_norm`` is the
  rank's slice and ``down_proj`` row-parallel.
* sLSTM, where the heads split: ``w_{i,f,z,o}`` are column-parallel by
  heads and ``r_*``/``b_*`` the rank's heads, so the time loop runs the
  rank's heads only; their ``h`` is gathered over ``model`` into the
  concatenated heads, whose norm (``out_norm`` is whole) every rank takes
  as on one device, and the block's FF is the tensor-parallel MLP.

Where M divides neither, the block runs whole on every rank.

State on such a mesh (serving) follows the cells: the mLSTM's ``c``, ``n``
and ``m`` are the rank's heads' where the heads split and whole where
every rank runs every head (each rank then computes the same state), and
the sLSTM's ``c``, ``n``, ``m`` and ``h`` are the rank's heads'; the cache's
specs split the ``heads`` dimension as the parameters' do.  A prefill with
state rolls the prompt through the recurrence to build it, as on one
device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.scan import scan
from repro_torch.models.layers.tensor_parallel import (
    column_matmul,
    paired_columns,
    row_matmul,
    split_axis,
)
from repro_torch.nn.module import Param
from repro_torch.sharding.collectives import copy_to_model, gather_from_model, sum_across
from repro_torch.sharding.context import model_parallel

NEG_INF = -1e9

State = Dict[str, torch.Tensor]


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The reference's group-norm stand-in: rms over the last dim in fp32 with
    eps 1e-6, cast back, times the learned scale in x's dtype."""
    x32 = x.to(torch.float32)
    y = (x32 / torch.sqrt(x32.square().mean(-1, keepdim=True) + 1e-6)).to(x.dtype)
    return y * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    up = int(cfg.xlstm_proj_factor * d)
    dh_up = up // h
    norm = dict(no_weight_decay=True, no_trust_ratio=True)
    return {
        "up_proj": Param((d, 2 * up), ("embed", "inner")),
        "wq": Param((up, h, dh_up), ("inner", "heads", "head_dim")),
        "wk": Param((up, h, dh_up), ("inner", "heads", "head_dim")),
        "wv": Param((up, h, dh_up), ("inner", "heads", "head_dim")),
        "w_igate": Param((up, h), ("inner", "heads"), init="zeros"),
        "b_igate": Param((h,), ("heads",), init="zeros", **norm),
        "w_fgate": Param((up, h), ("inner", "heads"), init="zeros"),
        "b_fgate": Param((h,), ("heads",), init="ones", scale=3.0, **norm),
        "out_norm": Param((up,), ("inner",), init="ones", **norm),
        "down_proj": Param((up, d), ("inner", "embed")),
    }


def mlstm_parallel(q, k, v, i_pre, f_pre) -> torch.Tensor:
    """Parallel mLSTM (paper eq. 25-27): q, k, v (B, H, S, Dh), gate
    pre-activations i_pre, f_pre (B, H, S) → h (B, H, S, Dh) in q's dtype."""
    s, dh = q.shape[2], q.shape[-1]
    log_f = F.logsigmoid(f_pre.to(torch.float32))
    cum = torch.cumsum(log_f, dim=-1)                       # sum_{j<=t} log f_j
    # D[t, s] = F[t] - F[s] + i_pre[s] for s <= t
    dmat = cum[..., :, None] - cum[..., None, :] + i_pre.to(torch.float32)[..., None, :]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal, dmat, NEG_INF)
    m = dmat.amax(-1, keepdim=True)                         # (B, H, S, 1)
    w = torch.exp(dmat - m)
    scores = (q @ k.transpose(-1, -2)).to(torch.float32) / math.sqrt(dh)
    c = scores * w
    norm = torch.maximum(c.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return (c / norm).to(q.dtype) @ v


def mlstm_recurrent_step(state: State, q, k, v, i_pre, f_pre) -> Tuple[State, torch.Tensor]:
    """One decode step: q, k, v (B, H, Dh), gates (B, H); state c (B, H, Dh,
    Dh), n (B, H, Dh), m (B, H) in fp32 → (new state, h (B, H, Dh))."""
    c, n, m = state["c"], state["n"], state["m"]
    log_f = F.logsigmoid(f_pre.to(torch.float32))
    i32 = i_pre.to(torch.float32)
    m_new = torch.maximum(log_f + m, i32)
    f_eff = torch.exp(log_f + m - m_new)[..., None]
    i_eff = torch.exp(i32 - m_new)[..., None]
    k32, v32, q32 = (x.to(torch.float32) for x in (k, v, q))
    k32 = k32 / math.sqrt(q.shape[-1])
    c_new = f_eff[..., None] * c + i_eff[..., None] * v32[..., :, None] * k32[..., None, :]
    n_new = f_eff * n + i_eff * k32
    num = (c_new @ q32[..., None])[..., 0]                   # einsum bhde,bhe->bhd
    den = torch.maximum((n_new * q32).sum(-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return {"c": c_new, "n": n_new, "m": m_new}, h


def mlstm_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d) → (out (B, S, d), new state or None).  Decode (one token
    with a state) steps the recurrence; otherwise the parallel form, and with
    a state (a prefill) the prompt rolled through the recurrence from it."""
    dtype = x.dtype
    hh = cfg.n_heads
    whole = int(cfg.xlstm_proj_factor * cfg.d_model)
    dh = whole // hh
    # this rank's up-projection columns and heads: all of them, or up/M
    # and H/M (where M divides them) over a model axis
    axis = model_parallel()
    tp = split_axis(p["out_norm"].shape[0], whole, axis)
    h_tp = split_axis(p["b_igate"].shape[0], hh, axis)
    w_up = paired_columns(p["up_proj"], whole, axis)
    xi, z = column_matmul(x, w_up.to(dtype), tp).chunk(2, dim=-1)
    b, s, up = xi.shape

    def summed(w):
        """``xi @ w`` for w (up, …), whole on every rank (einsum bsu,u…)."""
        y = row_matmul(xi, w.to(dtype).reshape(up, -1), tp)
        return y if tp is None else copy_to_model(y, tp.group)

    def heads(w):  # einsum bsu,uhd->bhsd
        return summed(w).view(b, s, hh, dh).transpose(1, 2)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    i_pre, f_pre = summed(p["w_igate"]).transpose(1, 2), summed(p["w_fgate"]).transpose(1, 2)
    b_i, b_f = p["b_igate"].to(dtype), p["b_fgate"].to(dtype)
    if h_tp is not None:   # the cell on this rank's heads
        cut = slice(h_tp.index * b_i.shape[0], (h_tp.index + 1) * b_i.shape[0])
        q, k, v, i_pre, f_pre = q[:, cut], k[:, cut], v[:, cut], i_pre[:, cut], f_pre[:, cut]
    elif tp is not None:   # every head on every rank: the biases' gradients are partial
        b_i, b_f = copy_to_model(b_i, tp.group), copy_to_model(b_f, tp.group)
    i_pre = i_pre + b_i[None, :, None]
    f_pre = f_pre + b_f[None, :, None]

    new_state = None
    if decode and state is not None:
        new_state, h = mlstm_recurrent_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                            i_pre[:, :, 0], f_pre[:, :, 0])
        h = h[:, :, None]                                       # (B, H, 1, Dh)
    else:
        h = mlstm_parallel(q, k, v, i_pre, f_pre)
        if state is not None:   # the prompt rolled through the recurrence, h dropped
            new_state, _ = scan(lambda st, *x: (mlstm_recurrent_step(st, *x)[0], None),
                                state, (q, k, v, i_pre, f_pre), dim=2)

    h = h.transpose(1, 2).reshape(b, s, -1)
    if tp is None:
        h = _rms(h, p["out_norm"])
    else:   # this rank's inner columns, normed over the whole up-projection
        if h_tp is None:
            h = h[..., tp.index * up:(tp.index + 1) * up]
        h32 = h.to(torch.float32)
        ss = sum_across(h32.square().sum(-1, keepdim=True), tp.group)
        h = (h32 / torch.sqrt(ss / whole + 1e-6)).to(dtype) * p["out_norm"].to(dtype)
    h = h * F.silu(z)
    return row_matmul(h, p["down_proj"].to(dtype), tp), new_state


def init_mlstm_state(batch: int, cfg: ModelConfig, device=None) -> State:
    h = cfg.n_heads
    dh = int(cfg.xlstm_proj_factor * cfg.d_model) // h
    return {
        "c": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), NEG_INF, dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


def slstm_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    norm = dict(no_weight_decay=True, no_trust_ratio=True)
    defs: dict = {}
    for g in GATES:
        defs[f"w_{g}"] = Param((d, h, dh), ("embed", "heads", "head_dim"))
        defs[f"r_{g}"] = Param((h, dh, dh), ("heads", "head_dim", "qk_dim"), init="fan_in",
                               scale=0.5)
        defs[f"b_{g}"] = Param((h, dh), ("heads", "head_dim"),
                               init="ones" if g == "f" else "zeros", **norm)
    defs["out_norm"] = Param((d,), ("embed",), init="ones", **norm)
    ff = int(cfg.xlstm_proj_factor * d)
    defs["ff"] = {"wi": Param((d, ff), ("embed", "ff")), "wo": Param((ff, d), ("ff", "embed"))}
    return defs


def slstm_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, State]:
    """sLSTM with exponential gating and the stabiliser (paper eq. 13-24):
    x (B, S, d) → (out (B, S, d), the state after the last step).  The time
    recurrence runs in fp32 from ``state`` (zeros, m at -1e9, when None);
    a decode step is the same loop over its one token."""
    del decode
    dtype = x.dtype
    b, s, d = x.shape
    dh = d // cfg.n_heads
    # this rank's heads: all of them, or H/M over a model axis
    hh = p["b_i"].shape[0]
    axis = model_parallel()
    tp = split_axis(hh, cfg.n_heads, axis)
    # the gates' input pre-activations (4, B, S, H, Dh), one product each,
    # in fp32 once for all steps
    pre = torch.stack([column_matmul(x, p[f"w_{g}"].to(dtype).reshape(d, hh * dh), tp
                                     ).view(b, s, hh, dh)
                       for g in GATES]).to(torch.float32)
    # the four gates' recurrent products as one batched product a step:
    # gate g's h_prev @ r_g per head, the same sums as the reference's four
    # einsums (bhk,hkj->bhj), in one launch instead of four.  Batched over
    # (gate, head), so only h_prev (not r) is broadcast
    r = torch.stack([p[f"r_{g}"].to(torch.float32) for g in GATES])        # (4, H, Dh, Dh)
    bias = torch.stack([p[f"b_{g}"].to(torch.float32) for g in GATES])[:, None]  # (4,1,H,Dh)
    st = state if state is not None else init_slstm_state(b, cfg, x.device, hh)
    one = torch.ones((), device=x.device)   # max(n, 1): torch.maximum splits ties as JAX's

    def step(st, pre_t):
        rec = (st["h"].transpose(0, 1) @ r).transpose(1, 2)                # (4, B, H, Dh)
        i_t, f_t, z_t, o_t = (pre_t + rec + bias).unbind(0)
        log_fm = F.logsigmoid(f_t) + st["m"]
        m_new = torch.maximum(log_fm, i_t)
        i_eff = torch.exp(i_t - m_new)
        f_eff = torch.exp(log_fm - m_new)
        c = f_eff * st["c"] + i_eff * torch.tanh(z_t)
        n = f_eff * st["n"] + i_eff
        h = torch.sigmoid(o_t) * c / torch.maximum(n, one)
        return {"c": c, "n": n, "m": m_new, "h": h}, h

    new_state, hs = scan(step, {k: st[k] for k in ("c", "n", "m", "h")}, (pre,), dim=2,
                         out_dim=1)
    y = hs.reshape(b, s, hh * dh).to(dtype)
    if tp is not None:   # every rank's heads, concatenated
        y = gather_from_model(y, -1, tp.group)
    y = _rms(y, p["out_norm"])
    # small gated FF (block-internal), tensor-parallel over ff
    ff_tp = split_axis(p["ff/wi"].shape[1], int(cfg.xlstm_proj_factor * d), axis)
    ff = F.gelu(column_matmul(y, p["ff/wi"].to(dtype), ff_tp), approximate="tanh")
    return row_matmul(ff, p["ff/wo"].to(dtype), ff_tp), new_state


def init_slstm_state(batch: int, cfg: ModelConfig, device=None,
                     heads: Optional[int] = None) -> State:
    """The zero state (m at -1e9) of ``heads`` heads (all by default)."""
    h, dh = heads or cfg.n_heads, cfg.d_model // cfg.n_heads

    def z():
        return torch.zeros((batch, h, dh), dtype=torch.float32, device=device)

    return {"c": z(), "n": z(),
            "m": torch.full((batch, h, dh), NEG_INF, dtype=torch.float32, device=device),
            "h": z()}
