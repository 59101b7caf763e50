"""Mixture-of-Experts layer: top-k routing with static capacity (port of
``repro.models.layers.moe``).

Routing is the reference's: a softmax router in fp32, top-k, gates
renormalised over the selected experts, the Switch-style load-balance
auxiliary loss and, with ``cfg.router_z_coef``, the router z-loss; an
optional shared expert every token passes through.

Dispatch is the reference's scatter/gather: each (token, slot) assignment,
in token-major then slot order, is ranked within its expert by the
exclusive cumsum of the one-hot assignments, and kept if its rank is below
the capacity C, so the same pairs are dropped past capacity.  JAX's
``buf.at[dest].set(mode="drop")`` and ``.get(mode="fill")`` become an index
write into an ``(E·C + 1, d)`` buffer whose last row is a sink for the
dropped assignments, sliced off before the experts run, and a gather from
the experts' output with a zero row appended in the sink's place.  Nothing
here reads a device value on the host.  The expert products are batched
``torch.bmm`` over the ``(E, C, d)`` buffer (no kernel of the repo covers
MoE; the JAX package leaves them to XLA's einsums).  The layer is three
steps, :func:`dispatch`, :func:`experts` and :func:`combine`, each a
function of its own so that each can be timed on its own.

Over data-parallel ranks (the ambient context's :func:`data_parallel`),
each rank routes its own rows of the micro-batch, and the rows of rank r
are the r-th block of the reference's micro-batch, so rank order is the
global token order.  Every count the reference takes over the micro-batch
stays global: the capacity takes the global token count, an assignment's
position within its expert is its rank-local rank plus the exclusive
prefix over the ranks before it of their per-expert counts (one
all-gather of each rank's (E,) counts), and the load-balance loss, the
largest mean router probability, the drop fraction and the z-loss are
means over the global tokens (:func:`sum_across`, whose backward sums
every rank's share, so each rank's router gets the global term's
derivative at the micro-batch's whole weight).  A rank's buffer holds its
own kept assignments at the rows the whole layer gives them.

Over a ``model`` axis whose specs split the experts (expert parallelism,
the expert group being the ``model`` group), each rank holds E/M experts:
its columns of the router and its ``wi``/``wg``/``wo``.  Tokens are not
split over ``model`` (every model rank of a data coordinate holds the same
rows), so no all-to-all moves them.  Each rank forms its columns of the
fp32 router logits (a column-parallel product), gathers them into the whole
(T, E) (:func:`gather_from_model`: the backward keeps the rank's columns of
the gradient, which the replicated routing gives every rank whole), routes
as on one device (the capacity, positions and global means as above),
keeps only the assignments to its own experts in an (E/M·C + 1, d) buffer
at the rows the whole layer gives them, runs its experts and combines its
own slots in fp32; the partial outputs are summed over ``model`` in fp32
and rounded once.  The gates and the tokens feed only the rank's own
experts, so their gradients are partial and are summed over ``model``
(:func:`copy_to_model`) before they re-enter the routing.  The shared
expert is the tensor-parallel MLP.  Where E is no multiple of M the specs
keep the experts whole and every rank runs the whole layer, as the
reference's layout does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.mlp import _ACTS, mlp, mlp_defs
from repro_torch.models.layers.tensor_parallel import column_matmul, split_axis
from repro_torch.nn.module import Param
from repro_torch.sharding.collectives import (
    copy_to_model,
    gather_from_model,
    gather_leaf,
    reduce_from_model,
    sum_across,
)
from repro_torch.sharding.context import ModelAxis, data_parallel, model_parallel


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": Param((d, e), ("embed", "experts"), init="fan_in"),
        "wi": Param((e, d, f), ("experts", "embed", "expert_ff")),
        "wg": Param((e, d, f), ("experts", "embed", "expert_ff")),
        "wo": Param((e, f, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(d, cfg.n_shared_experts * f, True, cfg.act_fn)
    return defs


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Static per-expert capacity: int(cf · T · k / E), at least k."""
    c = int(cfg.capacity_factor * n_tokens * cfg.n_experts_per_tok / cfg.n_experts)
    return max(c, cfg.n_experts_per_tok)


def global_tokens(t: int, dp: Optional[ModelAxis]) -> int:
    """Tokens of the whole micro-batch, from this rank's ``t`` (every
    data-parallel rank holds as many)."""
    return t if dp is None else t * dp.size


def global_sum(x: torch.Tensor, dp: Optional[ModelAxis]) -> torch.Tensor:
    """``x`` summed over the data-parallel ranks, differentiable on each
    (``x`` itself without them)."""
    return x if dp is None else sum_across(x, dp.group)


def rank_offsets(counts: torch.Tensor, dp: Optional[ModelAxis]) -> torch.Tensor:
    """The exclusive prefix over the data-parallel ranks of their (E,)
    per-expert counts: how many assignments to each expert the ranks
    before this one hold (zeros without ranks)."""
    if dp is None:
        return torch.zeros_like(counts)
    every = gather_leaf(counts[None], 0, dp.group)           # (ranks, E)
    return every[:dp.index].sum(0, dtype=counts.dtype)


def route(logits: torch.Tensor, cfg: ModelConfig, dp: Optional[ModelAxis] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k gates (T, k), expert ids (T, k) and the aux losses, from fp32
    router logits (T, E); over data-parallel ranks ``dp`` the means are the
    whole micro-batch's."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.n_experts_per_tok, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)

    # Switch-Transformer load-balance loss: E · <f_e · p_e>
    e = cfg.n_experts
    top1 = F.one_hot(idx[:, 0], e).to(torch.float32)
    if dp is None:
        me = probs.mean(0)                                    # (E,) mean router prob
        fe = top1.mean(0)                                     # top-1 fraction
    else:
        n = global_tokens(logits.shape[0], dp)
        me = global_sum(probs.sum(0), dp) / n
        fe = global_sum(top1.sum(0), dp) / n
    aux = {"moe_lb_loss": e * (fe * me).sum(), "moe_max_prob": me.max()}
    if cfg.router_z_coef:
        z = torch.logsumexp(logits, dim=-1) ** 2
        aux["moe_z_loss"] = (z.mean() if dp is None else
                             global_sum(z.sum(), dp) / global_tokens(z.shape[0], dp))
    return gates, idx, aux


def expert_hits(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E, T·k) int32: whether each (token, slot) assignment, in flat
    token-major order, routes to each expert."""
    flat_e = idx.reshape(-1)
    return (torch.arange(n_experts, device=idx.device)[:, None]
            == flat_e[None, :]).to(torch.int32)


def place(xf: torch.Tensor, idx: torch.Tensor, hits: torch.Tensor, c: int,
          offsets: Optional[torch.Tensor] = None, tp: Optional[ModelAxis] = None):
    """Scatter each (token, slot) kept under capacity ``c`` into its
    expert's rows: ``(buf (E, C, d), dest (T·k,), keep (T·k,))``.  An
    assignment's position within its expert is the exclusive running count
    of its expert's ``hits`` plus ``offsets`` (E,), the assignments the
    blocks of rows before this one route there (none without).  Over the
    ``model`` ranks ``tp`` the buffer holds this rank's E/M experts only,
    ``dest`` indexes it (E/M·C, the sink, for an assignment to another
    rank's expert) and ``keep`` stays the whole layer's."""
    t, d = xf.shape
    e, k = hits.shape[0], idx.shape[1]
    # scanned along the last dim of the (E, T·k) hits (a scan down the T·k
    # rows of a (T·k, E) one-hot runs one thread per expert on the card,
    # milliseconds a layer)
    flat_e = idx.reshape(-1)
    scan = torch.cumsum(hits, 1, dtype=torch.int32)
    if offsets is not None:
        scan = scan + offsets[:, None]
    pos = (scan - hits).gather(0, flat_e[None, :])[0]
    keep = pos < c
    mine = keep
    if tp is not None:   # this rank's experts [e0, e0 + E/M), indexed from e0
        e //= tp.size
        flat_e = flat_e - tp.index * e
        mine = keep & (flat_e >= 0) & (flat_e < e)
    dest = torch.where(mine, flat_e * c + pos, e * c)              # the sink row: dropped

    token_id = torch.arange(t, device=xf.device).repeat_interleave(k)
    buf = xf.new_zeros((e * c + 1, d)).index_put((dest,), xf[token_id])
    return buf[: e * c].view(e, c, d), dest, keep


def dispatch(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg: ModelConfig,
             dp: Optional[ModelAxis] = None, tp: Optional[ModelAxis] = None):
    """Route the tokens xf (T, d) and scatter each kept (token, slot) into
    its expert's rows: ``(buf (E, C, d), dest (T·k,), gates (T, k), keep
    (T·k,), aux)``; ``dest`` is E·C (the sink) for a dropped assignment.
    Over data-parallel ranks ``dp``, C and each assignment's position are
    the whole micro-batch's, and the buffer holds this rank's rows at the
    whole layer's rows.  Over the ``model`` ranks ``tp`` the router is this
    rank's columns, the logits are gathered whole, and the buffer holds
    this rank's experts (:func:`place`)."""
    c = capacity(global_tokens(xf.shape[0], dp), cfg)
    logits = column_matmul(xf.to(torch.float32), p["router"].to(torch.float32), tp)
    if tp is not None:
        logits = gather_from_model(logits, -1, tp.group)
    gates, idx, aux = route(logits, cfg, dp)
    hits = expert_hits(idx, cfg.n_experts)
    offsets = None if dp is None else rank_offsets(hits.sum(1, dtype=torch.int32), dp)
    if tp is not None:   # the rank's experts' share of the gradients, summed over model
        xf, gates = copy_to_model(xf, tp.group), copy_to_model(gates, tp.group)
    buf, dest, keep = place(xf, idx, hits, c, offsets, tp)
    return buf, dest, gates, keep, aux


def drop_fraction(keep: torch.Tensor, dp: Optional[ModelAxis] = None) -> torch.Tensor:
    """The share of the micro-batch's assignments dropped past capacity."""
    if dp is None:
        return 1.0 - keep.to(torch.float32).mean()
    kept = global_sum(keep.to(torch.float32).sum(), dp)
    return 1.0 - kept / (keep.numel() * dp.size)


def experts(p: Dict[str, torch.Tensor], buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated expert MLPs over their (E, C, d) rows: ``(E·C, d)``."""
    e, c, d = buf.shape
    act = _ACTS[cfg.act_fn]
    hi = torch.bmm(buf, p["wi"].to(buf.dtype))
    hg = torch.bmm(buf, p["wg"].to(buf.dtype))
    return torch.bmm(act(hg) * hi, p["wo"].to(buf.dtype)).reshape(e * c, d)


def combine(y: torch.Tensor, dest: torch.Tensor, gates: torch.Tensor, k: int,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Each slot's expert output gathered back (the sink reads a zero row),
    weighted by its gate and summed over the k slots: ``(T, d)``, the sum
    in ``dtype`` (y's by default; fp32 for one rank's partial)."""
    d = y.shape[1]
    yk = torch.cat([y, y.new_zeros((1, d))])[dest]
    return (yk * gates.reshape(-1, 1).to(y.dtype)).reshape(-1, k, d).sum(1, dtype=dtype)


def moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) → (B, S, d) and the aux dict (``moe_lb_loss``,
    ``moe_max_prob``, ``moe_drop_fraction``, ``moe_z_loss`` when set)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    dp = data_parallel()
    tp = split_axis(p["wi"].shape[0], cfg.n_experts, model_parallel())
    buf, dest, gates, keep, aux = dispatch(p, xf, cfg, dp, tp)
    y = experts(p, buf, cfg)
    if tp is None:
        out = combine(y, dest, gates, cfg.n_experts_per_tok)
    else:   # the ranks' fp32 partials summed, rounded once
        out = reduce_from_model(combine(y, dest, gates, cfg.n_experts_per_tok,
                                        torch.float32), tp.group).to(y.dtype)
    aux["moe_drop_fraction"] = drop_fraction(keep, dp)

    if "shared/wi" in p:
        shared = {n[len("shared/"):]: v for n, v in p.items() if n.startswith("shared/")}
        out = out + mlp(shared, xf[:, None, :], cfg,
                        cfg.n_shared_experts * cfg.moe_d_ff).reshape(b * s, d)

    return out.reshape(b, s, d).to(x.dtype), aux
