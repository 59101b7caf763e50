"""Fused LAMB over a whole parameter dict and flash attention on the model's
layout (ports of the fused-LAMB and ``flash_sdpa`` parts of
``repro.kernels.ops``).

The state and the order of a step are the JAX package's:
clip by global norm → ``count += ok`` → ``lr_t = schedule(sched_count)``
(the old ``sched_count``) → apply → ``sched_count += ok``.  Everything stays
on the device and updates in place: params, moments and both counters.
``ok`` is the train step's non-finite guard (1 when there is none): the
reference where-selects old against new after its apply, while here the
flag reaches K1/K2 as a device int, so a skipped step stores nothing.
:func:`fused_lamb` is the same update as a ``GradientTransformation``
returning deltas, for a transform chain.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lamb_update import (
    bias_corrections,
    lamb_update_leaves,
    resolve_fused_backend,
)
from repro_torch.optim.base import GradientTransformation, clip_tree_by_global_norm
from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.context import current

Tensors = Dict[str, torch.Tensor]

__all__ = [
    "FusedLambState",
    "flash_sdpa",
    "fused_lamb",
    "fused_lamb_apply",
    "fused_lamb_init",
    "make_fused_lamb_step",
    "resolve_fused_backend",
]


@dataclasses.dataclass
class FusedLambState:
    """Fused-LAMB optimizer state.

    ``count`` ages the moments (bias correction); ``sched_count`` drives the
    learning-rate schedule (what a stage-2 re-warm-up resets).  Both are
    int32 device scalars.
    """

    count: torch.Tensor
    sched_count: torch.Tensor
    mu: Tensors
    nu: Tensors


def fused_lamb_init(params: Tensors) -> FusedLambState:
    """Zero fp32 moments and zero counters on the params' device."""
    device = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros(v.shape, dtype=torch.float32, device=device)  # noqa: E731
                     for k, v in params.items()}
    return FusedLambState(
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        zeros(), zeros(),
    )


def fused_lamb_apply(
    params: Tensors,
    grads: Tensors,
    mu: Tensors,
    nu: Tensors,
    count: torch.Tensor,
    lr_t: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, int]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    ok: Optional[torch.Tensor] = None,
    with_aux: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tensors]]:
    """One fused LAMB step over every leaf, in place on params, mu and nu.

    ``count`` is the 1-based step for bias correction and ``lr_t`` the
    learning rate, both device scalars.  ``ok`` (a bool or int device
    scalar, or None) is the non-finite guard: where it is false, no leaf is
    written.  Returns Σ(x'−x)² over all leaves (fp32 device scalar): the
    squared update norm, taken inside the kernels (0 on a skipped step).
    With ``with_aux``, also ``{path: ratio}``: each leaf's applied trust
    ratio before the lr fold ((layers,) for a stacked leaf, else a scalar).

    Pass A (K1) runs on every leaf, then pass B (K2).  Under an ambient
    sharding context the leaves it splits are this rank's blocks: K1's
    per-layer (Σx², Σu²) partials of all of them are packed into one buffer
    and all-reduced over the world in **one** collective before the trust
    ratios, each counted once (zero on the ranks
    :meth:`~repro_torch.sharding.ShardCtx.counts` leaves out), so K2
    applies the whole leaf's ratio to the block; their Σ(x'−x)² are
    all-reduced the same way.  The kernels stay on the path: this is the
    reference's function, where GSPMD keeps the plain pass's sums global.
    """
    device = count.device
    ctx = current()
    split = [k for k in params if ctx is not None and ctx.split(k)]
    ratios, dsq = lamb_update_leaves(
        params, grads, mu, nu, bias_corrections(count, b1, b2, device),
        torch.as_tensor(lr_t, dtype=torch.float32, device=device), b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, wd_mask=wd_mask, trust_mask=trust_mask,
        layer_axes=layer_axes, phi_bounds=phi_bounds,
        ok=None if ok is None else ok.to(torch.int32), split=split,
        uncounted=frozenset(k for k in split if not ctx.counts(k)),
        reduce_sum=lambda t: all_reduce(t, "sum", ctx.world_group))
    total = torch.zeros((), dtype=torch.float32, device=device)
    for k in params:
        total = total + dsq[k]
    return (total, ratios) if with_aux else total


def make_fused_lamb_step(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    *,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, int]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    grad_clip_norm: Optional[float] = None,
    with_aux: bool = False,
):
    """``step(params, grads, state, ok=None) -> Σ(x'−x)²``, updating all three
    in place (with ``with_aux``: ``(Σ(x'−x)², ratios)``, see
    :func:`fused_lamb_apply`).

    ``grads`` are clipped in place too (a non-finite gradient clips to NaN,
    harmlessly: a step with such gradients is skipped).  ``ok`` (bool or
    int32 device scalar) is the train step's non-finite guard: when false
    no leaf is written and *neither counter advances*.  The order of the JAX package's
    ``make_fused_lamb_step`` is kept exactly.
    """

    def step(params: Tensors, grads: Tensors, state: FusedLambState,
             ok: Optional[torch.Tensor] = None):
        if grad_clip_norm is not None:
            clip_tree_by_global_norm(grads, grad_clip_norm)
        adv = 1 if ok is None else ok.to(state.count.dtype)
        state.count.add_(adv)
        if callable(learning_rate):
            lr_t = learning_rate(state.sched_count)
        else:
            lr_t = torch.tensor(learning_rate, dtype=torch.float32,
                                device=state.count.device)
        out = fused_lamb_apply(
            params, grads, state.mu, state.nu, state.count, lr_t,
            b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            wd_mask=wd_mask, trust_mask=trust_mask, layer_axes=layer_axes,
            phi_bounds=phi_bounds, ok=None if ok is None else adv,
            with_aux=with_aux,
        )
        state.sched_count.add_(adv)
        return out

    return step


def fused_lamb(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    *,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, int]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    grad_clip_norm: Optional[float] = None,
) -> GradientTransformation:
    """Fused LAMB (K1/K2 on the card, their plain version on the CPU) as a
    transform whose ``update`` returns parameter deltas, so it composes
    with ``optim.apply_updates`` like ``core.lamb`` (port of the reference's
    ``fused_lamb``).

    Functional like every transform: the kernels run on copies of the
    params, the state and (when clipping, which is in place) the grads, so
    nothing the caller passed is written.  At full width that is 1.33 GB
    of params, 2.67 GB of moments and 1.33 GB of grads copied a step, on
    top of the 1.33 GB of deltas; the train step's fused-direct path
    (:func:`make_fused_lamb_step` in place) copies nothing.
    """
    step = make_fused_lamb_step(
        learning_rate, b1, b2, eps, weight_decay, wd_mask=wd_mask, trust_mask=trust_mask,
        layer_axes=layer_axes, phi_bounds=phi_bounds, grad_clip_norm=grad_clip_norm,
    )

    def update(grads: Tensors, state: FusedLambState, params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("fused_lamb requires params")
        copy = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
        new_params = copy(params)
        new_state = FusedLambState(state.count.clone(), state.sched_count.clone(),
                                   copy(state.mu), copy(state.nu))
        step(new_params, copy(grads) if grad_clip_norm is not None else grads, new_state)
        updates = {k: (new.to(torch.float32) - params[k].to(torch.float32)).to(new.dtype)
                   for k, new in new_params.items()}
        return updates, new_state

    return GradientTransformation(fused_lamb_init, update)


def flash_sdpa(
    q: torch.Tensor,  # (B, S, H, D)  model layout
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_valid: Optional[torch.Tensor] = None,  # (B,) valid kv lengths
    window: int = 0,  # sliding-window size; 0 = full attention
) -> torch.Tensor:
    """Flash attention on the model's (B, S, H, D) layout, differentiable.

    The kernels read (B, H, S, D) views of these tensors through their
    strides and write o, dq, dk and dv in the callers' layouts, so nothing
    is transposed by a copy; GQA is folded into the kernels' head index.
    Ragged lengths need no padding: the kernels mask their own tails.
    """
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        kv_valid, causal=causal, window=window)
    return o.transpose(1, 2)
