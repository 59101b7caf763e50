"""Fused LAMB over a whole parameter dict (port of the fused-LAMB part of
``repro.kernels.ops``).

The state and the order of a step are the JAX package's:
clip by global norm → ``count += 1`` → ``lr_t = schedule(sched_count)``
(the old ``sched_count``) → apply → ``sched_count += 1``.  Everything stays
on the device and updates in place: params, moments and both counters.
The non-finite guard (``ok``) and the per-layer ratio aux (``with_aux``) are
not ported yet (ROADMAP.md queue 1, items 5–6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.lamb_update import lamb_update, resolve_fused_backend
from repro_torch.optim.base import clip_tree_by_global_norm

Tensors = Dict[str, torch.Tensor]

__all__ = [
    "FusedLambState",
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
) -> torch.Tensor:
    """One fused LAMB step over every leaf, in place on params, mu and nu.

    ``count`` is the 1-based step for bias correction and ``lr_t`` the
    learning rate, both device scalars.  Returns Σ(x'−x)² over all leaves
    (fp32 device scalar): the squared update norm, taken inside the kernels.
    """
    total = torch.zeros((), dtype=torch.float32, device=count.device)
    for k, x in params.items():
        axis = 0 if (layer_axes or {}).get(k, -1) == 0 else None
        out = lamb_update(
            x, grads[k], mu[k], nu[k], count, lr_t, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay if (wd_mask or {}).get(k, True) else 0.0,
            phi_lo=None if phi_bounds is None else phi_bounds[0],
            phi_hi=None if phi_bounds is None else phi_bounds[1],
            layer_axis=axis,
            apply_trust=bool((trust_mask or {}).get(k, True)),
        )
        total = total + out.delta_sq
    return total


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
):
    """``step(params, grads, state) -> Σ(x'−x)²``, updating all three in place.

    ``grads`` are clipped in place too.  The order of the JAX package's
    ``make_fused_lamb_step`` is kept exactly.
    """

    def step(params: Tensors, grads: Tensors, state: FusedLambState) -> torch.Tensor:
        if grad_clip_norm is not None:
            clip_tree_by_global_norm(grads, grad_clip_norm)
        state.count.add_(1)
        if callable(learning_rate):
            lr_t = learning_rate(state.sched_count)
        else:
            lr_t = torch.tensor(learning_rate, dtype=torch.float32,
                                device=state.count.device)
        delta_sq = fused_lamb_apply(
            params, grads, state.mu, state.nu, state.count, lr_t,
            b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            wd_mask=wd_mask, trust_mask=trust_mask, layer_axes=layer_axes,
            phi_bounds=phi_bounds,
        )
        state.sched_count.add_(1)
        return delta_sq

    return step
