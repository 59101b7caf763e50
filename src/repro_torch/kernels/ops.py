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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lamb_update import lamb_update, resolve_fused_backend
from repro_torch.optim.base import clip_tree_by_global_norm

Tensors = Dict[str, torch.Tensor]

__all__ = [
    "FusedLambState",
    "flash_sdpa",
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
    """
    total = torch.zeros((), dtype=torch.float32, device=count.device)
    flag = None if ok is None else ok.to(torch.int32)
    ratios: Tensors = {}
    for k, x in params.items():
        axis = 0 if (layer_axes or {}).get(k, -1) == 0 else None
        out = lamb_update(
            x, grads[k], mu[k], nu[k], count, lr_t, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay if (wd_mask or {}).get(k, True) else 0.0,
            phi_lo=None if phi_bounds is None else phi_bounds[0],
            phi_hi=None if phi_bounds is None else phi_bounds[1],
            layer_axis=axis,
            apply_trust=bool((trust_mask or {}).get(k, True)),
            ok=flag,
        )
        total = total + out.delta_sq
        if with_aux:
            ratios[k] = out.ratio
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
