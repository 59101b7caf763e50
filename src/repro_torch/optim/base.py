"""Gradient transformations on flat parameter dicts (port of
``repro.optim.base``).

    GradientTransformation(init, update)
    update(updates, state, params) -> (updates, state)

Trees are the port's flat ``{path: Tensor}`` dicts; masks and layer axes
are dicts over the same paths.  Every transform is functional: it never
writes a tensor it was given, so a caller can keep the old state (the
non-finite guard selects old against new).  State classes are dataclasses,
and a ``chain``'s state is a plain tuple of them, so the checkpoint walker
names their leaves as the reference names its NamedTuples'
(``opt_state/1/count``, ``opt_state/1/mu/<path>``); a leafless
``EmptyState`` yields no leaves, as in JAX.

Mixed precision as in the reference: stateful arithmetic and every norm in
fp32, moments stored in ``moment_dtype``, ``apply_updates`` adds in fp32
and casts back.  Nothing here waits on the host: the step count's powers
(``b1 ** t``) are fp32 device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.context import current

Tensors = Dict[str, torch.Tensor]
PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], PyTree]
    update: Callable[[Tensors, PyTree, Optional[Tensors]], Tuple[Tensors, PyTree]]


@dataclasses.dataclass
class EmptyState:
    pass


@dataclasses.dataclass
class TraceState:
    momentum: Tensors


@dataclasses.dataclass
class ScaleByAdamState:
    count: torch.Tensor
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass
class ScaleByAdagradState:
    accum: Tensors


@dataclasses.dataclass
class ScheduleState:
    count: torch.Tensor


def _zero_count(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


def _zeros(params: Tensors, dtype=torch.float32) -> Tensors:
    return {k: torch.zeros(v.shape, dtype=dtype, device=v.device) for k, v in params.items()}


def identity() -> GradientTransformation:
    """The no-op transform: updates pass through unchanged (chain unit)."""
    return GradientTransformation(lambda params: EmptyState(), lambda u, s, p=None: (u, s))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transforms left to right; the state is the tuple of member
    states, and every member sees the pre-step ``params``."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    """Stateless transform multiplying every update leaf by ``factor``."""
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda u, s, p=None: ({k: factor * x for k, x in u.items()}, s),
    )


def _lr_value(lr: ScalarOrSchedule, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count)
    return torch.tensor(lr, dtype=torch.float32, device=count.device)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule, *, flip_sign: bool = True
                           ) -> GradientTransformation:
    """Multiply updates by −lr (``flip_sign=False``: +lr); lr may be a
    schedule of ``ScheduleState.count``, which starts at 0 (the first step
    sees ``lr(0)``) and is what a stage-2 re-warm-up resets."""

    def init(params):
        return ScheduleState(count=_zero_count(params))

    def update(updates, state, params=None):
        lr = _lr_value(learning_rate, state.count)
        m = -lr if flip_sign else lr
        updates = {k: (m * x).to(x.dtype) for k, x in updates.items()}
        return updates, ScheduleState(count=state.count + 1)

    return GradientTransformation(init, update)


def trace(decay: float, *, average: bool = True) -> GradientTransformation:
    """Heavy-ball momentum m = decay·m + (1 − decay)·g (``average=False``:
    m = decay·m + g); the updates are the new fp32 momentum."""
    mix = (1.0 - decay) if average else 1.0

    def init(params):
        return TraceState(momentum=_zeros(params))

    def update(updates, state, params=None):
        new_m = {k: decay * state.momentum[k] + mix * g.to(torch.float32)
                 for k, g in updates.items()}
        return new_m, TraceState(momentum=new_m)

    return GradientTransformation(init, update)


def scale_by_adam(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    *,
    bias_correction: bool = True,
    nesterov_m: bool = False,
    nesterov_v: bool = False,
    moment_dtype=None,
) -> GradientTransformation:
    """Adam's rescaling r_t = m̂/(√v̂ + eps), fp32 updates.

    ``bias_correction=False`` is App. E (no adam-correction);
    ``nesterov_m`` the N-LAMB first-moment rule (Alg. 3), ``nesterov_v``
    also NN-LAMB's second-moment rule (Alg. 4).  ``moment_dtype`` narrows
    the stored m and v; the EMA runs in fp32.
    """
    mdt = _DTYPES[str(moment_dtype)] if moment_dtype is not None else torch.float32

    def init(params):
        return ScaleByAdamState(count=_zero_count(params), mu=_zeros(params, mdt),
                                nu=_zeros(params, mdt))

    def update(updates, state, params=None):
        count = state.count + 1
        t = count.to(torch.float32)
        # the corrections, once per step: 1 − b^t and (Nesterov) 1 − b^(t+1)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        c1_next, c2_next = 1.0 - b1 ** (t + 1.0), 1.0 - b2 ** (t + 1.0)
        mu, nu, out = {}, {}, {}
        for k, g in updates.items():
            g = g.to(torch.float32)
            m = (state.mu[k].to(torch.float32) * b1).add_(g, alpha=1 - b1).to(mdt)
            v = (state.nu[k].to(torch.float32) * b2).addcmul_(g, g, value=1 - b2).to(mdt)
            mu[k], nu[k] = m, v
            m, v = m.to(torch.float32), v.to(torch.float32)
            if nesterov_m:
                # Alg. 3, constant b1: m̂ = b1·m/(1 − b1^(t+1)) + (1 − b1)·g/(1 − b1^t)
                m_hat = (b1 * m / c1_next).add_((1 - b1) * g / c1)
            elif bias_correction:
                m_hat = m / c1
            else:
                m_hat = m
            if nesterov_v:
                v_hat = (b2 * v / c2_next).add_((1 - b2) * g * g / c2)
            elif nesterov_m:
                v_hat = b2 * v / c2   # Alg. 3: v̂ = b2·v/(1 − b2^t)
            elif bias_correction:
                v_hat = v / c2
            else:
                v_hat = v
            out[k] = m_hat / torch.sqrt(v_hat).add_(eps)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def scale_by_adagrad(eps: float = 1e-7) -> GradientTransformation:
    """Adagrad's rescaling u = g/(√Σg² + eps), fp32 accumulator."""

    def init(params):
        return ScaleByAdagradState(accum=_zeros(params))

    def update(updates, state, params=None):
        accum, out = {}, {}
        for k, g in updates.items():
            g = g.to(torch.float32)
            accum[k] = state.accum[k] + g * g
            out[k] = g / (torch.sqrt(accum[k]) + eps)
        return out, ScaleByAdagradState(accum=accum)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float, mask: Optional[Dict[str, bool]] = None
                        ) -> GradientTransformation:
    """u += wd·params where ``mask`` is True (None: everywhere); raises
    ValueError without ``params``."""

    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        new = {k: u + weight_decay * params[k].to(u.dtype)
               if mask is None or mask[k] else u for k, u in updates.items()}
        return new, state

    return GradientTransformation(init, update)


def global_norm(tree: Tensors) -> torch.Tensor:
    """L2 norm over every leaf, reduced in fp32.

    Under an ambient sharding context the leaves it splits are this rank's
    blocks: their per-leaf Σx² are all-reduced over the world in one
    collective before the sum, each counted on the ranks
    :meth:`~repro_torch.sharding.ShardCtx.counts` names and zero on the
    others, so the norm is the whole tree's on every rank (and, over one
    rank, the same bits as without a context).
    """
    keys = list(tree)
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square() for x in tree.values()]
    ctx = current()
    split = [i for i, k in enumerate(keys) if ctx is not None and ctx.split(k)]
    if split:
        part = torch.stack([sq[i] if ctx.counts(keys[i]) else torch.zeros_like(sq[i])
                            for i in split])
        for i, t in zip(split, all_reduce(part, "sum", ctx.world_group).unbind()):
            sq[i] = t
    sq = torch.stack(sq)
    return torch.sqrt(sq.sum())


def _clip_factor(tree: Tensors, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (global_norm(tree) + 1e-12), max=1.0)


@torch.no_grad()
def clip_tree_by_global_norm(tree: Tensors, max_norm: float) -> None:
    """Rescale ``tree`` in place so its global L2 norm is at most ``max_norm``.

    Factor ``min(1, max_norm / (norm + 1e-12))``, norm reduced in fp32; leaf
    dtypes are kept.  The fused path's form; ``clip_by_global_norm`` is the
    transform's, which writes new tensors.
    """
    factor = _clip_factor(tree, max_norm)
    for x in tree.values():
        x.mul_(factor)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Stateless transform: scale updates to global L2 norm ≤ ``max_norm``."""

    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        factor = _clip_factor(updates, max_norm)
        return {k: (x * factor).to(x.dtype) for k, x in updates.items()}, state

    return GradientTransformation(init, update)


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """x_{t+1} = x_t + u_t, added in fp32 and cast back to each param's dtype."""
    return {k: (p.to(torch.float32) + updates[k].to(torch.float32)).to(p.dtype)
            for k, p in params.items()}
