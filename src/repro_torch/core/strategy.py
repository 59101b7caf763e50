"""The paper's §3 general layerwise adaptation strategy as a transform
(port of ``repro.core.strategy``).

Given a base optimizer's direction ``u_t``, each layer's update becomes

    x_{t+1}^(i) = x_t^(i) - eta * phi(||x_t^(i)||) / ||u_t^(i)|| * u_t^(i)

with ``phi(z) = clip(z, gamma_l, gamma_u)``: LARS (Algorithm 1) over
momentum, LAMB (Algorithm 2) over Adam with weight decay.  As in the
reference, the ratio is 1 where either norm is 0, ``trust_mask`` exempts
leaves (norm scales and biases), and a stacked ``(layers, ...)`` leaf,
marked by its axis in ``layer_axes``, gets one ratio per layer slice.
Every norm is reduced in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.optim.base import EmptyState, GradientTransformation, Tensors, chain
from repro_torch.sharding.collectives import all_reduce, group_size
from repro_torch.sharding.context import current

_ORDS = {"l2": 2, "l1": 1, "linf": math.inf}


def layer_axis(layer_axes: Optional[Dict[str, Optional[int]]], path: str) -> int:
    """The stacked-layers axis of leaf ``path``; -1 when it has none."""
    axis = (layer_axes or {}).get(path)
    return -1 if axis is None else axis


def phi_clip(z: torch.Tensor, bounds: Optional[Tuple[float, float]]) -> torch.Tensor:
    """phi(z) = min(max(z, gamma_l), gamma_u); identity when bounds is None."""
    if bounds is None:
        return z
    return torch.clamp(z, bounds[0], bounds[1])


def _slice_norm(x: torch.Tensor, layer_axis: Optional[int], ord: str = "l2",
                path: Optional[str] = None) -> torch.Tensor:
    """fp32 norm over every axis but the stacked-layers one (kept, so the
    result broadcasts against ``x``); over all axes to a scalar when
    ``layer_axis`` is None or negative.  App. F's l1 / l2 / linf.

    ``path`` names the parameter ``x`` belongs to: where the ambient
    sharding context splits it, ``x`` is this rank's block and the partial
    Σ|x|ᵖ (max for linf) is all-reduced over the world, counted on the
    ranks :meth:`~repro_torch.sharding.ShardCtx.counts` names and zero on
    the others, so the norm is the whole leaf's, as GSPMD keeps it.  The
    stacked axis never splits, so per-layer partials reduce as they are.
    """
    if layer_axis is None or layer_axis < 0:
        dims = None
    else:
        dims = tuple(i for i in range(x.ndim) if i != layer_axis)
        if not dims:   # a (layers,) leaf: the norm of one element
            return x.to(torch.float32).abs()
    norm = torch.linalg.vector_norm(x, _ORDS[ord], dim=dims, keepdim=dims is not None,
                                    dtype=torch.float32)
    ctx = current()
    if ctx is None or not ctx.split(path) or group_size(ctx.world_group) == 1:
        return norm
    group = ctx.world_group
    if not ctx.counts(path):
        norm = torch.zeros_like(norm)
    if ord == "linf":
        return all_reduce(norm, "max", group)
    if ord == "l1":
        return all_reduce(norm, "sum", group)
    return torch.sqrt(all_reduce(norm.square(), "sum", group))


def trust_ratio(
    param: torch.Tensor,
    update: torch.Tensor,
    *,
    layer_axis: Optional[int] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    eps: float = 0.0,
    norm_ord: str = "l2",
    path: Optional[str] = None,
) -> torch.Tensor:
    """phi(||x||)/(||u|| + eps), 1 where either norm is 0: a scalar, or one
    ratio per layer slice (broadcastable) with ``layer_axis``.  ``path``
    names the parameter, for norms over a sharded leaf (see
    :func:`_slice_norm`)."""
    w_norm = phi_clip(_slice_norm(param, layer_axis, norm_ord, path), phi_bounds)
    u_norm = _slice_norm(update, layer_axis, norm_ord, path)
    safe = w_norm / (u_norm + eps)
    return torch.where(w_norm > 0, torch.where(u_norm > 0, safe, 1.0), 1.0)


def layerwise_adaptation(
    *,
    phi_bounds: Optional[Tuple[float, float]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    eps: float = 0.0,
    norm_ord: str = "l2",
) -> GradientTransformation:
    """Stateless transform: each masked-in leaf's update rescaled to norm
    ``phi(||x||)`` per layer slice (multiply by −lr downstream for
    Algorithm 2's step); a masked-out leaf passes through.  Needs params."""

    def init(params):
        return EmptyState()

    def update(updates: Tensors, state, params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("layerwise_adaptation requires params")
        new = {}
        for k, u in updates.items():
            if trust_mask is not None and not trust_mask[k]:
                new[k] = u
                continue
            r = trust_ratio(params[k], u, layer_axis=layer_axis(layer_axes, k),
                            phi_bounds=phi_bounds, eps=eps, norm_ord=norm_ord, path=k)
            new[k] = (r * u.to(torch.float32)).to(u.dtype)
        return new, state

    return GradientTransformation(init, update)


def layerwise_adapt(
    base: GradientTransformation,
    *,
    phi_bounds: Optional[Tuple[float, float]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
) -> GradientTransformation:
    """The paper's general strategy around any base optimizer; the learning
    rate goes after it (the wrapper normalizes whatever the base gives)."""
    return chain(base, layerwise_adaptation(phi_bounds=phi_bounds, trust_mask=trust_mask,
                                            layer_axes=layer_axes))
