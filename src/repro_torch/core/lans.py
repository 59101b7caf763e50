"""LANS (Zheng et al., 2020): LAMB with block-normalized gradients and a
two-term Nesterov update, each term trust-rescaled per layer (port of
``repro.core.lans``):

    g~ = g / ||g||  per layer block (a zero block passes through)
    d  = m^/(sqrt(v^)+eps) + lambda x,   d' = g~/(sqrt(v^)+eps) + lambda x
    x <- x - eta [ b1 (phi(||x||)/||d||) d + (1-b1) (phi(||x||)/||d'||) d' ]

``chain(scale_by_lans, scale_by_learning_rate)``: the moments sit in a
``ScaleByAdamState`` (its count drives bias correction and carries over a
stage switch), the schedule's counter in the ``ScheduleState`` after it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.strategy import _slice_norm, layer_axis, trust_ratio
from repro_torch.optim.base import (
    _DTYPES,
    GradientTransformation,
    ScalarOrSchedule,
    ScaleByAdamState,
    Tensors,
    _zero_count,
    _zeros,
    chain,
    clip_by_global_norm,
    scale_by_learning_rate,
)


def _normalize(g32: torch.Tensor, axis: int, norm_ord: str, path: str) -> torch.Tensor:
    n = _slice_norm(g32, axis, norm_ord, path)
    return torch.where(n > 0, g32 / torch.where(n > 0, n, 1.0), g32)


def normalize_grads(
    grads: Tensors,
    *,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    norm_ord: str = "l2",
) -> Tensors:
    """g~ = g / ||g|| per layer block (per slice on stacked leaves), fp32;
    an all-zero block passes through unchanged."""
    return {k: _normalize(g.to(torch.float32), layer_axis(layer_axes, k), norm_ord, k)
            for k, g in grads.items()}


def scale_by_lans(
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    *,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    bias_correction: bool = True,
    moment_dtype=None,
    norm_ord: str = "l2",
) -> GradientTransformation:
    """The LANS direction (positive: chain with ``scale_by_learning_rate``)."""
    mdt = _DTYPES[str(moment_dtype)] if moment_dtype is not None else torch.float32

    def init(params):
        return ScaleByAdamState(count=_zero_count(params), mu=_zeros(params, mdt),
                                nu=_zeros(params, mdt))

    def update(updates: Tensors, state, params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("scale_by_lans requires params")
        count = state.count + 1
        t = count.to(torch.float32)
        c1 = (1.0 - b1 ** t) if bias_correction else 1.0
        c2 = (1.0 - b2 ** t) if bias_correction else 1.0
        out, mu, nu = {}, {}, {}
        for k, g in updates.items():
            axis = layer_axis(layer_axes, k)
            x = params[k]
            g_tilde = _normalize(g.to(torch.float32), axis, norm_ord, k)
            m_new = b1 * state.mu[k].to(torch.float32) + (1 - b1) * g_tilde
            v_new = b2 * state.nu[k].to(torch.float32) + (1 - b2) * g_tilde * g_tilde
            denom = torch.sqrt(v_new / c2) + eps
            decayed = weight_decay and (wd_mask is None or wd_mask[k])
            wd = weight_decay * x.to(torch.float32) if decayed else 0.0
            d_m = (m_new / c1) / denom + wd     # momentum direction
            d_g = g_tilde / denom + wd          # current-gradient direction
            if trust_mask is None or trust_mask[k]:
                kw = dict(layer_axis=axis, phi_bounds=phi_bounds, norm_ord=norm_ord, path=k)
                r_m, r_g = trust_ratio(x, d_m, **kw), trust_ratio(x, d_g, **kw)
            else:
                r_m = r_g = 1.0
            out[k] = b1 * r_m * d_m + (1 - b1) * r_g * d_g
            mu[k], nu[k] = m_new.to(mdt), v_new.to(mdt)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def lans(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    *,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    bias_correction: bool = True,
    grad_clip_norm: Optional[float] = None,
    moment_dtype=None,
    norm_ord: str = "l2",
) -> GradientTransformation:
    """LANS, LAMB's signature family; the global-norm clip (when set) runs
    before the per-block normalization, which then removes its effect on
    masked-in blocks."""
    transforms = []
    if grad_clip_norm is not None:
        transforms.append(clip_by_global_norm(grad_clip_norm))
    transforms.append(scale_by_lans(
        b1, b2, eps, weight_decay, wd_mask=wd_mask, trust_mask=trust_mask,
        layer_axes=layer_axes, phi_bounds=phi_bounds, bias_correction=bias_correction,
        moment_dtype=moment_dtype, norm_ord=norm_ord))
    transforms.append(scale_by_learning_rate(learning_rate))
    return chain(*transforms)
