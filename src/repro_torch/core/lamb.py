"""LAMB (Algorithm 2), the paper's optimizer, as a transform chain (port of
``repro.core.lamb``): [clip] → adam ratio → +decoupled weight decay →
layerwise trust-ratio rescale → −lr.  The trust ratio is taken on
``r_t + lambda * x_t``, as Algorithm 2 has it."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.strategy import layerwise_adaptation
from repro_torch.optim.base import (
    GradientTransformation,
    ScalarOrSchedule,
    add_decayed_weights,
    chain,
    clip_by_global_norm,
    scale_by_adam,
    scale_by_learning_rate,
)


def lamb(
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
    nesterov_m: bool = False,
    nesterov_v: bool = False,
    moment_dtype=None,
    norm_ord: str = "l2",
) -> GradientTransformation:
    """LAMB (paper defaults b1 .9, b2 .999, eps 1e-6, wd .01).

    ``wd_mask`` / ``trust_mask`` exclude leaves from weight decay / the
    trust ratio; ``layer_axes`` marks stacked leaves for per-layer ratios;
    ``phi_bounds`` clips phi; ``bias_correction=False`` is App. E;
    ``nesterov_m`` / ``nesterov_v`` are N-LAMB / NN-LAMB (App. D).
    """
    transforms = []
    if grad_clip_norm is not None:
        transforms.append(clip_by_global_norm(grad_clip_norm))
    transforms.append(scale_by_adam(b1, b2, eps, bias_correction=bias_correction,
                                    nesterov_m=nesterov_m, nesterov_v=nesterov_v,
                                    moment_dtype=moment_dtype))
    if weight_decay:
        transforms.append(add_decayed_weights(weight_decay, wd_mask))
    transforms.append(layerwise_adaptation(phi_bounds=phi_bounds, trust_mask=trust_mask,
                                           layer_axes=layer_axes, norm_ord=norm_ord))
    transforms.append(scale_by_learning_rate(learning_rate))
    return chain(*transforms)
