"""LARS (Algorithm 1), You et al. 2017 as this paper states it (port of
``repro.core.lars``):

    m_t = b1 * m_{t-1} + (1 - b1) * (g_t + lambda * x_t)
    x_{t+1}^(i) = x_t^(i) - eta * phi(||x^(i)||) / ||m^(i)|| * m^(i)

No gradient clip, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.strategy import layerwise_adaptation
from repro_torch.optim.base import (
    GradientTransformation,
    ScalarOrSchedule,
    add_decayed_weights,
    chain,
    scale_by_learning_rate,
    trace,
)


def lars(
    learning_rate: ScalarOrSchedule,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    *,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
) -> GradientTransformation:
    transforms = []
    if weight_decay:
        # Algorithm 1 folds weight decay into the momentum buffer's input
        transforms.append(add_decayed_weights(weight_decay, wd_mask))
    transforms.append(trace(momentum, average=True))
    transforms.append(layerwise_adaptation(phi_bounds=phi_bounds, trust_mask=trust_mask,
                                           layer_axes=layer_axes))
    transforms.append(scale_by_learning_rate(learning_rate))
    return chain(*transforms)
