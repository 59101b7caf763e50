"""N-LAMB and NN-LAMB (paper App. D, Algorithms 3-4); port of
``repro.core.nlamb``: Nesterov momentum folded into LAMB's first (N-LAMB)
or both (NN-LAMB) moments, with Dozat's (2016) b1 0.975, b2 0.999, eps 1e-8."""
from __future__ import annotations

from repro_torch.core.lamb import lamb
from repro_torch.optim.base import GradientTransformation, ScalarOrSchedule


def nlamb(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.975,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    **kw,
) -> GradientTransformation:
    return lamb(learning_rate, b1, b2, eps, weight_decay, nesterov_m=True, **kw)


def nnlamb(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.975,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    **kw,
) -> GradientTransformation:
    return lamb(learning_rate, b1, b2, eps, weight_decay, nesterov_m=True,
                nesterov_v=True, **kw)
