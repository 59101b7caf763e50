"""Baseline optimizers the paper compares LAMB against (§4, App. H); port
of ``repro.optim.baselines``.

sgd / momentum / adam / adamw / adagrad, built from the transforms of
:mod:`repro_torch.optim.base` so they share LAMB's state conventions.
"""
from __future__ import annotations

from repro_torch.optim.base import (
    GradientTransformation,
    ScalarOrSchedule,
    add_decayed_weights,
    chain,
    scale_by_adagrad,
    scale_by_adam,
    scale_by_learning_rate,
    trace,
)


def sgd(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    return chain(scale_by_learning_rate(learning_rate))


def momentum(
    learning_rate: ScalarOrSchedule,
    beta: float = 0.9,
    weight_decay: float = 0.0,
    wd_mask=None,
    *,
    average: bool = False,
) -> GradientTransformation:
    """SGD with heavy-ball momentum (Goyal et al. baseline).

    ``average=False`` is the classic accumulator (m = beta·m + g);
    ``average=True`` the EMA form of the paper's LARS pseudocode.
    """
    transforms = []
    if weight_decay:
        transforms.append(add_decayed_weights(weight_decay, wd_mask))
    transforms.append(trace(beta, average=average))
    transforms.append(scale_by_learning_rate(learning_rate))
    return chain(*transforms)


def adam(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    l2_regularization: float = 0.0,
) -> GradientTransformation:
    """Adam; optional classic (coupled) L2 added to the gradient."""
    transforms = []
    if l2_regularization:
        transforms.append(add_decayed_weights(l2_regularization, None))
    transforms.append(scale_by_adam(b1, b2, eps))
    transforms.append(scale_by_learning_rate(learning_rate))
    return chain(*transforms)


def adamw(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    wd_mask=None,
) -> GradientTransformation:
    """AdamW: decoupled weight decay added to the Adam direction."""
    return chain(
        scale_by_adam(b1, b2, eps),
        add_decayed_weights(weight_decay, wd_mask),
        scale_by_learning_rate(learning_rate),
    )


def adagrad(learning_rate: ScalarOrSchedule, eps: float = 1e-7) -> GradientTransformation:
    return chain(scale_by_adagrad(eps), scale_by_learning_rate(learning_rate))
