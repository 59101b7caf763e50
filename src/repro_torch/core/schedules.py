"""Learning-rate schedules and the paper's batch-size scaling rules (§4.3).

Port of the parts of ``repro.core.schedules`` the training path uses.  A
schedule maps an int step tensor to an fp32 learning-rate tensor on the same
device, so the step never waits on the host.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def polynomial_decay(
    base_lr: float, total_steps: int, power: float = 1.0, end_lr: float = 0.0
) -> Schedule:
    """eta_t = end + (eta_0 - end) * (1 - t/T)^power  (the paper uses power=1)."""

    def schedule(step):
        frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
        return end_lr + (base_lr - end_lr) * (1.0 - frac) ** power

    return schedule


def warmup_poly_decay(
    base_lr: float,
    total_steps: int,
    warmup_steps: int,
    power: float = 1.0,
    end_lr: float = 0.0,
) -> Schedule:
    """BERT/LAMB schedule: linear warmup to base_lr, then polynomial decay to 0
    over the post-warmup remainder."""
    decay = polynomial_decay(base_lr, max(total_steps - warmup_steps, 1), power, end_lr)

    def schedule(step):
        step = step.to(torch.float32)
        after = decay(torch.clamp(step - warmup_steps, min=0.0))
        if warmup_steps <= 0:
            return after
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, after)

    return schedule


def sqrt_scaled_lr(base_lr: float, base_batch: int, batch: int) -> float:
    """Square-root LR scaling rule (Tables 4–5)."""
    return base_lr * math.sqrt(batch / base_batch)


def linear_epoch_warmup_ratio(base_ratio: float, base_batch: int, batch: int) -> float:
    """Warmup-step fraction grows linearly with batch (fixed warmup epochs)."""
    return min(base_ratio * batch / base_batch, 1.0)
