"""Learning-rate schedules and the paper's batch-size scaling rules (§4.3).

Port of ``repro.core.schedules``: square-root LR scaling, linear-epoch
warmup, polynomial decay, the re-warm-up of a mixed-batch stage 2 (§4.1) and
the Goyal et al. step schedule for baselines.  A schedule maps an int step
tensor to an fp32 learning-rate tensor on the same device, so the step never
waits on the host.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(value: float) -> Schedule:
    return lambda step: torch.full((), value, dtype=torch.float32, device=step.device)


def polynomial_decay(
    base_lr: float, total_steps: int, power: float = 1.0, end_lr: float = 0.0
) -> Schedule:
    """eta_t = end + (eta_0 - end) * (1 - t/T)^power  (the paper uses power=1)."""

    def schedule(step):
        frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
        return end_lr + (base_lr - end_lr) * (1.0 - frac) ** power

    return schedule


def linear_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    def schedule(step):
        if warmup_steps <= 0:
            return torch.full((), base_lr, dtype=torch.float32, device=step.device)
        return base_lr * torch.clamp(step.to(torch.float32) / warmup_steps, max=1.0)

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


def untuned_lamb_schedule(
    batch_size: int,
    total_steps: int,
    *,
    base_lr: float = 5e-3 / 8.0,   # Table 4: 5/(2^3 * 1e3) at batch 512
    base_batch: int = 512,
    base_warmup_ratio: float = 1.0 / 320.0,
    power: float = 1.0,
) -> Tuple[Schedule, dict]:
    """The paper's fully automatic scaling recipe (Table 4 defaults for BERT).

    Returns ``(schedule, info)``; ``info`` records the derived lr and warmup.
    """
    lr = sqrt_scaled_lr(base_lr, base_batch, batch_size)
    ratio = linear_epoch_warmup_ratio(base_warmup_ratio, base_batch, batch_size)
    warmup_steps = int(round(ratio * total_steps))
    sched = warmup_poly_decay(lr, total_steps, warmup_steps, power)
    return sched, {
        "learning_rate": lr,
        "warmup_ratio": ratio,
        "warmup_steps": warmup_steps,
        "total_steps": total_steps,
    }


def piecewise_stage_schedule(
    stage_schedules: Sequence[Schedule], stage_steps: Sequence[int]
) -> Schedule:
    """Concatenate per-stage schedules; each stage's local step restarts at 0
    (stage 2's re-warm-up, §4.1).  Past the end: the last stage's final value."""
    boundaries = []
    acc = 0
    for s in stage_steps:
        boundaries.append(acc)
        acc += s

    def schedule(step):
        step_f = step.to(torch.float32)
        out = torch.zeros((), dtype=torch.float32, device=step.device)
        for sched, start, length in zip(stage_schedules, boundaries, stage_steps):
            local = torch.clamp(step_f - start, 0.0, float(length))
            inside = (step_f >= start) & (step_f < start + length)
            out = torch.where(inside, sched(local), out)
        end = torch.full((), float(stage_steps[-1]), device=step.device)
        return torch.where(step_f >= boundaries[-1] + stage_steps[-1],
                           stage_schedules[-1](end), out)

    return schedule


def goyal_step_schedule(
    base_lr: float,
    steps_per_epoch: int,
    warmup_epochs: float = 5.0,
    milestones: Sequence[int] = (30, 60, 80),
    gamma: float = 0.1,
) -> Schedule:
    """Goyal et al. (2017) ResNet recipe, for tuned baselines (App. H)."""

    def schedule(step):
        epoch = step.to(torch.float32) / max(steps_per_epoch, 1)
        warm = base_lr * epoch / warmup_epochs
        factor = torch.ones((), dtype=torch.float32, device=step.device)
        for m in milestones:
            factor = torch.where(epoch >= m, factor * gamma, factor)
        return torch.where(epoch < warmup_epochs, warm, base_lr * factor)

    return schedule


def adam_correction_equivalent_lr(
    step: torch.Tensor, b1: float = 0.9, b2: float = 0.999
) -> torch.Tensor:
    """App. E: Adam's bias correction as an implicit LR factor
    sqrt(1 - b2^t) / (1 - b1^t), t = step + 1."""
    t = step.to(torch.float32) + 1.0
    return torch.sqrt(1.0 - b2**t) / (1.0 - b1**t)
