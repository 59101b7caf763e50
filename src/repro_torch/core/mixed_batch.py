"""Mixed-batch training (paper §4.1): the two-stage BERT recipe (port of
``repro.core.mixed_batch``).

Stage 1 runs at seq 128 with a large batch, stage 2 at seq 512 with half of
it; stage 2 re-warms the learning rate from zero while the optimizer's
moments carry over.  This module describes the plan; ``Trainer.fit_stages``
runs it with one train step per stage.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.schedules import (
    Schedule,
    linear_epoch_warmup_ratio,
    sqrt_scaled_lr,
    warmup_poly_decay,
)


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    seq_len: int
    batch_size: int
    steps: int
    schedule: Schedule
    learning_rate: float
    warmup_steps: int


def make_stage(
    name: str,
    seq_len: int,
    batch_size: int,
    steps: int,
    *,
    base_lr: float = 5e-3 / 8.0,
    base_batch: int = 512,
    base_warmup_ratio: float = 1.0 / 320.0,
) -> Stage:
    lr = sqrt_scaled_lr(base_lr, base_batch, batch_size)
    ratio = linear_epoch_warmup_ratio(base_warmup_ratio, base_batch, batch_size)
    warmup = int(round(ratio * steps))
    sched = warmup_poly_decay(lr, steps, warmup)
    return Stage(name, seq_len, batch_size, steps, sched, lr, warmup)


def bert_mixed_batch_plan(
    *,
    seq1: int = 128,
    seq2: int = 512,
    batch1: int = 65536,
    batch2: int = 32768,
    steps1: int = 7038,
    steps2: int = 1561,
    base_lr: float = 5e-3 / 8.0,
    base_batch: int = 512,
    base_warmup_ratio: float = 1.0 / 320.0,
) -> List[Stage]:
    """The paper's 8599-iteration mixed-batch recipe (64K/32K): each stage has
    its own sqrt-scaled LR and its own warmup (stage 2 re-warms from 0)."""
    kw = dict(base_lr=base_lr, base_batch=base_batch, base_warmup_ratio=base_warmup_ratio)
    return [
        make_stage("stage1_seq128", seq1, batch1, steps1, **kw),
        make_stage("stage2_seq512_rewarmup", seq2, batch2, steps2, **kw),
    ]


def scaled_plan(
    plan: Sequence[Stage], *, batch_divisor: int = 1, step_divisor: int = 1
) -> List[Stage]:
    """Shrink a plan for small validation runs, keeping its structure.

    As in the reference, each stage is remade with ``make_stage``'s default
    ``base_lr``, ``base_batch`` and ``base_warmup_ratio``, not the plan's.
    """
    out = []
    for s in plan:
        batch = max(s.batch_size // batch_divisor, 1)
        steps = max(s.steps // step_divisor, 2)
        out.append(make_stage(s.name, s.seq_len, batch, steps))
    return out
