"""Trainer: the step loop with a metrics history (core of
``repro.train.trainer.Trainer.fit``).

Checkpoints, mixed-batch stages, telemetry, the loss-spike supervisor and
preemption are not ported yet (ROADMAP.md queue 1, items 7–8).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.api import Model
from repro_torch.train.step import TrainState, make_train_step

# the per-step metrics the history keeps, fetched together at a log step
HISTORY_KEYS = ("loss/total", "loss/ce", "accuracy", "tokens/supervised",
                "grad_norm", "update_norm")


class Trainer:
    def __init__(
        self,
        model: Model,
        train_cfg: TrainConfig,
        *,
        device: torch.device,
        schedule=None,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
    ):
        self.model = model
        self.tc = train_cfg
        self.device = torch.device(device)
        self.log_every = log_every
        self.log = log_fn
        self.history: List[Dict[str, float]] = []
        self.examples_seen = 0
        self._init_fn, self._step_fn = make_train_step(model, train_cfg, schedule)
        self.state: Optional[TrainState] = None

    def init(self, seed: Optional[int] = None) -> TrainState:
        self.state = self._init_fn(self.tc.seed if seed is None else seed, self.device)
        return self.state

    def fit(self, data, steps: int) -> List[Dict[str, float]]:
        """Run ``steps`` batches.  Metrics stay on the device between log
        steps; a log step fetches them in one transfer (which also waits for
        the device, so ``wall_s`` there counts finished work)."""
        if self.state is None:
            self.init()
        t0 = time.perf_counter()
        for i in range(steps):
            batch = next(data)
            self.examples_seen += int(next(iter(batch.values())).shape[0])
            self.state, metrics = self._step_fn(self.state, batch)
            if (i + 1) % self.log_every == 0 or i == steps - 1:
                values = torch.stack([metrics[k].to(torch.float32) for k in HISTORY_KEYS])
                m = dict(zip(HISTORY_KEYS, values.tolist()))
                m["step"] = self.state.step
                m["examples_seen"] = self.examples_seen
                m["wall_s"] = time.perf_counter() - t0
                self.history.append(m)
                self.log(f"step {m['step']:6d} loss {m['loss/total']:.4f} "
                         f"acc {m['accuracy']:.4f}")
        return self.history
