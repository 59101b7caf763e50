"""Trainer: the step loop with a metrics history, checkpoints, resume, the
non-finite guard's bookkeeping and mixed-batch stages (port of
``repro.train.trainer.Trainer``).

Across a stage switch the optimizer moments and ``count`` carry over while
``sched_count`` restarts at zero, so stage 2 re-warms up: the §4.1
procedure.  Every checkpoint persists the full ``TrainState`` (params,
moments, both optimizer counters, ``step`` and ``skipped``) in the JAX
package's format; ``resume=True`` restores the latest complete one at
``fit`` start and fast-forwards the data, so the continuation is bit-exact
against a run that was never interrupted.  ``async_checkpoint=True`` routes
saves through :class:`~repro_torch.checkpoint.AsyncCheckpointer`.

Telemetry, the loss-spike supervisor and preemption are not ported yet
(ROADMAP.md queue 1, item 8).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    checkpoint_step,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.mixed_batch import Stage
from repro_torch.data.pipeline import DataPipeline
from repro_torch.kernels.ops import FusedLambState
from repro_torch.models.api import Model
from repro_torch.train.step import GUARD_KEY, TrainState, make_train_step

# the per-step metrics the history keeps, fetched together at a log step
HISTORY_KEYS = ("loss/total", "loss/ce", "accuracy", "tokens/supervised",
                "grad_norm", "update_norm")


def _batch_examples(batch) -> int:
    """Examples in one step's global batch: the leading dim of any leaf."""
    return int(next(iter(batch.values())).shape[0])


def _reset_schedule_counts(opt_state: FusedLambState) -> None:
    """Zero ``sched_count`` in place (stage-2 re-warm-up); ``count`` and the
    moments carry over."""
    opt_state.sched_count.zero_()


class Trainer:
    def __init__(
        self,
        model: Model,
        train_cfg: TrainConfig,
        *,
        device: torch.device,
        schedule=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        async_checkpoint: bool = False,
        resume: bool = False,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
    ):
        self.model = model
        self.tc = train_cfg
        self.device = torch.device(device)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.async_checkpoint = async_checkpoint
        self.resume = resume
        self._checkpointer: Optional[AsyncCheckpointer] = None
        self._last_saved_step: Optional[int] = None
        self.log_every = log_every
        self.log = log_fn
        self.history: List[Dict[str, float]] = []
        self.examples_seen = 0
        self._init_fn, self._step_fn = make_train_step(model, train_cfg, schedule)
        self.state: Optional[TrainState] = None

    def init(self, seed: Optional[int] = None) -> TrainState:
        self.state = self._init_fn(self.tc.seed if seed is None else seed, self.device)
        return self.state

    # ------------------------------------------------------------------
    # checkpointing + resume
    # ------------------------------------------------------------------
    @property
    def checkpointer(self) -> AsyncCheckpointer:
        """Lazy double-buffered async writer (made on the first async save)."""
        if self._checkpointer is None:
            self._checkpointer = AsyncCheckpointer(self.checkpoint_dir)
        return self._checkpointer

    def _save_checkpoint(self) -> None:
        """Persist the full TrainState.  A same-step re-save is dropped: with
        the guard on, skipped steps can put two cadence points on one
        ``state.step``; the state is the same and the write is not free."""
        step = int(self.state.step)
        if step == self._last_saved_step:
            return
        self._last_saved_step = step
        if self.async_checkpoint:
            self.checkpointer.save(step, self.state)
        else:
            save_checkpoint(self.checkpoint_dir, step, self.state)

    def _drain_checkpoints(self) -> None:
        """Block until the in-flight async write (if any) is durable, so a
        returned ``fit`` implies every scheduled checkpoint is on disk."""
        if self._checkpointer is not None:
            self._checkpointer.wait()

    def restore(self, path: Optional[str] = None) -> Optional[int]:
        """Restore the full TrainState from ``path`` (default: the latest
        complete checkpoint in ``checkpoint_dir``) onto this trainer's
        device.  Returns the restored step, or None when there is nothing to
        restore."""
        if path is None:
            path = latest_checkpoint(self.checkpoint_dir) if self.checkpoint_dir else None
        if path is None:
            return None
        target = self.state if self.state is not None else self.init()
        self.state = restore_checkpoint(path, target)
        step = checkpoint_step(path)
        self.log(f"resumed step {step} from {path}")
        return step

    def _maybe_resume(self, data, steps: int) -> int:
        """With ``resume=True``, restore the latest checkpoint and return the
        batch ordinal to continue from (0 when none exists), fast-forwarding
        ``data`` past the ``step + skipped`` batches already consumed."""
        if not self.resume:
            return 0
        step = self.restore()
        if step is None:
            return 0
        self._last_saved_step = step
        start = min(step + int(self.state.skipped), steps)
        for _ in range(start):
            self.examples_seen += _batch_examples(next(data))
        return start

    # ------------------------------------------------------------------
    def _history_row(self, metrics, extra: Dict[str, float], t0: float) -> Dict[str, float]:
        """One history row: the fp32 metrics and both int32 counters in one
        stack and one transfer (which also waits for the device, so
        ``wall_s`` counts finished work).  The counters ride as their bits
        (a view, no cast kernel) and are read back as int32."""
        keys = HISTORY_KEYS + ((GUARD_KEY,) if self.tc.skip_nonfinite else ())
        values = torch.stack([metrics[k].to(torch.float32) for k in keys]
                             + [self.state.step.view(torch.float32),
                                self.state.skipped.view(torch.float32)]).cpu()
        m = dict(zip(keys, values[:-2].tolist()))
        step, skipped = values[-2:].view(torch.int32).tolist()
        m["step"] = step
        if self.tc.skip_nonfinite:
            m["skipped_total"] = skipped
        m["examples_seen"] = self.examples_seen
        m["wall_s"] = time.perf_counter() - t0
        m.update(extra)
        self.history.append(m)
        return m

    def fit(self, data, steps: int) -> List[Dict[str, float]]:
        """Run the step loop to ``steps`` batches (counting those a resume
        skips).  Metrics stay on the device between log steps."""
        start = self._maybe_resume(data, steps)
        if self.state is None:
            self.init()
        t0 = time.perf_counter()
        # i is the batch ordinal, not state.step: a guard-skipped step
        # consumes a batch without advancing step
        for i in range(start, steps):
            batch = next(data)
            self.examples_seen += _batch_examples(batch)
            self.state, metrics = self._step_fn(self.state, batch)
            if (i + 1) % self.log_every == 0 or i == steps - 1:
                m = self._history_row(metrics, {}, t0)
                self.log(f"step {m['step']:6d} loss {m['loss/total']:.4f} "
                         f"acc {m['accuracy']:.4f}")
            if (self.checkpoint_dir and self.checkpoint_every
                    and (i + 1) % self.checkpoint_every == 0):
                self._save_checkpoint()
        self._drain_checkpoints()
        return self.history

    def fit_stages(self, stages: Sequence[Stage], *, data_seed: int = 0
                   ) -> List[Dict[str, float]]:
        """Mixed-batch training: one train step per stage (its own shapes
        and schedule), moments and ``count`` carried, ``sched_count`` reset
        between stages; stage ``si`` reads a fresh ``DataPipeline`` seeded
        ``data_seed + si``.  History rows carry ``stage``; ``wall_s`` runs
        on one clock across the stages."""
        if self.state is None:
            self.init()
        t0 = time.perf_counter()
        for si, stage in enumerate(stages):
            self.log(f"== stage {si}: {stage.name} seq={stage.seq_len} "
                     f"batch={stage.batch_size} steps={stage.steps} "
                     f"lr={stage.learning_rate:.2e} warmup={stage.warmup_steps}")
            _, step_fn = make_train_step(self.model, self.tc, stage.schedule)
            if si > 0:
                _reset_schedule_counts(self.state.opt_state)
            data = DataPipeline(self.model.cfg, stage.batch_size, stage.seq_len,
                                device=self.device, seed=data_seed + si)
            for i in range(stage.steps):
                batch = next(data)
                self.examples_seen += _batch_examples(batch)
                self.state, metrics = step_fn(self.state, batch)
                if (i + 1) % self.log_every == 0 or i == stage.steps - 1:
                    m = self._history_row(metrics, {"stage": si}, t0)
                    self.log(f"[{stage.name}] step {m['step']:5d} "
                             f"loss {m['loss/total']:.4f}")
        return self.history
