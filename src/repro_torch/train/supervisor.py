"""TrainingSupervisor: host-side loss-spike watchdog with checkpoint rollback
(port of ``repro.train.supervisor``; pure Python, copied because the JAX
package's ``repro.train`` imports jax).

The non-finite guard of the train step (``TrainConfig.skip_nonfinite``)
catches the *loud* failure — NaN/Inf loss or grads — by skipping the step.  The silent
one is divergence: every value finite, the loss climbing away (the regime
You et al. motivate LARS/LAMB with: plain large-batch momentum diverges).
The supervisor watches the per-step loss with a **median + MAD z-score**
over a rolling window of healthy observations — robust statistics, so the
spike itself cannot drag the threshold up the way a mean/std window would
— and on a trip tells the Trainer to roll back to the last *validated*
checkpoint and resume the data stream **past** the suspect window.

Validation matters: a checkpoint written at step ``s`` holds the params
that produce the loss observed one step later, so a healthy observation at
step ``s`` retroactively validates the step-``s`` checkpoint.  A save that
raced ahead of a poisoned update is therefore never a rollback target —
the Trainer restores the newest checkpoint with ``step <= last_good``.

Trips:

* ``loss_spike`` — robust z-score above ``spike_zmax`` AND a relative jump
  (two gates, so a near-constant loss window cannot false-trip on noise);
* ``nonfinite_loss`` — a non-finite loss observed with the guard off (or a
  non-finite metric that slipped past it): params are already poisoned;
* ``nonfinite_budget`` — ``skip_budget`` *consecutive* guard skips: the
  stream or the state is persistently producing non-finite steps and
  skipping forward is no longer making progress.

``max_rollbacks`` bounds the retry loop; exceeding it raises
:class:`DivergenceError` carrying the diagnostics (recent losses, skip and
rollback counts) — the clean abort, instead of looping forever on a run
that cannot be saved.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


# every reason TrainingSupervisor.observe can return (a mesh broadcasts its
# index)
TRIP_REASONS = ("nonfinite_budget", "nonfinite_loss", "loss_spike")


class DivergenceError(RuntimeError):
    """Training diverged beyond what rollback can repair (clean abort)."""

    def __init__(self, message: str, diagnostics: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    spike_window: int = 32        # rolling window of healthy losses
    spike_zmax: float = 8.0       # robust z-score trip threshold
    min_history: int = 8          # observations before the detector arms
    min_rel_jump: float = 0.5     # AND-gate: loss > med + jump*max(|med|,1)
    skip_budget: int = 3          # consecutive guard skips before a trip
    max_rollbacks: int = 3        # rollbacks before the diagnostic abort


class SpikeDetector:
    """Windowed robust (median + MAD) spike detector over a loss stream.

    ``observe(loss)`` returns True on a spike.  Non-finite losses always
    count as spikes; spiking values never enter the window, so a slow
    divergence cannot normalize itself into the statistics.
    """

    def __init__(self, window: int = 32, zmax: float = 8.0,
                 min_history: int = 8, min_rel_jump: float = 0.5):
        if min_history < 2:
            raise ValueError("min_history must be >= 2")
        self.zmax = float(zmax)
        self.min_history = int(min_history)
        self.min_rel_jump = float(min_rel_jump)
        self._window: deque = deque(maxlen=int(window))

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def stats(self) -> Tuple[float, float]:
        """(median, MAD) of the current window."""
        xs = list(self._window)
        med = self._median(xs)
        mad = self._median([abs(x - med) for x in xs])
        return med, mad

    def observe(self, loss: float) -> bool:
        loss = float(loss)
        if not math.isfinite(loss):
            return True
        if len(self._window) < self.min_history:
            self._window.append(loss)
            return False
        med, mad = self.stats()
        # 1.4826·MAD ≈ σ for gaussian noise; the floor keeps a constant
        # window from making the z-score infinite on any wiggle — the
        # relative-jump AND-gate is what actually rejects small noise
        z = (loss - med) / (1.4826 * mad + 1e-12)
        jump = loss > med + self.min_rel_jump * max(abs(med), 1.0)
        if z > self.zmax and jump:
            return True
        self._window.append(loss)
        return False

    def reset(self) -> None:
        self._window.clear()


class TrainingSupervisor:
    """Folds per-step host observations into trip/rollback decisions.

    The Trainer calls :meth:`observe` once per completed step with the
    host-fetched loss and the state's cumulative ``skipped`` counter, and
    acts on the returned trip reason (None = healthy).  ``last_good`` is
    the newest checkpoint step a healthy observation has validated — the
    rollback target bound.
    """

    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg
        self.detector = SpikeDetector(
            window=cfg.spike_window, zmax=cfg.spike_zmax,
            min_history=cfg.min_history, min_rel_jump=cfg.min_rel_jump,
        )
        self.rollbacks = 0
        self.consecutive_skips = 0
        self.last_good = -1
        self._last_skipped = 0
        self._recent: deque = deque(maxlen=max(cfg.spike_window, 8))

    def observe(self, step: int, loss: float,
                skipped_total: int) -> Optional[str]:
        """One post-step observation; returns a trip reason or None.

        ``step`` is the state's step counter *after* the update (the loss
        was computed on the pre-update params), ``skipped_total`` the
        cumulative guard-skip counter.
        """
        step, skipped_total = int(step), int(skipped_total)
        loss = float(loss)
        self._recent.append({"step": step, "loss": loss,
                             "skipped_total": skipped_total})
        delta = skipped_total - self._last_skipped
        self._last_skipped = skipped_total
        if delta > 0:
            self.consecutive_skips += 1
            if self.consecutive_skips >= self.cfg.skip_budget:
                return "nonfinite_budget"
            return None
        self.consecutive_skips = 0
        if not math.isfinite(loss):
            # guard off (or a metric the guard does not cover): the update
            # that produced this loss already poisoned the params
            return "nonfinite_loss"
        if self.detector.observe(loss):
            return "loss_spike"
        # healthy loss on pre-update params: validates the state as of one
        # step earlier — and hence any checkpoint at step <= step - 1
        self.last_good = max(self.last_good, step - 1)
        return None

    def note_rollback(self, reason: str) -> None:
        """Count a rollback; raise :class:`DivergenceError` past the budget."""
        self.rollbacks += 1
        if self.rollbacks > self.cfg.max_rollbacks:
            raise DivergenceError(
                f"diverged: {reason} persisted through "
                f"{self.cfg.max_rollbacks} rollback(s)",
                self.diagnostics(reason),
            )

    def after_rollback(self, skipped_total: int) -> None:
        """Re-sync after the Trainer restored state: clear the window (the
        loss level may legitimately differ at the restored step) and re-base
        the skip counter on the restored state's counter."""
        self.detector.reset()
        self.consecutive_skips = 0
        self._last_skipped = int(skipped_total)

    def diagnostics(self, reason: str = "") -> Dict[str, Any]:
        med, mad = (self.detector.stats() if self.detector._window
                    else (float("nan"), float("nan")))
        return {
            "reason": reason,
            "rollbacks": self.rollbacks,
            "consecutive_skips": self.consecutive_skips,
            "last_good_step": self.last_good,
            "window_median": med,
            "window_mad": mad,
            "recent": list(self._recent),
        }
