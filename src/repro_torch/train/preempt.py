"""SIGTERM/SIGINT preemption: flag-only handler + grace-window final save
(port of ``repro.train.preempt``).

Cluster schedulers (and Ctrl-C) preempt with SIGTERM and a grace period.
The handler here does nothing signal-unsafe — it sets a flag the Trainer's
step loop polls between steps.  Python runs a handler between bytecodes on
the main thread, so it never lands inside a kernel launch: the in-flight
step completes and the final checkpoint is a *consistent* full TrainState,
written through the existing
:class:`~repro_torch.checkpoint.async_io.AsyncCheckpointer` and drained
with the grace-window timeout.  A second delivery of the same
signal stops absorbing and raises ``KeyboardInterrupt`` — the escape hatch
when the grace save itself hangs.

Handlers can only be installed from the main thread; elsewhere (e.g. a
Trainer driven from a worker thread) the context manager degrades to a
never-triggered no-op rather than failing.
"""
from __future__ import annotations

import signal
from typing import Dict, Optional, Tuple


class PreemptionHandler:
    """Context manager: install flag-setting handlers, restore on exit."""

    def __init__(self, enabled: bool = True,
                 signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self.enabled = enabled
        self.signals = tuple(signals)
        self.triggered = False
        self.signum: Optional[int] = None
        self._old: Dict[int, object] = {}

    def _on_signal(self, signum, frame) -> None:
        if self.triggered:
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during preemption "
                "grace window"
            )
        self.triggered = True
        self.signum = signum

    @property
    def signal_name(self) -> str:
        return signal.Signals(self.signum).name if self.signum else "none"

    def __enter__(self) -> "PreemptionHandler":
        if not self.enabled:
            return self
        try:
            for s in self.signals:
                self._old[s] = signal.signal(s, self._on_signal)
        except ValueError:
            # not the main thread: signal.signal refuses; run unprotected
            for s, old in self._old.items():
                signal.signal(s, old)
            self._old.clear()
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
