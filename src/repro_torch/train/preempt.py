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

Over a mesh each process has its own handler, and the Trainer reads the
agreed flag instead (:meth:`PreemptionHandler.agreed`): the MAX over the
world of every rank's signal number, so every rank stops on the same batch
when any rank has seen the signal.

Handlers can only be installed from the main thread; elsewhere (e.g. a
Trainer driven from a worker thread) the context manager degrades to a
never-triggered no-op rather than failing.
"""
from __future__ import annotations

import signal
from typing import Dict, Optional, Tuple

from repro_torch.sharding.collectives import agree_any


class PreemptionHandler:
    """Context manager: install flag-setting handlers, restore on exit."""

    def __init__(self, enabled: bool = True,
                 signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self.enabled = enabled
        self.signals = tuple(signals)
        self.triggered = False
        self.signum: Optional[int] = None
        self._agreed: Optional[int] = None   # another rank's signal, agreed
        self._old: Dict[int, object] = {}

    def _on_signal(self, signum, frame) -> None:
        if self.triggered:
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during preemption "
                "grace window"
            )
        self.triggered = True
        self.signum = signum

    def agreed(self, group) -> bool:
        """Whether any rank of ``group`` has seen a signal: the MAX of the
        ranks' signal numbers over the host group (one CPU all-reduce).  A
        rank that has not seen it takes the signal's name from the others
        (this rank's own handler stays as it was)."""
        got = agree_any(self.signum or 0, group)
        if got and self.signum is None:
            self._agreed = got
        return bool(got)

    @property
    def signal_name(self) -> str:
        num = self.signum or self._agreed
        return signal.Signals(num).name if num else "none"

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
