"""Async-dispatch-aware span timers (port of ``repro.telemetry.spans``).

CUDA launches are asynchronous: ``t1 - t0`` around a step measures Python
dispatch, not device work, so naive per-step timing *lies* while the
device queue runs behind.  A :class:`SpanRecorder` span therefore
synchronizes only at its *boundaries*: the CUDA device of any tensor in
the tree handed to ``sync=`` when the span opens (drain the queue of prior
work) and of whatever the body registered via ``handle.block_on(...)``
when it closes (wait for the span's own work).  Everything launched inside
the span overlaps freely, so timing k steps costs two syncs, not k.

Two usage shapes share one accumulator:

* scoped::

      with spans.span("step", sync=state) as sp:
          for _ in range(k):
              state, metrics = step(state, batch)
          sp.block_on(state)
          sp.count = k

* phase-style (loop bodies that decide boundaries mid-iteration)::

      spans.start("step", sync=state)
      ...
      spans.stop("step", sync=(state, metrics), count=k)

Each closed span is one observation (``seconds`` / ``count`` items);
``summary()`` folds observations into count/total/mean/p50/max per name,
and a wired :class:`~repro_torch.telemetry.events.EventLog` receives one
``span`` event per close.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.telemetry.events import EventLog


class SpanHandle:
    """Mutable per-span state the body can attach results to."""

    def __init__(self, count: int = 1):
        self.count = count
        self._pending: List[Any] = []

    def block_on(self, tree: Any) -> Any:
        """Register arrays the span must wait for at close (returns them)."""
        self._pending.append(tree)
        return tree


class SpanRecorder:
    """Accumulates named span observations; optionally emits span events."""

    def __init__(self, log: Optional[EventLog] = None):
        self.log = log
        self._obs: Dict[str, List[tuple]] = {}  # name -> [(seconds, count)]
        self._open: Dict[str, float] = {}

    # -- core ----------------------------------------------------------------
    def observe(self, name: str, seconds: float, count: int = 1) -> None:
        """Record one closed span (the single accumulation point)."""
        self._obs.setdefault(name, []).append((float(seconds), int(count)))
        if self.log is not None:
            self.log.emit("span", name=name, seconds=float(seconds),
                          count=int(count))

    @staticmethod
    def _sync(tree: Any) -> None:
        """Synchronize the CUDA device of the first tensor in ``tree``; a
        no-op for ``None`` and for trees with no tensor on a card."""
        if tree is None:
            return
        import torch

        from repro_torch.checkpoint.io import tree_leaves_with_paths

        for _, leaf in tree_leaves_with_paths(tree):
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                return

    # -- scoped --------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, *, sync: Any = None, count: int = 1):
        self._sync(sync)
        handle = SpanHandle(count)
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            for tree in handle._pending:
                self._sync(tree)
            self.observe(name, time.perf_counter() - t0, handle.count)

    # -- phase-style ---------------------------------------------------------
    def start(self, name: str, *, sync: Any = None) -> None:
        """Open (or re-open) a named span; syncs, then stamps t0."""
        self._sync(sync)
        self._open[name] = time.perf_counter()

    def stop(self, name: str, *, sync: Any = None, count: int = 1) -> float:
        """Close a named span opened by :meth:`start`; returns seconds."""
        t0 = self._open.pop(name, None)
        if t0 is None:
            raise ValueError(f"span {name!r} was never started")
        self._sync(sync)
        dt = time.perf_counter() - t0
        self.observe(name, dt, count)
        return dt

    # -- aggregation ---------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name {count, total_s, mean_s, p50_s, max_s}; ``mean_s`` is
        per *item* (seconds/count), so a 10-step span contributes per-step
        time — the number to compare across log cadences."""
        out = {}
        for name, obs in self._obs.items():
            secs = np.array([s for s, _ in obs])
            items = np.array([c for _, c in obs])
            per_item = secs / np.maximum(items, 1)
            out[name] = {
                "count": int(items.sum()),
                "total_s": float(secs.sum()),
                "mean_s": float(secs.sum() / max(items.sum(), 1)),
                "p50_s": float(np.percentile(per_item, 50)),
                "max_s": float(per_item.max()),
            }
        return out
