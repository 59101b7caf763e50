"""Double-buffered async checkpointing (port of ``repro.checkpoint.async_io``):
the step loop never waits on the disk.

A save splits in two:

1. **snapshot** (the caller's thread): every leaf is copied into a host
   buffer by ``copy_(non_blocking=True)`` on the current stream, and a CUDA
   event is recorded behind the copies.  The port updates params and
   moments in place, so the copies must be queued before the next step's
   K1/K2 on the same stream: the stream's order then guarantees that they
   read this step's state.  The caller only pays for queueing (and, on the
   first save, for allocating the pinned buffers); the stream pays for the
   device-to-host copy.
2. **write** (one background thread): waits on that event, never on a
   snapshot that could still be changing, then writes the host buffers
   through the same atomic tmp-dir/rename + LATEST protocol as the sync path
   (:func:`~repro_torch.checkpoint.io.write_checkpoint_dir`).

Double-buffered: while write *N* is in flight, ``save`` for *N+1* takes its
snapshot into the other host buffer, and only then waits for write *N*; so
at most one write is in flight and two host buffers exist (twice the
state's bytes of pinned host memory for a CUDA state).  Leaves on the CPU
are copied synchronously into ordinary host buffers.

``timings`` keeps, per completed save, ``snapshot_s`` (what ``save`` cost
the caller before waiting), ``blocked_s`` (its wait on the previous write),
``copy_s`` (the device-to-host copies' time on the stream, from CUDA events;
0 for a state on the CPU), ``copy_wait_s`` (the writer's wait for the
copies to land) and ``write_s`` (the writer's wall time, that wait
included).
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.io import (
    checkpoint_step,
    latest_checkpoint,
    tree_leaves_with_paths,
    write_checkpoint_dir,
)

HostLeaves = List[Tuple[str, Any]]


def _host_buffers(leaves: HostLeaves) -> Dict[str, torch.Tensor]:
    """One host tensor per tensor leaf, pinned where the leaf is on a card."""
    return {p: torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            for p, x in leaves if isinstance(x, torch.Tensor)}


def _fits(buffers: Optional[Dict[str, torch.Tensor]], leaves: HostLeaves) -> bool:
    if buffers is None:
        return False
    tensors = [(p, x) for p, x in leaves if isinstance(x, torch.Tensor)]
    return len(tensors) == len(buffers) and all(
        p in buffers and buffers[p].shape == x.shape and buffers[p].dtype == x.dtype
        for p, x in tensors)


class AsyncCheckpointer:
    """Double-buffered async saves of a full train-state tree.

    ``save`` queues the device-to-host snapshot, hands the write to a single
    background worker, and returns; ``wait`` drains the in-flight write
    (re-raising its exception, if any).  At most one write is in flight.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-write")
        self._future: Optional[Future] = None
        self._buffers: List[Optional[Dict[str, torch.Tensor]]] = [None, None]
        self._next = 0
        self.timings: List[Dict[str, float]] = []
        # resume-aware: a pre-existing complete checkpoint counts as persisted
        existing = latest_checkpoint(directory)
        self._latest_persisted: Optional[int] = (
            checkpoint_step(existing) if existing else None
        )

    def _snapshot(self, tree: Any) -> Tuple[HostLeaves, Optional[tuple]]:
        """Queue a copy of every leaf into this save's host buffer; returns
        the host leaves and the CUDA events before and after the copies
        (None when no leaf is on a card)."""
        leaves = tree_leaves_with_paths(tree)
        if not _fits(self._buffers[self._next], leaves):
            self._buffers[self._next] = None   # free before allocating anew
            self._buffers[self._next] = _host_buffers(leaves)
        buffers = self._buffers[self._next]
        self._next ^= 1
        host: HostLeaves = []
        on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in leaves)
        events = None
        if on_card:   # on the current stream, around every copy
            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            events[0].record()
        for p, x in leaves:
            if isinstance(x, torch.Tensor):
                buffers[p].copy_(x.detach(), non_blocking=x.is_cuda)
                host.append((p, buffers[p]))
            else:
                host.append((p, x))
        if events is not None:
            events[1].record()
        return host, events

    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` and schedule its write; never waits on the disk.

        The snapshot comes before the wait on the previous write, so a slow
        disk overlaps the new snapshot (the double buffer).
        """
        t0 = time.perf_counter()
        host, events = self._snapshot(tree)
        snapshot_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        self.wait()  # at most one write in flight; ~0 when the disk keeps up
        blocked_s = time.perf_counter() - t1
        self._future = self._executor.submit(
            self._write, int(step), host, events, snapshot_s, blocked_s
        )

    def _write(self, step: int, host: HostLeaves, events: Optional[tuple],
               snapshot_s: float, blocked_s: float) -> str:
        t0 = time.perf_counter()
        copy_s = 0.0
        if events is not None:
            events[1].synchronize()
            copy_s = events[0].elapsed_time(events[1]) / 1e3
        copy_wait_s = time.perf_counter() - t0
        path = write_checkpoint_dir(self.directory, step, host)
        self._latest_persisted = step
        self.timings.append(dict(step=step, snapshot_s=snapshot_s, blocked_s=blocked_s,
                                 copy_s=copy_s, copy_wait_s=copy_wait_s,
                                 write_s=time.perf_counter() - t0))
        return path

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block until the in-flight write (if any) is durable.

        Returns the persisted checkpoint path, or None if nothing was in
        flight (or ``timeout`` seconds passed first; the write then stays in
        flight).  A failed background write re-raises here, on the caller's
        thread.
        """
        future = self._future
        if future is None:
            return None
        try:
            result = future.result(timeout)
        except (_FuturesTimeout, TimeoutError):
            return None
        except BaseException:
            self._future = None
            raise
        self._future = None
        return result

    def latest_persisted_step(self) -> Optional[int]:
        """Step of the newest checkpoint whose atomic rename completed."""
        return self._latest_persisted

    def close(self) -> None:
        self.wait()
        self._executor.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
