"""Request admission for continuous batching: FCFS queue + arrival processes.

A copy of ``repro.serve.scheduler`` (host Python and numpy; nothing changed).

The scheduler is pure host-side bookkeeping.  It owns the waiting line, the
``ContinuousEngine`` owns the slots: between decode steps the engine asks
``admit(now, free_slots)`` and the scheduler hands back at most
``max_prefills_per_step`` arrived requests (prefill/decode interleaving — a
prefill stalls every running slot for one step, so admission is throttled to
bound the latency hit on in-flight decodes).

Reliability contract (the serving twin of the training fault-tolerance
layer):

* every ``admit`` call **sweeps** the arrived backlog first — deadline and
  latency-budget expirations are removed whether or not a slot is free, so
  queue depth (and the ``queue_depth`` telemetry counter) stays honest under
  saturation instead of hiding an unbounded line of corpses behind a busy
  pool;
* with ``max_queue`` / ``max_queue_tokens`` set, the arrived backlog is
  **bounded**: arrivals beyond the bound are shed newest-first (FCFS is
  preserved among the requests that stay) with a typed
  ``RequestStatus.SHED`` / ``shed_reason="queue_full"`` result — overload
  degrades into explicit rejections, never silent queue growth.  The
  legacy unbounded behaviour remains the default (no bounds set).

Every request ends in exactly one terminal :class:`RequestStatus`
(``COMPLETED`` / ``SHED`` / ``TIMED_OUT`` / ``FAILED``); the engine asserts
the counts are disjoint and sum to the submitted total.

Arrival processes for benchmarking: ``poisson_arrivals`` (open-loop load at
a given request rate) and ``trace_arrivals`` (replay explicit timestamps).
"""
from __future__ import annotations

import bisect
import dataclasses
import enum
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


class RequestStatus(str, enum.Enum):
    """Typed request lifecycle.  The four terminal states are disjoint:

    * ``COMPLETED`` — generated to EOS / ``max_new_tokens``;
    * ``SHED`` — rejected by admission control (``shed_reason`` says why:
      ``queue_full``, ``deadline``, ``drain``) before holding a slot to
      completion;
    * ``TIMED_OUT`` — exceeded its per-request ``timeout_s`` latency budget
      (in queue or mid-decode — a running request frees its slot at once);
    * ``FAILED`` — transient-failure retries exhausted (``fail_reason``
      carries the last fault kind); surfaced, never silently dropped.
    """

    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    SHED = "shed"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


TERMINAL_STATUSES = frozenset({
    RequestStatus.COMPLETED,
    RequestStatus.SHED,
    RequestStatus.TIMED_OUT,
    RequestStatus.FAILED,
})


@dataclasses.dataclass
class ServeRequest:
    """One generation request plus its lifecycle record."""

    prompt: np.ndarray                   # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0                       # 0 = disabled
    eos_token: Optional[int] = None
    arrival_s: float = 0.0               # clock time the request arrives
    deadline_s: Optional[float] = None   # max queue wait before shed (rel.)
    timeout_s: Optional[float] = None    # total latency budget before
    #                                      timeout (rel. to arrival)
    rid: int = -1

    # lifecycle (filled by the scheduler/engine)
    submitted_s: float = math.nan        # first submission (retries move
    #                                      arrival_s; this never moves)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    admitted_s: float = math.nan
    first_token_s: float = math.nan
    finish_s: float = math.nan
    status: RequestStatus = RequestStatus.PENDING
    shed_reason: Optional[str] = None    # queue_full | deadline | drain
    fail_reason: Optional[str] = None    # last fault kind on FAILED
    attempts: int = 0                    # admissions so far (retries + 1)

    @property
    def dropped(self) -> bool:
        """Back-compat view: True when the request never completed because
        the serving layer gave up on it (shed or timed out)."""
        return self.status in (RequestStatus.SHED, RequestStatus.TIMED_OUT)

    @property
    def born_s(self) -> float:
        """The request's true start: first submission when known (a retry
        re-stamps ``arrival_s`` to re-enter the FCFS queue), else arrival."""
        return self.arrival_s if math.isnan(self.submitted_s) else self.submitted_s

    @property
    def ttft_s(self) -> float:
        """Time to first token, from the original arrival."""
        return self.first_token_s - self.born_s

    @property
    def latency_s(self) -> float:
        """Total latency, from the original arrival to completion."""
        return self.finish_s - self.born_s


def request_tokens(req: ServeRequest) -> int:
    """Admission-control token-budget estimate: prompt plus the full
    generation budget (worst case — EOS may finish a request early)."""
    return len(req.prompt) + int(req.max_new_tokens)


class FCFSScheduler:
    """First-come-first-served admission with deadline sweeps and bounded-
    queue load shedding.

    Args: ``max_prefills_per_step`` throttles admissions per decode step;
    ``max_queue`` / ``max_queue_tokens`` bound the *arrived* backlog (count
    and estimated prompt+generation tokens) — with either set, arrivals
    beyond the bound are shed newest-first at the next sweep.  ``None``
    (default) keeps the legacy unbounded queue.
    """

    def __init__(self, max_prefills_per_step: int = 2, *,
                 max_queue: Optional[int] = None,
                 max_queue_tokens: Optional[int] = None):
        if max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if max_queue_tokens is not None and max_queue_tokens < 1:
            raise ValueError("max_queue_tokens must be >= 1 (or None)")
        self.max_prefills_per_step = max_prefills_per_step
        self.max_queue = max_queue
        self.max_queue_tokens = max_queue_tokens
        self._queue: List[ServeRequest] = []
        # arrival keys, kept parallel to _queue: queue_depth runs between
        # every decode step, so it must not rebuild a key list per call
        self._keys: List[Tuple[float, int]] = []
        self._next_rid = 0

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Enqueue a request (assigning a rid if unset) and return it.

        Invariant: the queue stays sorted by (arrival_s, rid) — FCFS even
        when requests are submitted out of arrival order.  Queue bounds are
        enforced at *arrival* (the next ``admit`` sweep), not here: under a
        virtual clock a request may be submitted long before it arrives.
        """
        if req.rid < 0:
            req.rid = self._next_rid
            self._next_rid += 1
        key = (req.arrival_s, req.rid)
        idx = bisect.bisect_left(self._keys, key)
        self._keys.insert(idx, key)
        self._queue.insert(idx, req)
        return req

    def _pop_at(self, idx: int) -> ServeRequest:
        self._keys.pop(idx)
        return self._queue.pop(idx)

    def has_pending(self) -> bool:
        """True while any request is still waiting (arrived or future)."""
        return bool(self._queue)

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival time among queued requests (None if empty)."""
        return self._queue[0].arrival_s if self._queue else None

    def queue_depth(self, now: float) -> int:
        """Requests that have *arrived* and are waiting for a slot at
        ``now`` (the telemetry counter — future arrivals don't count as
        queueing delay)."""
        return bisect.bisect_right(self._keys, (now, float("inf")))

    def sweep(self, now: float) -> List[ServeRequest]:
        """Remove every arrived request the serving layer must give up on,
        independent of slot availability:

        1. **expirations** — queue wait past ``deadline_s`` (→ ``SHED``,
           reason ``deadline``) or total latency budget ``timeout_s``
           already spent in the queue (→ ``TIMED_OUT``);
        2. **overload shedding** — with ``max_queue``/``max_queue_tokens``
           set, the newest arrivals beyond the bound (→ ``SHED``, reason
           ``queue_full``); the oldest keep their place, so FCFS order is
           preserved among surviving (and eventually admitted) requests.

        Returns the removed requests with their terminal status set.
        ``admit`` calls this on every invocation — expired requests leave
        the queue even when zero slots are free.
        """
        removed: List[ServeRequest] = []
        arrived = self.queue_depth(now)
        # 1. expirations, oldest first
        i = 0
        while i < arrived:
            req = self._queue[i]
            waited = now - req.arrival_s
            # the latency budget spans the whole lifetime (retries included);
            # the queue-wait deadline is per attempt
            if req.timeout_s is not None and now - req.born_s > req.timeout_s:
                req.status = RequestStatus.TIMED_OUT
                req.finish_s = now
                removed.append(self._pop_at(i))
                arrived -= 1
            elif req.deadline_s is not None and waited > req.deadline_s:
                req.status = RequestStatus.SHED
                req.shed_reason = "deadline"
                req.finish_s = now
                removed.append(self._pop_at(i))
                arrived -= 1
            else:
                i += 1
        # 2. overload shedding, newest arrivals first
        if self.max_queue is not None or self.max_queue_tokens is not None:
            cap = self.max_queue if self.max_queue is not None else arrived
            keep = min(arrived, cap)
            if self.max_queue_tokens is not None:
                budget = self.max_queue_tokens
                fit = 0
                for req in self._queue[:keep]:
                    budget -= request_tokens(req)
                    if budget < 0:
                        break
                    fit += 1
                keep = fit
            for i in range(arrived - 1, keep - 1, -1):
                req = self._queue[i]
                req.status = RequestStatus.SHED
                req.shed_reason = "queue_full"
                req.finish_s = now
                removed.append(self._pop_at(i))
        return removed

    def drain(self, now: float) -> List[ServeRequest]:
        """Shed the *entire* queue (arrived and future arrivals alike) with
        reason ``drain`` — graceful-shutdown admission stop."""
        removed = []
        while self._queue:
            req = self._pop_at(0)
            req.status = RequestStatus.SHED
            req.shed_reason = "drain"
            req.finish_s = now
            removed.append(req)
        return removed

    def admit(
        self, now: float, free_slots: int
    ) -> Tuple[List[ServeRequest], List[ServeRequest]]:
        """Sweep, then pop up to min(free_slots, max_prefills_per_step)
        arrived requests in FCFS order.  Returns ``(admitted, removed)`` —
        removed requests expired or were shed by the sweep (their terminal
        ``status`` says which) and are *not* scheduled.  The sweep runs on
        every call, so expirations never pile up behind a saturated pool.
        """
        removed = self.sweep(now)
        admitted: List[ServeRequest] = []
        budget = min(free_slots, self.max_prefills_per_step)
        while (budget > 0 and self._queue
               and self._queue[0].arrival_s <= now):
            head = self._pop_at(0)
            head.admitted_s = now
            head.status = RequestStatus.RUNNING
            admitted.append(head)
            budget -= 1
        return admitted, removed


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

def poisson_arrivals(
    n: int, rate: float, *, seed: int = 0, start: float = 0.0
) -> np.ndarray:
    """n arrival times from a Poisson process at `rate` req/s.

    ``rate <= 0`` means all requests arrive at `start` (closed batch)."""
    if rate <= 0:
        return np.full(n, start)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return start + np.cumsum(gaps) - gaps[0]  # first request arrives at start


def trace_arrivals(times: Sequence[float]) -> np.ndarray:
    """Replay explicit arrival timestamps (sorted)."""
    return np.sort(np.asarray(times, np.float64))


def assign_arrivals(
    requests: Sequence[ServeRequest], times: np.ndarray
) -> List[ServeRequest]:
    """Stamp one arrival time per request (in order).  Returns the list;
    raises ValueError on a length mismatch."""
    if len(requests) != len(times):
        raise ValueError("one arrival time per request")
    for r, t in zip(requests, times):
        r.arrival_s = float(t)
    return list(requests)
