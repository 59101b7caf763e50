"""Continuous-batching engine: a fixed-shape decode step over a slot pool
(port of ``repro.serve.continuous``).

The decode batch never drains: one single-token step runs over all
``n_slots`` slots every iteration, and between steps finished requests are
evicted and queued ones prefilled into the freed slots.  The decode step's
shapes are fixed at (n_slots, 1); prefill runs at each prompt's exact
length, as in the reference.  The step reads one thing back to the host,
its sampled tokens; per-slot device state is uploaded only after slot
churn, and sampling draws from the engine's own seeded ``torch.Generator``
on the device (the reference folds the step number into a key).

Per-slot sampling parameters ride in (B,) arrays through
``sampling.sample_tokens``; per-slot termination (EOS / stop tokens /
max_new_tokens) is checked on the host between steps.

The engine's clock is wall time plus a fast-forward offset: when all slots
are idle and the next arrival is in the future, the clock jumps there — so a
simulated Poisson trace runs at full speed while latencies stay consistent.

Reliability layer (the serving twin of the training fault-tolerance stack):

* **admission control / load shedding** lives in the scheduler (bounded
  queue + eager expiration sweeps); the engine turns every removal into a
  typed terminal state and telemetry event;
* **per-request timeouts** — a running request past its ``timeout_s``
  latency budget is evicted at the next step boundary (the same granularity
  training uses for preemption), freeing its slot immediately;
* **stall watchdog** — a decode step blowing past ``stall_slo_s`` flips the
  engine into degraded mode: new admissions get their ``max_new_tokens``
  capped and a ``serve_degraded`` event fires; sustained healthy steps
  recover;
* **transient-failure retries** — a :class:`~repro_torch.serve.faults.
  ServeFaultInjector` (or a real detector) reports a non-finite sample or
  corrupted slot; the slot is freed (or quarantined for a cool-down), the
  request requeued with a bounded retry/backoff budget, and exhausted
  budgets surface as ``FAILED`` — never a silent drop;
* **graceful drain** — ``should_drain`` (e.g. a SIGTERM flag) stops
  admissions, sheds the queue, lets in-flight work finish within
  ``drain_grace_s`` and sheds the rest at expiry.

Every submitted request ends in exactly one terminal
:class:`~repro_torch.serve.scheduler.RequestStatus`; ``generate`` asserts the
four terminal counts are disjoint and sum to the submitted total.

On a mesh (``shard_ctx=ShardCtx(mesh)``, one engine a rank, as the
reference's one ``ContinuousEngine`` under ``use_sharding``) each rank
holds its parameter blocks (gathered over the data-parallel ranks once a
``generate``, as the static Engine gathers them once a batch) and its
block of the slot pool (``kv_pool.KVPool``: its rows of slots, its heads
and ``inner`` slice, under ``cache_seq`` its block of positions, the index
and host mirror whole).  Every data rank prefills each admission at batch
1 on its heads; a decode step runs the rank's rows, and the (n_slots, V)
logits are gathered over ``model`` and the data ranks, from which every
rank samples with the same seeded generator.  Every decision is made alike
on every rank because every host reading it rests on is agreed
(``collectives.agree_clock`` over the mesh's host group): each read of the
clock is rank 0's, the drain poll is any rank's flag, and the watchdog
takes rank 0's step time, so timestamps, timeouts, deadline sweeps,
degraded mode, terminal states and ``serving_stats`` are identical on
every rank.  The fault injector, quarantines and retry backoff key on
request ids and step numbers, which every rank shares.  Only rank 0's
``EventLog`` is written: another rank keeps its events in memory
(``telemetry.events``, for a check against rank 0's) where it was given an
enabled log, else nothing.

Determinism caveat: greedy outputs match the static ``Engine`` token-for-token
on the dense family where the matrix products give the same bits at every
batch size (the CPU).  On the card cuBLAS may pick another kernel for
another M, so two sequences can part where a top-2 logit margin is within
rounding (``chip_smoke.py`` phase 10 holds that to a tolerance).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve.engine import RankParams, gather_logits, params_device
from repro_torch.serve.faults import ServeFaultInjector
from repro_torch.serve.kv_pool import KVPool, reset_inactive
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import (
    TERMINAL_STATUSES,
    FCFSScheduler,
    RequestStatus,
    ServeRequest,
)
from repro_torch.sharding.collectives import agree_clock
from repro_torch.sharding.context import ShardCtx, use_sharding
from repro_torch.telemetry import EventLog

TokenCallback = Callable[[ServeRequest, int], None]


def make_pool_prefill(model: Model, max_len: int):
    """(params, tokens(1, S)) → (last-token logits (1, V), batch-1 cache).

    The cache is built at the pool's max_len so insertion into the pool is a
    single fixed-shape slot copy per leaf.  (The reference's pool calls as
    functions; the engine runs its own, ``ContinuousEngine._prefill`` and
    ``_decode``, which take a rank's block on a mesh.)
    """

    def prefill(params, tokens):
        cache = model.make_cache(1, max_len, tokens.device)
        logits, cache = model.prefill(params, {"tokens": tokens}, cache)
        return logits[:, -1], cache

    return prefill


def make_pool_decode_step(model: Model, *, greedy: bool = False):
    """One continuous-batching step over every slot.

    tokens/positions/temps/top_k are (B,) per-slot device tensors; `active`
    masks empty slots — their sampled token is forced to 0, and their cache
    index and position are clamped back to 0 so idle slots never advance.
    All per-slot tensors live on device between steps (the engine only
    uploads them after slot churn), and the step draws from ``gen``, a
    generator on the device, so the hot loop reads nothing back.

    ``greedy=True`` is the argmax-only variant (no draw / top-k sort), as
    the engine's step takes whenever every active slot has temperature 0.
    """

    def step(params, cache, tokens, positions, active, temps, top_k, gen):
        logits, cache = model.decode(
            params, {"tokens": tokens[:, None]}, cache, positions[:, None]
        )
        last = logits[:, -1]
        if greedy:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            nxt = sample_tokens(gen, last, temps, top_k)
        nxt = torch.where(active, nxt, 0)
        cache = reset_inactive(cache, active)
        new_pos = torch.where(active, positions + 1, 0)
        return nxt, new_pos, cache

    return step


class ContinuousEngine:
    """Slot-pool generation engine with mid-decode admission.

    Args: ``n_slots`` bounds the concurrent decode batch; ``max_len`` the
    per-slot cache; ``scheduler`` defaults to FCFS (pass one with
    ``max_queue``/``max_queue_tokens`` for admission control).  Reliability
    knobs: ``faults`` (deterministic :class:`ServeFaultInjector` harness),
    ``max_retries`` / ``retry_backoff_s`` (transient-failure budget),
    ``quarantine_steps`` (decode steps a corrupted slot sits out),
    ``stall_slo_s`` (per-step SLO arming the stall watchdog),
    ``degrade_max_new_tokens`` (admission cap while degraded) and
    ``degrade_recovery_steps`` (healthy steps before recovery).

    Use ``submit`` + ``generate`` (or just ``generate(requests)``).
    Invariant: the decode step shape is pinned to (n_slots, 1) for the
    engine's lifetime, on the device ``params`` live on.

    ``shard_ctx``: this rank's engine over its mesh (see the module
    docstring); ``params`` are then the whole tree or this rank's blocks of
    it.  A mesh of more than one rank needs its host group
    (``init_distributed``, or ``launch.mesh.run_plain_mesh`` for ranks as
    threads), over which the ranks agree.  ``agreements`` and
    ``agreement_s`` count the last ``generate``'s agreed readings and their
    host seconds (0 on one process), ``iterations`` its loop iterations.
    """

    def __init__(
        self,
        model: Model,
        params,
        *,
        n_slots: int = 8,
        max_len: int = 512,
        seed: int = 0,
        scheduler: Optional[FCFSScheduler] = None,
        telemetry: Optional[EventLog] = None,
        faults: Optional[ServeFaultInjector] = None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.0,
        quarantine_steps: int = 8,
        stall_slo_s: Optional[float] = None,
        degrade_max_new_tokens: int = 8,
        degrade_recovery_steps: int = 16,
        shard_ctx: Optional[ShardCtx] = None,
    ):
        self.shard_ctx = shard_ctx
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = params_device(params)
        self._rank: Optional[RankParams] = None   # this rank's blocks on a mesh
        self._host = None   # the group the ranks agree over (None: one process)
        self._rank_log = False   # telemetry is another rank's log, kept in memory
        pool_ctx = None
        if shard_ctx is not None:
            mesh = shard_ctx.mesh
            if mesh.size > 1 and mesh.host_group is None:
                raise ValueError("ContinuousEngine(shard_ctx=) over more than one rank needs "
                                 "the mesh's host group (init_distributed), over which the "
                                 "ranks agree on one clock, one drain flag and one writer")
            self._rank = RankParams(model, params, shard_ctx)
            params = self._rank.blocks
            pool_ctx = ShardCtx(mesh, shard_ctx.act_rules, self._rank.specs)
            self._host = mesh.host_group if mesh.size > 1 else None
            if mesh.rank != 0:   # one writer: another rank's events stay in memory
                enabled = telemetry is not None and telemetry.enabled
                telemetry = EventLog.memory() if enabled else None
                self._rank_log = enabled
        self.params = params
        self._call = params   # the parameters calls compute with (gathered on a mesh)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler = scheduler or FCFSScheduler()
        # telemetry: per-request lifecycle + per-generate aggregate counters
        # through the unified EventLog; null sink (no-op) by default
        self.telemetry = telemetry if telemetry is not None else EventLog()
        self.faults = faults
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.quarantine_steps = quarantine_steps
        self.stall_slo_s = stall_slo_s
        self.degrade_max_new_tokens = degrade_max_new_tokens
        self.degrade_recovery_steps = degrade_recovery_steps
        self.pool = KVPool(model, n_slots, max_len, self.device, shard_ctx=pool_ctx)
        # per-slot host mirrors; device copies are refreshed lazily (only
        # after slot churn) so steady-state steps upload nothing
        self._slot_req: Dict[int, ServeRequest] = {}
        self._tokens = np.zeros(n_slots, np.int32)
        self._temps = np.zeros(n_slots, np.float32)
        self._top_k = np.zeros(n_slots, np.int32)
        self._dev: Optional[tuple] = None  # (tokens, positions, active, temps, top_k)
        # reliability bookkeeping
        self._roster: List[ServeRequest] = []   # every submission since
        #                                         the last generate() drain
        self._quarantined: Dict[int, int] = {}  # slot -> release step
        self._degraded = False
        self._healthy_steps = 0
        self._run_steps = 0        # decode steps this generate (fault keying)
        self._n_retries = 0
        self._n_quarantines = 0
        self.agreements = 0
        self.agreement_s = 0.0
        self.iterations = 0

    # ---- internals -------------------------------------------------------
    def _agree(self, now: float, drain: bool = False, step_wall: float = 0.0) -> tuple:
        """``(now, drain, step_wall)`` as every rank reads them (rank 0's
        clock and step time, any rank's flag); on one process the
        arguments."""
        if self._host is None:
            return now, bool(drain), step_wall
        t = time.perf_counter()
        out = agree_clock(now, drain, step_wall, self._host)
        self.agreements += 1
        self.agreement_s += time.perf_counter() - t
        return out

    def _prefill(self, tokens: torch.Tensor):
        """The batch-1 prefill into one row of the pool's layout: the last
        position's logits (gathered over ``model`` on a mesh, where every
        data rank prefills on its heads) and the cache :meth:`KVPool.insert`
        takes."""
        pool = self.pool
        with use_sharding(pool.row_ctx):
            logits, cache = self.model.prefill(self._call, {"tokens": tokens}, pool.row_cache())
            return gather_logits(logits[:, -1], pool.row_ctx, self.model.cfg.vocab_size), cache

    def _decode(self, greedy: bool, tokens, positions, active, temps, top_k):
        """One step over every slot: the model over this rank's rows of the
        pool (every row on one process), the (n_slots, V) logits gathered on
        a mesh, every rank sampling them alike, the pool's index moved on.
        Returns the (n_slots,) tokens and positions, both forced to 0 on
        empty slots, so idle slots never advance."""
        pool = self.pool
        start, n = pool.rows
        with use_sharding(pool.ctx):
            logits, _ = self.model.decode(self._call, {"tokens": tokens[start:start + n, None]},
                                          pool.decode_view(), positions[start:start + n, None])
            last = gather_logits(logits[:, -1], pool.ctx, self.model.cfg.vocab_size)
        nxt = (torch.argmax(last, dim=-1).to(torch.int32) if greedy
               else sample_tokens(self.gen, last, temps, top_k))
        pool.advance(active)
        return torch.where(active, nxt, 0), torch.where(active, positions + 1, 0)

    def _device_state(self) -> tuple:
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.array(a)).to(self.device, non_blocking=True)
                for a in (self._tokens, self.pool.lengths, self.pool.active_mask,
                          self._temps, self._top_k)
            )
        return self._dev

    def _finished(self, req: ServeRequest, tok: int) -> bool:
        if req.eos_token is not None and tok == req.eos_token:
            return True
        return len(req.out_tokens) >= req.max_new_tokens

    def _emit_terminal(self, req: ServeRequest) -> None:
        """One ``serve_request`` event per terminal request — the lifecycle
        record the RunReport folds."""
        fields = dict(
            rid=req.rid, status=req.status.value, dropped=req.dropped,
            prompt_len=len(req.prompt), new_tokens=len(req.out_tokens),
            arrival_s=req.born_s, attempts=req.attempts,
        )
        if req.shed_reason is not None:
            fields["reason"] = req.shed_reason
        if req.fail_reason is not None:
            fields["reason"] = req.fail_reason
        if math.isfinite(req.first_token_s):
            fields["ttft_s"] = req.ttft_s
        if math.isfinite(req.finish_s) and req.status is RequestStatus.COMPLETED:
            fields["latency_s"] = req.latency_s
        self.telemetry.emit("serve_request", **fields)

    def _terminal_removed(self, req: ServeRequest) -> None:
        """Emit the typed lifecycle event for a request the scheduler swept
        (shed or timed out in the queue) plus its terminal record."""
        if req.status is RequestStatus.TIMED_OUT:
            self.telemetry.emit("serve_timeout", rid=req.rid, where="queue")
        else:
            self.telemetry.emit("serve_shed", rid=req.rid,
                                reason=req.shed_reason or "unknown")
        self._emit_terminal(req)

    def _finish(self, slot: int, now: float) -> None:
        req = self._slot_req.pop(slot)
        req.finish_s = now
        req.status = RequestStatus.COMPLETED
        self.pool.evict(slot)
        self._dev = None  # slot churn: device per-slot state is stale
        self._emit_terminal(req)

    def _timeout_slot(self, slot: int, now: float) -> None:
        """A running request blew its latency budget: free the slot now."""
        req = self._slot_req.pop(slot)
        req.finish_s = now
        req.status = RequestStatus.TIMED_OUT
        self.pool.evict(slot)
        self._dev = None
        self.telemetry.emit("serve_timeout", rid=req.rid, where="decode",
                            new_tokens=len(req.out_tokens))
        self._emit_terminal(req)

    def _shed_slot(self, slot: int, now: float, reason: str) -> None:
        req = self._slot_req.pop(slot)
        req.finish_s = now
        req.status = RequestStatus.SHED
        req.shed_reason = reason
        self.pool.evict(slot)
        self._dev = None
        self.telemetry.emit("serve_shed", rid=req.rid, reason=reason)
        self._emit_terminal(req)

    def _transient_failure(self, req: ServeRequest, slot: int, kind: str,
                           now: float) -> None:
        """A detected transient fault (non-finite sample / corrupted slot):
        quarantine or free the slot, then retry or fail the request."""
        self._slot_req.pop(slot, None)
        if kind == "slot_corrupt":
            self.pool.quarantine(slot)
            self._quarantined[slot] = self._run_steps + self.quarantine_steps
            self._n_quarantines += 1
            self.telemetry.emit("serve_quarantine", slot=slot, rid=req.rid,
                                release_step=self._quarantined[slot])
        else:
            self.pool.evict(slot)
        self._dev = None
        if req.attempts > self.max_retries:
            req.status = RequestStatus.FAILED
            req.fail_reason = kind
            req.finish_s = now
            self._emit_terminal(req)
            return
        self._n_retries += 1
        backoff = self.retry_backoff_s * req.attempts
        self.telemetry.emit("serve_retry", rid=req.rid,
                            attempt=req.attempts, reason=kind,
                            backoff_s=backoff)
        req.out_tokens = []
        req.admitted_s = math.nan
        req.first_token_s = math.nan
        req.status = RequestStatus.PENDING
        req.arrival_s = now + backoff
        self.scheduler.submit(req)

    def _admit_one(
        self, req: ServeRequest, clock: Callable[[], float],
        on_token: Optional[TokenCallback],
    ) -> None:
        req.attempts += 1
        if self._degraded:
            # degraded mode: cap the generation budget of new admissions so
            # a stalling backend sheds decode work before it sheds requests
            req.max_new_tokens = max(
                1, min(req.max_new_tokens, self.degrade_max_new_tokens))
        slot = self.pool.acquire()
        assert slot is not None, "admit() respects free-slot budget"
        prompt = torch.from_numpy(np.asarray(req.prompt, np.int32)[None].copy()).to(
            self.device, non_blocking=True)
        last, cache1 = self._prefill(prompt)
        tok = int(
            sample_tokens(
                self.gen, last,
                torch.full((1,), req.temperature, dtype=torch.float32, device=self.device),
                torch.full((1,), req.top_k, dtype=torch.int32, device=self.device),
            )[0]
        )
        self.pool.insert(cache1, slot, len(req.prompt))
        self._dev = None  # slot churn: device per-slot state is stale
        # fault-injection point: the first sample of this attempt.  A real
        # detector would check np.isnan(logits) / cache health here.
        kind = (self.faults.fire_request(req.rid)
                if self.faults is not None else None)
        if kind is not None:
            self._transient_failure(req, slot, kind, clock())
            return
        req.out_tokens.append(tok)
        # the int() above blocked on the prefill: stamp after, not before
        req.first_token_s = clock()
        if on_token is not None:
            on_token(req, tok)
        if self._finished(req, tok):
            self._slot_req[slot] = req
            self._finish(slot, req.first_token_s)
            return
        self._slot_req[slot] = req
        self._tokens[slot] = tok
        self._temps[slot] = req.temperature
        self._top_k[slot] = req.top_k

    def _release_quarantined(self, *, force: bool = False) -> None:
        for slot, due in list(self._quarantined.items()):
            if force or self._run_steps >= due:
                self.pool.release(slot)
                del self._quarantined[slot]

    def _watchdog(self, step_wall_s: float) -> None:
        """Stall watchdog: one slow decode step degrades admissions; a
        sustained healthy streak recovers."""
        if self.stall_slo_s is None:
            return
        if step_wall_s > self.stall_slo_s:
            self._healthy_steps = 0
            if not self._degraded:
                self._degraded = True
                self.telemetry.emit(
                    "serve_degraded", active=True, step_s=step_wall_s,
                    slo_s=self.stall_slo_s,
                    max_new_tokens_cap=self.degrade_max_new_tokens)
        elif self._degraded:
            self._healthy_steps += 1
            if self._healthy_steps >= self.degrade_recovery_steps:
                self._degraded = False
                self._healthy_steps = 0
                self.telemetry.emit("serve_degraded", active=False,
                                    step_s=step_wall_s,
                                    slo_s=self.stall_slo_s)

    def _step(
        self, clock: Callable[[], float], on_token: Optional[TokenCallback]
    ) -> None:
        active = self.pool.active_mask.copy()
        tokens_d, pos_d, active_d, temps_d, topk_d = self._device_state()
        greedy = float(self._temps[active].max(initial=0.0)) <= 0.0
        toks_d, pos_d = self._decode(greedy, tokens_d, pos_d, active_d, temps_d, topk_d)
        toks = toks_d.cpu().numpy()  # the loop's one device→host sync
        now = clock()  # after the sync: timestamps include the step's work
        self.pool.lengths[active] += 1
        self._tokens[active] = toks[active]
        # feed the sampled tokens straight back; invalidated on churn below
        self._dev = (toks_d, pos_d, active_d, temps_d, topk_d)
        for slot in list(self._slot_req):
            req = self._slot_req[slot]
            tok = int(toks[slot])
            req.out_tokens.append(tok)
            if on_token is not None:
                on_token(req, tok)
            if self._finished(req, tok):
                self._finish(slot, now)

    # ---- public API ------------------------------------------------------
    def submit(self, req: ServeRequest) -> ServeRequest:
        """Validate and enqueue a request (returns it for chaining).

        Invariant: admission is deferred to ``generate``'s loop — a
        submitted request holds no slot until the scheduler admits it, and
        overload rejection happens at *arrival* (the scheduler's bounded-
        queue sweep), so check ``req.status`` after ``generate``.  Raises
        ValueError if the prompt is empty, the prompt+budget cannot fit the
        pool's ``max_len``, or the sampling params are malformed
        (non-finite/negative temperature, negative top_k) — caught here so
        a bad request fails loudly at submit instead of poisoning the
        batched sampling arrays mid-decode.
        """
        if len(req.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "always samples one token)")
        if not math.isfinite(req.temperature) or req.temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {req.temperature}"
            )
        if req.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {req.top_k}")
        # the last sampled token is returned but never written to the cache
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache positions but pool max_len is "
                f"{self.max_len}"
            )
        if math.isnan(req.submitted_s):
            req.submitted_s = req.arrival_s
        self._roster.append(req)
        return self.scheduler.submit(req)

    @torch.inference_mode()
    def generate(
        self,
        requests: Optional[Sequence[ServeRequest]] = None,
        *,
        on_token: Optional[TokenCallback] = None,
        should_drain: Optional[Callable[[], bool]] = None,
        drain_grace_s: float = 5.0,
    ) -> List[ServeRequest]:
        """Run until the queue and all slots drain.

        Args: ``requests`` to submit up front (may be None if ``submit`` was
        called directly); ``on_token(req, tok)`` streams every sampled
        token; ``should_drain`` is polled once per loop — when it first
        returns True the engine stops admissions, sheds the queue, and
        gives in-flight requests ``drain_grace_s`` seconds to finish before
        shedding them too (SIGTERM wiring lives in ``launch/serve.py``).
        Returns the submitted requests, completed in place — check
        ``.status`` for the terminal state (``.dropped`` still covers the
        shed/timed-out union).  Invariants: wall-clock latencies stay
        consistent even when the virtual clock fast-forwards across idle
        gaps between arrivals, and every request submitted since the last
        ``generate`` ends in exactly one terminal state (asserted).  On a
        mesh every rank calls it with the same requests, and each rank's
        ``should_drain`` is polled alike: the drain starts on every rank
        once any rank's returns True.
        """
        submitted = [self.submit(r) for r in requests] if requests else []
        t0 = time.perf_counter()
        offset = 0.0  # virtual fast-forward while idle
        if self._rank_log:
            self.telemetry.events.clear()   # this generate's events alone
        telem = self.telemetry.enabled
        # host-side counters (ints per loop iteration — no device syncs)
        queue_samples: List[int] = []
        occ_samples: List[int] = []
        n_steps = 0
        self._run_steps = 0
        self._n_retries = 0
        self._n_quarantines = 0
        self.agreements, self.agreement_s, self.iterations = 0, 0.0, 0
        draining = False
        drain_deadline = math.inf
        # the last decode step's wall seconds, until the next agreed reading
        # hands the watchdog (every rank) rank 0's
        step_wall: Optional[float] = None

        def raw() -> float:
            return time.perf_counter() - t0 + offset

        def clock() -> float:
            return self._agree(raw())[0]

        if self._rank is not None:
            self._call = self._rank.call()
        while self.scheduler.has_pending() or self._slot_req:
            self.iterations += 1
            polled = (not draining and should_drain is not None and should_drain())
            now, drain, wall = self._agree(raw(), polled, step_wall or 0.0)
            if step_wall is not None:
                self._watchdog(wall)
                step_wall = None
            if not draining and drain:
                draining = True
                drain_deadline = now + max(0.0, drain_grace_s)
                shed = self.scheduler.drain(now)
                self.telemetry.emit(
                    "serve_drain", queued=len(shed),
                    in_flight=len(self._slot_req),
                    grace_s=max(0.0, drain_grace_s))
                for req in shed:
                    self._terminal_removed(req)
            if draining:
                # retries resubmitted after the drain started are shed
                for req in self.scheduler.drain(now):
                    self._terminal_removed(req)
                if now >= drain_deadline and self._slot_req:
                    for slot in list(self._slot_req):
                        self._shed_slot(slot, now, "drain")
                admitted = []
            else:
                # running requests past their latency budget free their
                # slot before this round's admissions claim it
                for slot in list(self._slot_req):
                    req = self._slot_req[slot]
                    if (req.timeout_s is not None
                            and now - req.born_s > req.timeout_s):
                        self._timeout_slot(slot, now)
                self._release_quarantined()
                admitted, removed = self.scheduler.admit(
                    now, self.pool.n_free)
                for req in removed:
                    self._terminal_removed(req)
            for req in admitted:
                self._admit_one(req, clock, on_token)
            if telem:
                queue_samples.append(self.scheduler.queue_depth(now))
                occ_samples.append(
                    self.n_slots - self.pool.n_free
                    - len(self._quarantined))
            if not self._slot_req:
                if self._quarantined and self.scheduler.has_pending():
                    # no decode steps will run while the pool idles, so
                    # a quarantine can never expire on its own: release
                    # early rather than deadlock the queue
                    self._release_quarantined(force=True)
                    continue
                nxt = self.scheduler.next_arrival()
                if nxt is None:
                    break
                offset += max(0.0, nxt - clock())
                continue
            t_step = time.perf_counter()
            if self.faults is not None:
                stall = self.faults.stall_s(self._run_steps)
                if stall > 0.0:
                    time.sleep(stall)
            self._step(clock, on_token)
            step_wall = time.perf_counter() - t_step
            self._run_steps += 1
            n_steps += 1
        if step_wall is not None:
            self._watchdog(self._agree(raw(), False, step_wall)[2])
        self._call = self.params
        self._release_quarantined(force=True)

        # exact, disjoint terminal accounting over everything submitted
        # since the last generate (direct submit() calls included)
        roster, self._roster = self._roster, []
        counts = {s: 0 for s in TERMINAL_STATUSES}
        for r in roster:
            if r.status not in counts:
                raise RuntimeError(
                    f"request {r.rid} left generate() non-terminal: "
                    f"{r.status}")
            counts[r.status] += 1
        assert sum(counts.values()) == len(roster)

        if telem:
            stats = serving_stats(roster)
            stats.update(
                decode_steps=n_steps,
                submitted=len(roster),
                retries=self._n_retries,
                quarantines=self._n_quarantines,
                drained=draining,
                degraded=self._degraded,
                queue_depth_mean=float(np.mean(queue_samples)) if queue_samples else 0.0,
                queue_depth_max=int(max(queue_samples, default=0)),
                slot_occupancy_mean=(
                    float(np.mean(occ_samples)) / self.n_slots
                    if occ_samples else 0.0
                ),
                n_slots=self.n_slots,
                device=(torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else self.device.type),
            )
            self.telemetry.emit("serve_stats", **stats)
        return submitted


def serving_stats(requests: Sequence[ServeRequest]) -> Dict[str, float]:
    """Aggregate throughput/latency over a completed request set.

    Returns the disjoint terminal counts (``completed`` / ``shed`` /
    ``timed_out`` / ``failed``, summing to ``submitted``), request/token
    counts, tokens/s over the busy window, and p50/p99 latency + TTFT.
    Invariants: only completed requests enter the latency percentiles, and
    the legacy ``dropped`` counter equals ``shed + timed_out`` exactly.
    """
    by_status = {s: 0 for s in TERMINAL_STATUSES}
    for r in requests:
        if r.status in by_status:
            by_status[r.status] += 1
    counts = {
        "submitted": len(requests),
        "completed": by_status[RequestStatus.COMPLETED],
        "shed": by_status[RequestStatus.SHED],
        "timed_out": by_status[RequestStatus.TIMED_OUT],
        "failed": by_status[RequestStatus.FAILED],
        "dropped": (by_status[RequestStatus.SHED]
                    + by_status[RequestStatus.TIMED_OUT]),
    }
    done = [r for r in requests
            if r.status is RequestStatus.COMPLETED and r.out_tokens]
    if not done:
        return {"requests": 0, **counts}
    new_tokens = sum(len(r.out_tokens) for r in done)
    start = min(r.born_s for r in done)
    end = max(r.finish_s for r in done)
    lat = np.array([r.latency_s for r in done])
    ttft = np.array([r.ttft_s for r in done])
    wall = max(end - start, 1e-9)
    return {
        "requests": len(done),
        **counts,
        "new_tokens": new_tokens,
        "wall_s": wall,
        "tokens_per_s": new_tokens / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
    }
