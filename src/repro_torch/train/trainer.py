"""Trainer: the step loop with a metrics history, checkpoints, resume, the
non-finite guard's bookkeeping and mixed-batch stages (port of
``repro.train.trainer.Trainer``).

Across a stage switch the optimizer moments and their counters carry over
while the schedule's counter restarts at zero, so stage 2 re-warms up: the
§4.1 procedure.  Every checkpoint persists the full ``TrainState`` (params,
the optimizer state with its counters, ``step`` and ``skipped``) in the
JAX package's format, for any optimizer; ``resume=True`` restores the latest complete one at
``fit`` start and fast-forwards the data, so the continuation is bit-exact
against a run that was never interrupted.  ``async_checkpoint=True`` routes
saves through :class:`~repro_torch.checkpoint.AsyncCheckpointer`.

Robustness, as in the reference: ``supervisor=`` arms the loss-spike
watchdog (one host transfer a step), which on a trip restores the last
validated checkpoint and fast-forwards the stream past the suspect batches
(``fit(..., data_factory=)``), and raises :class:`DivergenceError` past its
budget; ``preempt_grace=`` turns SIGTERM/SIGINT into a grace-window final
checkpoint and a clean stop.  ``telemetry=`` (an
:class:`~repro_torch.telemetry.EventLog`) receives the reference's events:
``run_start`` with the provenance, ``step`` and ``span`` per logged
interval (two syncs an interval), ``trust_ratios`` under
``tc.record_trust_ratios``, ``checkpoint``, ``resume``, ``rollback``,
``preempt``, ``stage_start`` and a ``run_end`` with its ``status``
(``ok``/``failed``/``preempted``/``diverged``) from a ``finally``.  With the
default null log the step loop adds no launch, sync or transfer.

``mesh=`` (a concrete mesh from
:func:`~repro_torch.launch.mesh.init_distributed`) makes the run FSDP over
the mesh's data-parallel ranks and tensor-parallel over its ``model``
ranks, as the reference's ``Trainer(mesh=)``: ``init`` draws every leaf
from the seed as a single process does and keeps this rank's block, ``fit``
takes this rank's rows of each global batch (:meth:`Trainer.batch_rows`,
which ``DataPipeline(rows=)`` takes: the same rows to the ``model`` ranks
of one data coordinate), the history, step log
and telemetry hold global values, and only rank 0 logs and writes.  A
checkpoint gathers each leaf over both axes and rank 0 writes the
single-process format, so a run restores on any mesh shape.

The supervisor and preemption run over the mesh as over one process, with
one verdict, one flag and one writer, agreed over the mesh's host group
(gloo, CPU tensors: no device launch or synchronisation): the supervisor's
trip reason is rank 0's, broadcast; the SIGTERM flag is the MAX over the
world, read once a step, so every rank stops on the same batch and enters
the grace save's gathers together; a rollback restores the step rank 0
picks (after draining its writer) on every rank, and only rank 0 removes
later checkpoints and re-points LATEST; a resume restores the step rank 0
picks.  Every rank raises :class:`DivergenceError` together.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    checkpoint_path,
    checkpoint_step,
    discard_checkpoints_after,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves_with_paths,
)
from repro_torch.checkpoint.io import tree_map_with_paths
from repro_torch.configs.base import TrainConfig
from repro_torch.core.mixed_batch import Stage
from repro_torch.data.pipeline import DataPipeline
from repro_torch.kernels.ops import FusedLambState
from repro_torch.models.api import Model
from repro_torch.optim.base import ScheduleState
from repro_torch.sharding import (
    Layout,
    dp_size,
    gather_tree,
    leaf_dims,
    rank_rows,
    shard_tree,
    train_state_shardings,
)
from repro_torch.sharding.collectives import (
    barrier,
    broadcast_int,
    gather_block,
    shard_block,
)
from repro_torch.telemetry import EventLog, SpanRecorder, TrustRecorder, run_provenance
from repro_torch.telemetry.trust import PER_LAYER_KEY
from repro_torch.train.preempt import PreemptionHandler
from repro_torch.train.step import GUARD_KEY, LOSS_KEY, TRUST_KEYS, TrainState, make_train_step
from repro_torch.train.supervisor import (
    TRIP_REASONS,
    DivergenceError,
    SupervisorConfig,
    TrainingSupervisor,
)

# the per-step metrics the history keeps, fetched together at a log step,
# and the extra loss terms' (MoE, MTP), kept where the loss reports them
HISTORY_KEYS = ("loss/total", "loss/ce", "accuracy", "tokens/supervised",
                "grad_norm", "update_norm")
TERM_KEYS = ("loss/moe_lb", "moe/drop_fraction", "loss/moe_z", "loss/mtp")


def _batch_examples(batch) -> int:
    """Examples in one step's batch: the leading dim of any leaf."""
    return int(next(iter(batch.values())).shape[0])


# the rank-0 verdicts a rollback broadcasts when it cannot restore
_PAST_BUDGET, _NO_SETUP, _NO_CHECKPOINT = -1, -2, -3


def _reset_schedule_counts(opt_state) -> None:
    """Zero every schedule counter in place (stage-2 re-warm-up): each
    ``ScheduleState.count`` of a transform chain, or the fused state's
    ``sched_count``.  The moments and their counters (``count``, the
    ``ScaleByAdamState`` counts) carry over."""
    if isinstance(opt_state, FusedLambState):
        opt_state.sched_count.zero_()
    elif isinstance(opt_state, ScheduleState):
        opt_state.count.zero_()
    elif isinstance(opt_state, tuple):
        for s in opt_state:
            _reset_schedule_counts(s)


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
        telemetry: Optional[EventLog] = None,
        supervisor: Optional[SupervisorConfig] = None,
        preempt_grace: Optional[float] = None,
        mesh=None,
        param_rules=None,
    ):
        self.model = model
        self.tc = train_cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self._dp = 1
        # flags and small integers agreed over the ranks (None: one process)
        self._host = None if mesh is None else mesh.host_group
        if mesh is not None:
            if mesh.abstract:
                raise ValueError("Trainer(mesh=) needs a concrete mesh (init_distributed)")
            if mesh.size > 1 and mesh.host_group is None:
                raise ValueError("Trainer(mesh=) over more than one rank needs the mesh's "
                                 "host group (init_distributed), over which the ranks "
                                 "agree on one verdict, one flag and one writer")
            self._dp = dp_size(mesh)
            if mesh.rank != 0:   # only rank 0 logs and writes
                log_fn, telemetry = (lambda s: None), None
        self._state_dims: Optional[Dict[str, Layout]] = None
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.async_checkpoint = async_checkpoint
        self.resume = resume
        self._checkpointer: Optional[AsyncCheckpointer] = None
        self._last_saved_step: Optional[int] = None
        # loss-spike watchdog: a fresh TrainingSupervisor per fit from this
        # config (rollback counts must not leak across fits)
        self.supervisor_cfg = supervisor
        # not None: a SIGTERM/SIGINT handler around the fit loop; the value
        # bounds (seconds) the final save's drain
        self.preempt_grace = preempt_grace
        self._skipped_seen = 0
        self._status = "ok"
        self.log_every = log_every
        self.log = log_fn
        # a null EventLog unless the caller wires a sink; everything below
        # guards on .enabled, so the default path adds no sync or transfer
        self.telemetry = telemetry if telemetry is not None else EventLog()
        sink = self.telemetry if self.telemetry.enabled else None
        self.spans = SpanRecorder(log=sink)
        self.trust_recorder = TrustRecorder(log=sink)
        self._run_started = False
        self.history: List[Dict[str, float]] = []
        self.examples_seen = 0
        self.param_rules = param_rules
        self._init_fn, self._step_fn = make_train_step(model, train_cfg, schedule, mesh=mesh,
                                                       param_rules=param_rules)
        self.state: Optional[TrainState] = None

    def init(self, seed: Optional[int] = None) -> TrainState:
        self.state = self._init_fn(self.tc.seed if seed is None else seed, self.device)
        return self.state

    # ------------------------------------------------------------------
    # the data-parallel split
    # ------------------------------------------------------------------
    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _examples(self, batch) -> int:
        """Examples of the global batch a step consumes (on a mesh the
        rank holds ``1/dp`` of its rows)."""
        return _batch_examples(batch) * self._dp

    def batch_rows(self, n: int):
        """The rows this rank keeps of an ``n``-row global batch: its block
        of each of the step's ``tc.grad_accum_steps`` micro-batches
        (``sharding.rank_rows``), so that its i-th micro-batch is its block
        of the reference's i-th; every row without a mesh.  Raises
        ``ValueError`` when the batch does not divide over the
        micro-batches and the data-parallel ranks.  ``DataPipeline(rows=)``
        takes it."""
        if self.mesh is None:
            return slice(None)
        return rank_rows(n, self.mesh, self.tc.grad_accum_steps)

    def _place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (numpy arrays or tensors), on
        the device (:meth:`batch_rows`)."""
        rows = self.batch_rows(_batch_examples(batch))
        return {k: torch.as_tensor(v)[rows].to(self.device) for k, v in batch.items()}

    def state_dims(self) -> Dict[str, Layout]:
        """``{path: layout}`` over the state's leaves: the dimensions a leaf
        is split along over the data-parallel ranks and over ``model``."""
        if self._state_dims is None:
            target = self.state if self.state is not None else self.init()
            self._state_dims = leaf_dims(
                train_state_shardings(self.model.defs, target, self.mesh, self.param_rules),
                self.mesh)
        return self._state_dims

    def gather_state(self) -> TrainState:
        """The whole state on every rank (this rank's own without a mesh)."""
        if self.mesh is None:
            return self.state
        return gather_tree(self.state, self.state_dims(), self.mesh)

    def place_state(self, state: TrainState) -> TrainState:
        """Install a whole state (as a single process holds it), keeping
        this rank's slice of every leaf."""
        if self.mesh is not None:
            if self.state is None:
                self.init()
            state = shard_tree(state, self.state_dims(), self.mesh)
        self.state = state
        return state

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _emit_run_start(self) -> None:
        if self._run_started or not self.telemetry.enabled:
            return
        self._run_started = True
        self.telemetry.emit(
            "run_start",
            provenance=run_provenance(device=self.device, mesh=self.mesh,
                                      configs=(self.model.cfg, self.tc)),
            arch=self.model.cfg.name, optimizer=self.tc.optimizer,
        )

    def _log_step(self, m: Dict[str, float], per_layer, step_s: float,
                  n_steps: int) -> None:
        """Emit the log-step telemetry: the step event and the trust records."""
        scalars = {k: v for k, v in m.items()
                   if k not in ("step", "examples_seen", "wall_s", "stage")}
        ev = dict(step=m["step"], examples_seen=m["examples_seen"],
                  wall_s=m["wall_s"], metrics=scalars)
        if "stage" in m:
            ev["stage"] = m["stage"]
        if n_steps:
            ev["step_time_s"] = step_s / n_steps
        self.telemetry.emit("step", **ev)
        if per_layer is not None:
            self.trust_recorder.record(m["step"], per_layer)

    def _emit_run_end(self, supervisor: Optional[TrainingSupervisor] = None) -> None:
        if not self.telemetry.enabled:
            return
        fields: Dict[str, Any] = {"status": self._status}
        if self.state is not None:
            try:
                fields["final_step"] = int(self.state.step)
                fields["skipped_steps"] = int(self.state.skipped)
            except RuntimeError:   # a failed CUDA launch fails every later read
                pass
        if self.history:
            fields["final_loss"] = float(self.history[-1].get(LOSS_KEY, float("nan")))
        if supervisor is not None:
            fields["rollbacks"] = supervisor.rollbacks
        self.telemetry.emit("run_end", **fields)

    # ------------------------------------------------------------------
    # checkpointing + resume
    # ------------------------------------------------------------------
    @property
    def checkpointer(self) -> AsyncCheckpointer:
        """Lazy double-buffered async writer (made on the first async save)."""
        if self._checkpointer is None:
            self._checkpointer = AsyncCheckpointer(self.checkpoint_dir,
                                                   telemetry=self.telemetry)
        return self._checkpointer

    def _save_checkpoint(self) -> None:
        """Persist the full TrainState.  A same-step re-save is dropped: with
        the guard on, skipped steps can put two cadence points (or cadence
        and preemption) on one ``state.step``; the state is the same and the
        write is not free."""
        step = int(self.state.step)
        if step == self._last_saved_step:
            return
        self._last_saved_step = step
        tree = self.state
        if self.mesh is not None:
            # every rank gathers each leaf in turn; rank 0 keeps a host copy
            dims, host = self.state_dims(), {}
            for path, x in tree_leaves_with_paths(self.state):
                whole = gather_block(x, dims.get(path, Layout()), self.mesh)
                if self.is_writer:
                    host[path] = whole.cpu()
            if not self.is_writer:
                return
            tree = tree_map_with_paths(lambda p, _: host[p], self.state)
        if self.async_checkpoint:
            self.checkpointer.save(step, tree)
            return
        t0 = time.perf_counter()
        path = save_checkpoint(self.checkpoint_dir, step, tree)
        self.telemetry.emit("checkpoint", step=step, path=path, mode="sync",
                            write_s=time.perf_counter() - t0)

    def _drain_checkpoints(self, timeout: Optional[float] = None) -> None:
        """Block until the in-flight async write (if any) is durable, so a
        returned ``fit`` implies every scheduled checkpoint is on disk.
        ``timeout`` bounds the wait (the preemption grace window)."""
        if self._checkpointer is not None:
            self._checkpointer.wait(timeout)

    def restore(self, path: Optional[str] = None) -> Optional[int]:
        """Restore the full TrainState from ``path`` (default: the latest
        complete checkpoint in ``checkpoint_dir``) onto this trainer's
        device: every leaf a new tensor read from disk.  Returns the
        restored step, or None when there is nothing to restore."""
        if path is None:
            path = latest_checkpoint(self.checkpoint_dir) if self.checkpoint_dir else None
        if path is None:
            return None
        target = self.state if self.state is not None else self.init()
        shard = None
        if self.mesh is not None:   # each rank reads every leaf and keeps its block
            dims, mesh = self.state_dims(), self.mesh
            shard = lambda p, x: shard_block(x, dims.get(p, Layout()), mesh)  # noqa: E731
        self.state = restore_checkpoint(path, target, shard=shard)
        step = checkpoint_step(path)
        self.telemetry.emit("resume", step=step, path=path)
        self.log(f"resumed step {step} from {path}")
        return step

    def _maybe_resume(self, data, steps: int) -> int:
        """With ``resume=True``, restore the latest checkpoint and return the
        batch ordinal to continue from (0 when none exists), fast-forwarding
        ``data`` past the ``step + skipped`` batches already consumed.  On a
        mesh rank 0 picks the checkpoint and every rank restores its step,
        so no rank lists a directory that rank 0's writer is changing."""
        if not self.resume:
            return 0
        if self.mesh is None:
            step = self.restore()
        else:
            found = -1
            if self.is_writer and self.checkpoint_dir:
                path = latest_checkpoint(self.checkpoint_dir)
                found = -1 if path is None else checkpoint_step(path)
            found = broadcast_int(found, self._host)
            step = (None if found < 0 else
                    self.restore(checkpoint_path(self.checkpoint_dir, found)))
        if step is None:
            return 0
        self._last_saved_step = step
        start = min(step + int(self.state.skipped), steps)
        for _ in range(start):
            self.examples_seen += self._examples(next(data))
        return start

    # ------------------------------------------------------------------
    def _fetch(self, scalars, vectors=()):
        """One device-to-host transfer (which also waits for the device):
        the fp32 ``scalars``, both int32 counters and the flattened
        ``vectors``.  The counters ride as their bits (a view, no cast
        kernel) and are read back as int32.  Returns ``(scalar values, step,
        skipped, vector values)``, the last one flat tensor."""
        n = len(scalars)
        values = torch.stack([x.to(torch.float32) for x in scalars]
                             + [self.state.step.view(torch.float32),
                                self.state.skipped.view(torch.float32)])
        if vectors:
            values = torch.cat([values] + [x.to(torch.float32).reshape(-1) for x in vectors])
        host = values.cpu()
        step, skipped = host[n:n + 2].view(torch.int32).tolist()
        return host[:n].tolist(), step, skipped, host[n + 2:]

    def _history_row(self, metrics, extra: Dict[str, float], t0: float):
        """One history row and the host copy of the per-layer records (None
        without telemetry or records), in one transfer, so ``wall_s``
        counts finished work."""
        keys = (HISTORY_KEYS + tuple(k for k in TERM_KEYS if k in metrics)
                + ((GUARD_KEY,) if self.tc.skip_nonfinite else ())
                + (TRUST_KEYS if self.tc.log_trust_ratios else ()))
        records = metrics.get(PER_LAYER_KEY) if self.telemetry.enabled else None
        leaves = tree_leaves_with_paths(records) if records is not None else []
        values, step, skipped, flat = self._fetch([metrics[k] for k in keys],
                                                  [x for _, x in leaves])
        per_layer = None
        if records is not None:
            at, host = 0, {}
            for path, x in leaves:
                host[path] = flat[at:at + x.numel()].reshape(x.shape).numpy()
                at += x.numel()
            per_layer = tree_map_with_paths(lambda path, _: host[path], records)
        m = dict(zip(keys, values))
        m["step"] = step
        if self.tc.skip_nonfinite:
            m["skipped_total"] = skipped
        m["examples_seen"] = self.examples_seen
        m["wall_s"] = time.perf_counter() - t0
        m.update(extra)
        self.history.append(m)
        return m, per_layer

    def _observe(self, metrics):
        """The supervisor's one host transfer a step: ``(loss, step,
        skipped)``."""
        loss = metrics.get(LOSS_KEY)
        if loss is None:
            loss = torch.full((), float("nan"), device=self.state.step.device)
        (loss,), step, skipped, _ = self._fetch([loss])
        return loss, step, skipped

    # ------------------------------------------------------------------
    def fit(self, data, steps: int, *,
            data_factory: Optional[Callable[[], Any]] = None) -> List[Dict[str, float]]:
        """Run the step loop to ``steps`` batches (counting those a resume
        skips).  Metrics stay on the device between log steps.

        ``data_factory`` (a zero-arg callable rebuilding the deterministic
        iterator ``data`` came from) enables the supervisor's rollback: on a
        trip the Trainer restores the last validated checkpoint, rebuilds
        the stream and fast-forwards *past* the suspect batches.  A
        ``run_end`` event with the run's status is emitted from a
        ``finally``, so a crashed run still closes its event log.
        """
        if data is None and data_factory is not None:
            data = data_factory()
        start = self._maybe_resume(data, steps)
        if self.state is None:
            self.init()
        self._emit_run_start()
        supervisor = (TrainingSupervisor(self.supervisor_cfg)
                      if self.supervisor_cfg is not None else None)
        self._status = "ok"
        try:
            with PreemptionHandler(enabled=self.preempt_grace is not None) as preempt:
                self._fit_loop(data, steps, start, supervisor, preempt, data_factory)
            self._drain_checkpoints()
        except BaseException as e:
            self._status = "diverged" if isinstance(e, DivergenceError) else "failed"
            raise
        finally:
            self._emit_run_end(supervisor)
        return self.history

    def _fit_loop(self, data, steps: int, start: int,
                  supervisor: Optional[TrainingSupervisor],
                  preempt: PreemptionHandler,
                  data_factory: Optional[Callable[[], Any]]) -> None:
        telem = self.telemetry.enabled
        guard_on = self.tc.skip_nonfinite
        t0 = time.perf_counter()
        since_log = 0
        # the skip count seen so far feeds the supervisor and the
        # nonfinite_step events only: no sync without either
        watch = guard_on and (telem or supervisor is not None)
        self._skipped_seen = int(self.state.skipped) if watch else 0
        # i is the batch ordinal, not state.step: a guard-skipped step
        # consumes a batch without advancing step
        i = start
        while i < steps:
            if telem and since_log == 0:
                # span boundary: drain earlier work so the interval times
                # only its own steps
                self.spans.start("step", sync=self.state)
            batch = next(data)
            self.examples_seen += self._examples(batch)
            self.state, metrics = self._step_fn(self.state, batch)
            since_log += 1
            if supervisor is not None:
                loss, step_now, skipped_now = self._observe(metrics)
                delta = skipped_now - self._skipped_seen
                self._skipped_seen = skipped_now
                if delta > 0:
                    self.telemetry.emit(
                        "nonfinite_step", step=step_now, count=delta, total=skipped_now,
                        consecutive=supervisor.consecutive_skips + 1)
                    self.log(f"non-finite step skipped at batch {i} "
                             f"(total skipped {skipped_now})")
                reason = self._agreed_reason(
                    supervisor.observe(step_now, loss, skipped_now))
                if reason is not None:
                    i, data = self._rollback(reason, supervisor, i, step_now, data_factory)
                    since_log = 0
                    continue
            if (i + 1) % self.log_every == 0 or i == steps - 1:
                m, per_layer = self._history_row(metrics, {}, t0)
                step_s = (self.spans.stop("step", sync=self.state, count=since_log)
                          if telem else 0.0)
                if guard_on and supervisor is None:
                    skipped_now = m["skipped_total"]
                    if skipped_now > self._skipped_seen:
                        self.telemetry.emit(
                            "nonfinite_step", step=m["step"],
                            count=skipped_now - self._skipped_seen, total=skipped_now)
                    self._skipped_seen = skipped_now
                self.log(f"step {m['step']:6d} loss {m['loss/total']:.4f} "
                         f"acc {m['accuracy']:.4f}"
                         + "".join(f" {k} {m[k]:.4f}" for k in TERM_KEYS if k in m))
                if telem:
                    self._log_step(m, per_layer, step_s, since_log)
                since_log = 0
            if (self.checkpoint_dir and self.checkpoint_every
                    and (i + 1) % self.checkpoint_every == 0):
                self._save_checkpoint()
            i += 1
            if self._stop_requested(preempt):
                self._handle_preempt(preempt)
                self._status = "preempted"
                break

    # ------------------------------------------------------------------
    def _agreed_reason(self, reason: Optional[str]) -> Optional[str]:
        """The supervisor's trip reason, rank 0's on every rank of a mesh
        (one broadcast over the host group a step)."""
        if self._host is None:
            return reason
        code = broadcast_int(0 if reason is None else TRIP_REASONS.index(reason) + 1,
                             self._host)
        return TRIP_REASONS[code - 1] if code else None

    def _stop_requested(self, preempt: PreemptionHandler) -> bool:
        """Whether the run stops for a signal: this process's flag, or on a
        mesh with ``preempt_grace`` the MAX over every rank's (one host
        all-reduce a step), so every rank stops on the same batch."""
        if self._host is None or self.preempt_grace is None:
            return preempt.triggered
        return preempt.agreed(self._host)

    def _rollback(self, reason: str, supervisor: TrainingSupervisor, i: int,
                  trip_step: int, data_factory: Optional[Callable[[], Any]]):
        """Restore the last validated checkpoint and fast-forward the data
        stream past the suspect window.  Returns ``(next_i, new_data)``.

        Resuming the stream at ``i + 1``, not at the restored step, is the
        re-poisoning guard: the batches between the restored checkpoint and
        the trip are consumed untrained, so a deterministic fault at one
        ordinal cannot hit the rolled-back run twice.  The restored state is
        read from disk, every leaf a new tensor: the fused path updates
        params in place, and nothing of the pre-trip state (or of the async
        writer's host buffers) survives.

        On a mesh the verdict is rank 0's: it drains its writer (a
        checkpoint at or below ``last_good`` may still be in flight), all
        ranks meet at a barrier, it picks the checkpoint and broadcasts its
        step (or why there is none, and every rank raises), every rank
        restores that step's block, and rank 0 alone removes the later
        checkpoints and re-points LATEST before a barrier.
        """
        diag = supervisor.diagnostics(reason)
        self.log(f"supervisor trip: {reason} at batch {i} "
                 f"(step {trip_step}, last_good {supervisor.last_good})")
        failure: Optional[DivergenceError] = None
        try:
            supervisor.note_rollback(reason)  # raises DivergenceError past budget
        except DivergenceError as e:
            failure = e
        verdict = _NO_CHECKPOINT
        if self.is_writer:
            if failure is not None:
                verdict = _PAST_BUDGET
            elif not self.checkpoint_dir or data_factory is None:
                verdict = _NO_SETUP
            else:
                self._drain_checkpoints()
        barrier(self._host)
        bound = supervisor.last_good
        if self.is_writer and verdict == _NO_CHECKPOINT:
            path = (latest_checkpoint(self.checkpoint_dir, max_step=bound)
                    if bound >= 0 else None)
            if path is not None:
                verdict = checkpoint_step(path)
        verdict = broadcast_int(verdict, self._host)
        if verdict == _PAST_BUDGET:
            raise failure or DivergenceError(
                f"diverged: {reason} persisted through "
                f"{supervisor.cfg.max_rollbacks} rollback(s)", diag)
        if verdict == _NO_SETUP:
            raise DivergenceError(
                f"diverged ({reason}): rollback needs checkpoint_dir and a "
                "data_factory", diag)
        if verdict == _NO_CHECKPOINT:
            raise DivergenceError(
                f"diverged ({reason}) before any validated checkpoint "
                f"(last_good step {bound})", diag)
        restored_step = self.restore(checkpoint_path(self.checkpoint_dir, verdict))
        removed = (discard_checkpoints_after(self.checkpoint_dir, restored_step)
                   if self.is_writer else [])
        barrier(self._host)   # LATEST re-pointed before any rank's next save
        self._last_saved_step = restored_step
        restored_skipped = int(self.state.skipped)
        restored_i = restored_step + restored_skipped
        resume_i = i + 1
        data = data_factory()
        for _ in range(resume_i):
            next(data)  # consumed before the trip; examples_seen unchanged
        self.telemetry.emit(
            "rollback", step=restored_step, from_step=trip_step, reason=reason,
            batches_dropped=resume_i - restored_i, rollbacks=supervisor.rollbacks,
            discarded=len(removed))
        supervisor.after_rollback(restored_skipped)
        self._skipped_seen = restored_skipped
        self.log(f"rollback {supervisor.rollbacks}: restored step {restored_step}, "
                 f"dropped batches [{restored_i}, {resume_i}), resuming at batch {resume_i}")
        return resume_i, data

    def _handle_preempt(self, preempt: PreemptionHandler) -> None:
        """Grace-window final save: persist the current full TrainState
        through the existing checkpointer, bounded by ``preempt_grace``.  On
        a mesh every rank enters the save's gathers together and rank 0
        writes (and, async, drains within the window before a barrier);
        ``saved`` is rank 0's, broadcast."""
        step = int(self.state.step)
        saved = False
        if self.checkpoint_dir:
            self._save_checkpoint()
            if self.async_checkpoint:
                if self.is_writer:
                    self._drain_checkpoints(timeout=self.preempt_grace)
                    saved = (self._checkpointer is not None
                             and self._checkpointer.latest_persisted_step() == step)
                barrier(self._host)
            else:
                saved = True
        saved = bool(broadcast_int(int(saved), self._host))
        self.telemetry.emit("preempt", step=step, signal=preempt.signal_name, saved=saved,
                            grace_s=float(self.preempt_grace or 0.0))
        self.log(f"preempted ({preempt.signal_name}): step {step} saved={saved}; "
                 "stopping cleanly")

    # ------------------------------------------------------------------
    def fit_stages(self, stages: Sequence[Stage], *, data_seed: int = 0
                   ) -> List[Dict[str, float]]:
        """Mixed-batch training: one train step per stage (its own shapes
        and schedule), moments and their counters carried, the schedule's
        counter reset between stages; stage ``si`` reads a fresh ``DataPipeline`` seeded
        ``data_seed + si``.  History rows carry ``stage``; ``wall_s`` runs
        on one clock across the stages.  Emits ``stage_start`` per stage and
        ``run_end`` from a ``finally``."""
        if self.state is None:
            self.init()
        self._emit_run_start()
        self._status = "ok"
        try:
            self._fit_stages(stages, data_seed)
        except BaseException as e:
            self._status = "diverged" if isinstance(e, DivergenceError) else "failed"
            raise
        finally:
            self._emit_run_end()
        return self.history

    def _fit_stages(self, stages: Sequence[Stage], data_seed: int) -> None:
        telem = self.telemetry.enabled
        t0 = time.perf_counter()
        for si, stage in enumerate(stages):
            self.log(f"== stage {si}: {stage.name} seq={stage.seq_len} "
                     f"batch={stage.batch_size} steps={stage.steps} "
                     f"lr={stage.learning_rate:.2e} warmup={stage.warmup_steps}")
            self.telemetry.emit(
                "stage_start", stage=si, name=stage.name, seq_len=stage.seq_len,
                batch_size=stage.batch_size, steps=stage.steps,
                learning_rate=stage.learning_rate, warmup_steps=stage.warmup_steps)
            _, step_fn = make_train_step(self.model, self.tc, stage.schedule, mesh=self.mesh,
                                         param_rules=self.param_rules)
            if si > 0:
                _reset_schedule_counts(self.state.opt_state)
            # on a mesh each stage's batch must split over the ranks (the
            # pipeline raises before the stage trains)
            data = DataPipeline(self.model.cfg, stage.batch_size, stage.seq_len,
                                device=self.device, seed=data_seed + si,
                                rows=self.batch_rows)
            since_log = 0
            for i in range(stage.steps):
                if telem and since_log == 0:
                    self.spans.start("step", sync=self.state)
                batch = next(data)
                self.examples_seen += self._examples(batch)
                self.state, metrics = step_fn(self.state, batch)
                since_log += 1
                if (i + 1) % self.log_every == 0 or i == stage.steps - 1:
                    m, per_layer = self._history_row(metrics, {"stage": si}, t0)
                    step_s = (self.spans.stop("step", sync=self.state, count=since_log)
                              if telem else 0.0)
                    self.log(f"[{stage.name}] step {m['step']:5d} "
                             f"loss {m['loss/total']:.4f}")
                    if telem:
                        self._log_step(m, per_layer, step_s, since_log)
                    since_log = 0
