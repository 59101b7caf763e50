"""The port's Trainer under the supervisor and preemption, on bert-smoke,
against the JAX package's Trainer from the same weights (``nn/bridge.py``)
and the same data (both ``DataPipeline``s give the same bytes from one
seed): a loss-spike rollback (fused LAMB and the chain) that ends bit-equal
to a port run over the same stream with the dropped batches removed, the
abort past ``max_rollbacks``, the abort without a checkpoint directory, a
preempted run resumed bit-exact against an uninterrupted one, and the
launcher's ``--telemetry-dir``, exit code 3 and flag checks.  Cases mirror
``tests/test_fault_tolerance.py`` on the JAX package.

Against JAX: the rollback, preempt and run-end events' counters, the
supervisor's diagnostics and the final ``state.step`` are equal; the
window's median and MAD agree to 1e-4 relative; the final weights are held
to ``tests/test_torch_stages.py``'s fp32 LAMB bounds (1e-5 but for a
thousandth of each leaf, all within 1e-3)."""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import DataPipeline as JaxDataPipeline
from repro.models import build_model as jax_build_model
from repro.telemetry import EventLog as JaxEventLog
from repro.telemetry import RunReport as JaxRunReport
from repro.train import DivergenceError as JaxDivergenceError
from repro.train import FaultInjector as JaxFaultInjector
from repro.train import FaultSpec as JaxFaultSpec
from repro.train import SupervisorConfig as JaxSupervisorConfig
from repro.train import Trainer as JaxTrainer
from repro_torch.checkpoint import checkpoint_step, latest_checkpoint
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax, train_state_from_jax
from repro_torch.telemetry import EventLog, read_events
from repro_torch.train import DivergenceError, FaultInjector, FaultSpec, SupervisorConfig, \
    Trainer

OFF = dict(use_flash_kernel=False, use_fused_ce_head=False, activation_dtype="float32")
BATCH, SEQ = 8, 16
SMOKE = ["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "16",
         "--fused-lamb", "--no-flash", "--no-fused-ce", "--device", "cpu"]
SPIKE = dict(kind="loss_spike", at=5, scale=100.0)
SECOND_SPIKE = dict(kind="loss_spike", at=9, scale=100.0)


def _cfg():
    return bert_large.smoke().replace(**OFF)


def _data():
    return DataPipeline(_cfg(), BATCH, SEQ, device="cpu", seed=0)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX Trainer's initial state for fused LAMB or the chain:
    ``fused -> TrainState``, a fresh copy on each call (a JAX step donates
    its state's buffers).  Every run of this file, port and JAX, starts
    from these weights."""
    states = {}

    def state(fused=True):
        if fused not in states:
            jtr = _jax_trainer(None, fused)
            jtr.init()
            states[fused] = jtr.state
        return jax.tree.map(jnp.copy, states[fused])
    return state


def _trainer(jax_state, fused=True, **kw):
    tr = Trainer(build_model(_cfg()),
                 TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=fused),
                 device="cpu", log_every=1, log_fn=lambda s: None, **kw)
    tr.state = train_state_from_jax(jax_state(fused))
    return tr


def _jax_trainer(jax_state, fused=True, **kw):
    jtr = JaxTrainer(jax_build_model(jax_bert.smoke().replace(**OFF)),
                     JaxTrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=fused),
                     log_every=1, log_fn=lambda s: None, **kw)
    if jax_state is not None:
        jtr.state = jax_state(fused)
    return jtr


def _faulty(spikes, jax=False):
    """A data factory: the bert-smoke stream with loss spikes injected."""
    if jax:
        inj = JaxFaultInjector([JaxFaultSpec(**s) for s in spikes])
        return lambda: inj.wrap(JaxDataPipeline(jax_bert.smoke().replace(**OFF), BATCH, SEQ,
                                                seed=0))
    inj = FaultInjector([FaultSpec(**s) for s in spikes])
    return lambda: inj.wrap(_data())


def _bits(params):
    return {k: v.numpy().tobytes() for k, v in params.items()}


def _assert_params_match_jax(params, jparams):
    for k, v in params_from_jax(jparams).items():
        diff = (params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


def _assert_diagnostics_match(diag, jdiag):
    assert set(diag) == set(jdiag)
    for k in ("reason", "rollbacks", "consecutive_skips", "last_good_step"):
        assert diag[k] == jdiag[k], k
    np.testing.assert_allclose([diag["window_median"], diag["window_mad"]],
                               [jdiag["window_median"], jdiag["window_mad"]], rtol=1e-4)
    assert [r["step"] for r in diag["recent"]] == [r["step"] for r in jdiag["recent"]]


def _fields(events, kind, keys):
    return [tuple(e.get(k) for k in keys) for e in events if e["event"] == kind]


ROLLBACK_KEYS = ("reason", "step", "from_step", "batches_dropped")
RUN_END_KEYS = ("status", "final_step", "skipped_steps", "rollbacks")


@pytest.fixture(scope="module")
def jax_rollback(jax_state, tmp_path_factory):
    """The JAX Trainer's rollback run, once for fused LAMB and once for the
    chain: ``fused -> (trainer, events)``."""
    runs = {}

    def run(fused):
        if fused not in runs:
            log = JaxEventLog.memory()
            jtr = _jax_trainer(jax_state, fused,
                               checkpoint_dir=str(tmp_path_factory.mktemp("jax_rollback")),
                               checkpoint_every=4, telemetry=log,
                               supervisor=JaxSupervisorConfig(spike_window=8, min_history=3))
            make = _faulty([SPIKE], jax=True)
            jtr.fit(make(), 8, data_factory=make)
            runs[fused] = jtr, log.events
        return runs[fused]
    return run


@pytest.mark.parametrize("async_checkpoint", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_trainer_rolls_back_on_spike(tmp_path, jax_state, jax_rollback, fused,
                                     async_checkpoint):
    """A loss spike at batch 5 trips the supervisor; the Trainer restores
    the step-4 checkpoint, drops batches [4, 6) and trains on: one
    ``rollback`` event, ``step == 8 - batches_dropped``, ``status`` ok, and
    the final params bit-equal to a run that never saw batches 4 and 5.
    The JAX Trainer, given the same spike, rolls back to the same step,
    resumes at the same batch and ends at weights within the bounds."""
    make_data = _faulty([SPIKE])
    log = EventLog.memory()
    tr = _trainer(jax_state, fused, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                  async_checkpoint=async_checkpoint, telemetry=log,
                  supervisor=SupervisorConfig(spike_window=8, min_history=3))
    hist = tr.fit(make_data(), 8, data_factory=make_data)
    (rb,) = [e for e in log.events if e["event"] == "rollback"]
    assert rb["reason"] == "loss_spike" and rb["step"] < rb["from_step"]
    assert (rb["step"], rb["from_step"], rb["batches_dropped"]) == (4, 6, 2)
    assert int(tr.state.step) == 8 - rb["batches_dropped"] == 6
    assert np.isfinite(hist[-1]["loss/total"])
    end = log.events[-1]
    assert end["event"] == "run_end" and end["status"] == "ok" and end["rollbacks"] == 1
    assert [e["step"] for e in log.events if e["event"] == "resume"] == [4]

    ref = _trainer(jax_state, fused)
    ref.fit((b for i, b in enumerate(_data()) if i not in (4, 5)), 6)
    assert _bits(tr.state.params) == _bits(ref.state.params)

    jtr, jevents = jax_rollback(fused)
    for kind, keys in (("rollback", ROLLBACK_KEYS), ("run_end", RUN_END_KEYS),
                       ("resume", ("step",))):
        assert _fields(log.events, kind, keys) == _fields(jevents, kind, keys), kind
    assert int(tr.state.step) == int(jtr.state.step)
    assert int(tr.state.skipped) == int(jtr.state.skipped)
    _assert_params_match_jax(tr.state.params, jtr.state.params)


def test_trainer_aborts_after_max_rollbacks(tmp_path, jax_state):
    """A second spike past ``max_rollbacks=1``: ``DivergenceError`` with the
    same diagnostics as the JAX Trainer's, after the same one rollback."""
    sup = dict(spike_window=8, min_history=3, max_rollbacks=1)
    log = EventLog.memory()
    tr = _trainer(jax_state, checkpoint_dir=str(tmp_path / "port"), checkpoint_every=2,
                  telemetry=log, supervisor=SupervisorConfig(**sup))
    make_data = _faulty([SPIKE, SECOND_SPIKE])
    with pytest.raises(DivergenceError) as ei:
        tr.fit(make_data(), 14, data_factory=make_data)
    assert ei.value.diagnostics["reason"] == "loss_spike"
    assert ei.value.diagnostics["rollbacks"] == 2
    assert [e["event"] for e in log.events].count("rollback") == 1
    assert log.events[-1]["status"] == "diverged" and tr._status == "diverged"

    jlog = JaxEventLog.memory()
    jtr = _jax_trainer(jax_state, checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=2,
                       telemetry=jlog, supervisor=JaxSupervisorConfig(**sup))
    make_jax = _faulty([SPIKE, SECOND_SPIKE], jax=True)
    with pytest.raises(JaxDivergenceError) as jei:
        jtr.fit(make_jax(), 14, data_factory=make_jax)
    _assert_diagnostics_match(ei.value.diagnostics, jei.value.diagnostics)
    for kind, keys in (("rollback", ROLLBACK_KEYS), ("run_end", RUN_END_KEYS)):
        assert _fields(log.events, kind, keys) == _fields(jlog.events, kind, keys), kind
    assert int(tr.state.step) == int(jtr.state.step)


def test_rollback_without_checkpoint_dir_raises(jax_state):
    """No checkpoint directory: the first trip raises, with the JAX
    Trainer's diagnostics at the same step."""
    sup = dict(spike_window=8, min_history=3)
    tr = _trainer(jax_state, supervisor=SupervisorConfig(**sup))
    make_data = _faulty([SPIKE])
    with pytest.raises(DivergenceError, match="checkpoint_dir") as ei:
        tr.fit(make_data(), 10, data_factory=make_data)
    assert tr._status == "diverged"

    jtr = _jax_trainer(jax_state, supervisor=JaxSupervisorConfig(**sup))
    make_jax = _faulty([SPIKE], jax=True)
    with pytest.raises(JaxDivergenceError, match="checkpoint_dir") as jei:
        jtr.fit(make_jax(), 10, data_factory=make_jax)
    _assert_diagnostics_match(ei.value.diagnostics, jei.value.diagnostics)
    assert int(tr.state.step) == int(jtr.state.step)


class TermBefore:
    """Sends SIGTERM to its own process before yielding batch ``n``."""

    def __init__(self, inner, n):
        self.inner, self.n, self.i = inner, n, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == self.n:
            os.kill(os.getpid(), signal.SIGTERM)
        self.i += 1
        return next(self.inner)


PREEMPT_KEYS = ("signal", "step", "saved")


@pytest.fixture(scope="module")
def jax_preempt(jax_state, tmp_path_factory):
    """The JAX Trainer's preempted run: SIGTERM before batch 2 of 6."""
    log = JaxEventLog.memory()
    jtr = _jax_trainer(jax_state, checkpoint_dir=str(tmp_path_factory.mktemp("jax_preempt")),
                       checkpoint_every=100, preempt_grace=30.0, telemetry=log)
    jtr.fit(TermBefore(JaxDataPipeline(jax_bert.smoke().replace(**OFF), BATCH, SEQ, seed=0),
                       2), 6)
    return jtr, log.events


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_trainer_preempts_and_resumes_bit_exact(tmp_path, jax_state, jax_preempt,
                                                async_checkpoint):
    """SIGTERM before batch 2: the batch in hand is trained, the state is
    saved at step 3 and the run ends ``preempted``, as the JAX Trainer's
    does from the same weights; the resumed run then ends bit-equal to an
    uninterrupted one."""
    log = EventLog.memory()
    tr = _trainer(jax_state, checkpoint_dir=str(tmp_path), checkpoint_every=100,
                  preempt_grace=30.0, async_checkpoint=async_checkpoint, telemetry=log)
    tr.fit(TermBefore(_data(), 2), 6)
    (pe,) = [e for e in log.events if e["event"] == "preempt"]
    assert log.events[-1]["status"] == "preempted" == tr._status
    assert pe["saved"] and pe["signal"] == "SIGTERM" and pe["step"] == 3
    stopped_at = int(tr.state.step)
    assert stopped_at == 3
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == stopped_at

    jtr, jevents = jax_preempt
    for kind, keys in (("preempt", PREEMPT_KEYS), ("run_end", RUN_END_KEYS)):
        assert _fields(log.events, kind, keys) == _fields(jevents, kind, keys), kind
    assert stopped_at == int(jtr.state.step)
    _assert_params_match_jax(tr.state.params, jtr.state.params)

    resumed = _trainer(jax_state, checkpoint_dir=str(tmp_path), checkpoint_every=100,
                       resume=True)
    h2 = resumed.fit(_data(), 6)
    ref = _trainer(jax_state)
    h3 = ref.fit(_data(), 6)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "wall_s"}  # noqa: E731
                          for r in rows if r["step"] > stopped_at]
    assert strip(h2) and strip(h2) == strip(h3)
    assert _bits(resumed.state.params) == _bits(ref.state.params)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_telemetry_dir_writes_run_report(tmp_path, capsys):
    tdir = tmp_path / "run"
    launch_train.main(SMOKE + ["--steps", "2", "--log-every", "1", "--log-trust-ratios",
                               "--telemetry-dir", str(tdir)])
    out = capsys.readouterr().out
    assert "status=ok" in out and "RUN_REPORT.json" in out
    events = read_events(tdir / "events.jsonl")
    assert [e["event"] for e in events].count("trust_ratios") == 2
    report = json.loads((tdir / "RUN_REPORT.json").read_text())
    assert report["status"] == "ok" and report["train"]["steps"] == 2
    assert report["provenance"]["device_kind"] == "cpu"
    assert report["trust_ratios"]["steps_recorded"] == 2
    assert JaxRunReport.load(tdir / "RUN_REPORT.json").report == report


def test_launcher_diverging_run_exits_3(tmp_path, capsys):
    """Momentum without a clip at a huge learning rate: the step-2 loss is
    not finite, the supervisor trips before any validated checkpoint, and
    the launcher exits 3 with the diagnostics on stderr and the report's
    status ``diverged``."""
    argv = [a for a in SMOKE if a != "--fused-lamb"] + [
        "--optimizer", "momentum", "--base-lr", "1e12", "--steps", "4", "--log-every", "1",
        "--rollback-on-spike", "--max-rollbacks", "1",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1",
        "--telemetry-dir", str(tmp_path / "t")]
    with pytest.raises(SystemExit) as ei:
        launch_train.main(argv)
    assert ei.value.code == 3
    captured = capsys.readouterr()
    assert "DIVERGED" in captured.err and "status=diverged" in captured.out
    report = json.loads((tmp_path / "t" / "RUN_REPORT.json").read_text())
    assert report["status"] == report["run_end"]["status"] == "diverged"


@pytest.mark.parametrize("extra,match", [
    (["--rollback-on-spike"], "requires --checkpoint-dir"),
    (["--rollback-on-spike", "--checkpoint-dir", "x"], "requires --checkpoint-dir"),
    (["--rollback-on-spike", "--checkpoint-dir", "x", "--checkpoint-every", "1",
      "--mixed-batch"], "not supported with --mixed-batch"),
])
def test_launcher_rollback_flag_checks(extra, match):
    with pytest.raises(SystemExit, match=match):
        launch_train.main(SMOKE + ["--steps", "2"] + extra)


def test_launcher_preempt_grace_stops_cleanly(tmp_path, capsys, monkeypatch):
    """``--preempt-grace``: a SIGTERM during the run saves the state and
    prints ``status=preempted``; the launcher returns normally."""
    real = DataPipeline.__next__
    calls = {"n": 0}

    def next_then_term(self):
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self)

    monkeypatch.setattr(DataPipeline, "__next__", next_then_term)
    ck = str(tmp_path / "ck")
    trainer = launch_train.main(SMOKE + ["--steps", "4", "--checkpoint-dir", ck,
                                         "--preempt-grace", "10"])
    assert "status=preempted" in capsys.readouterr().out
    assert int(trainer.state.step) == 2
    assert checkpoint_step(latest_checkpoint(ck)) == 2
    assert torch.isfinite(next(iter(trainer.state.params.values()))).all()
