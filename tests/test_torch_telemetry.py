"""The port's telemetry (``repro_torch.telemetry``) against the JAX package's
(``repro.telemetry``): the event schema, the null sink, span timers, the
trust-ratio recorder, the Trainer's events with telemetry off and on, the
per-layer records of both LAMB paths, the async checkpointer's events, and
run reports that fold to the same dict and load in either package."""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.telemetry import EVENT_TYPES as JAX_EVENT_TYPES
from repro.telemetry import EventLog as JaxEventLog
from repro.telemetry import RunReport as JaxRunReport
from repro.telemetry import TrustRecorder as JaxTrustRecorder
from repro.telemetry import leaf_names as jax_leaf_names
from repro.telemetry.events import REQUIRED_FIELDS as JAX_REQUIRED_FIELDS
from repro.telemetry.events import _jsonable as jax_jsonable
from repro.train import Trainer as JaxTrainer
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import core
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.models import build_model
from repro_torch.nn import flatten, params_from_jax, train_state_from_jax
from repro_torch.telemetry import (
    EVENT_TYPES,
    EventLog,
    RunReport,
    SpanRecorder,
    TrustRecorder,
    leaf_names,
    read_events,
    run_provenance,
    validate_event,
)
from repro_torch.telemetry.events import REQUIRED_FIELDS
from repro_torch.telemetry.trust import PER_LAYER_KEY
from repro_torch.train import Trainer, make_train_step
from tests.conftest import tiny_dense


OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)


def _smoke():
    return bert_large.smoke().replace(**OFF)


def _batches(n: int, batch: int = 4, seq: int = 16, seed: int = 0):
    data = jax_synthetic.batch_iterator(jax_bert.smoke().replace(**OFF), batch, seq, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in next(data).items()} for _ in range(n)]


def _fit(telemetry=None, steps=4, log_every=2, **tc_kw):
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, **tc_kw)
    tr = Trainer(build_model(_smoke()), tc, device="cpu", log_every=log_every,
                 log_fn=lambda s: None, telemetry=telemetry)
    tr.fit(itertools.cycle(_batches(2)), steps)
    return tr


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------

def test_event_schema_is_the_reference_schema():
    assert EVENT_TYPES == JAX_EVENT_TYPES
    assert REQUIRED_FIELDS == JAX_REQUIRED_FIELDS


def test_event_log_jsonl_roundtrip(tmp_path):
    log = EventLog.to_dir(tmp_path)
    log.emit("run_start", provenance=run_provenance(device="cpu"), arch="tiny")
    log.emit("step", step=10, metrics={"loss/total": 1.5})
    log.emit("span", name="step", seconds=0.25, count=10)
    log.emit("checkpoint", step=10, path=str(tmp_path), extra=torch.tensor([1.0, 2.0]))
    log.emit("run_end", status="ok")
    log.close()

    events = read_events(tmp_path / "events.jsonl")
    assert [e["event"] for e in events] == [
        "run_start", "step", "span", "checkpoint", "run_end"]
    assert [e["seq"] for e in events] == list(range(5))
    assert events[3]["extra"] == [1.0, 2.0]     # a tensor field serialises
    prov = events[0]["provenance"]
    assert prov["git_sha"] and prov["backend"] == "cpu" and prov["device_kind"] == "cpu"
    assert prov["torch_version"] == torch.__version__ and prov["device_count"] == 1
    assert "jax_version" not in prov
    # the reference's reader takes the port's log: one line format
    from repro.telemetry import read_events as jax_read_events

    assert jax_read_events(tmp_path / "events.jsonl") == events
    log2 = EventLog(tmp_path / "events.jsonl")     # appended, not truncated
    log2.emit("run_end", status="again")
    log2.close()
    assert len(read_events(tmp_path / "events.jsonl")) == 6


def test_event_schema_rejects_bad_events():
    log = EventLog.memory()
    with pytest.raises(ValueError, match="unknown event type"):
        log.emit("not_a_type", anything=1)
    with pytest.raises(ValueError, match="missing required fields"):
        log.emit("span", name="no-seconds")
    with pytest.raises(ValueError, match="missing required fields"):
        log.emit("run_start")
    for etype in EVENT_TYPES:
        validate_event({"event": etype, **{f: 0 for f in REQUIRED_FIELDS[etype]}})


def test_null_sink_is_noop(tmp_path):
    log = EventLog()
    assert not log.enabled
    assert log.emit("not_even_a_type", junk=object()) is None
    assert log.events == []
    assert list(tmp_path.iterdir()) == []


def test_provenance_keys_the_gate_reads_and_config_hash():
    """``scripts/telemetry_gate.py`` reads ``device_kind``, ``git_sha`` and
    ``config_hash``; the hash is the reference's over equal configs."""
    from repro.telemetry import config_hash as jax_config_hash

    prov = run_provenance(device="cpu", configs=(_smoke(), TrainConfig()))
    for k in ("device_kind", "git_sha", "config_hash", "schema_version", "timestamp",
              "cuda_version"):
        assert k in prov, k
    assert prov["config_hash"] == jax_config_hash(jax_bert.smoke().replace(**OFF),
                                                  JaxTrainConfig())


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_timer_counts_and_events():
    spans = SpanRecorder(log=EventLog.memory())
    x = torch.ones((64, 64))
    with spans.span("mm", sync={"x": x}) as sp:
        for _ in range(4):
            out = (x @ x).sum()
        sp.block_on(out)
        sp.count = 4
    s = spans.summary()["mm"]
    assert s["count"] == 4 and s["total_s"] > 0
    assert s["mean_s"] == pytest.approx(s["total_s"] / 4)
    ev = spans.log.events[0]
    assert ev["event"] == "span" and ev["count"] == 4


def test_span_phase_style_and_errors():
    spans = SpanRecorder()
    spans.start("step", sync=None)
    dt = spans.stop("step", sync=[1, "not a tensor"], count=2)
    assert dt >= 0
    with pytest.raises(ValueError, match="never started"):
        spans.stop("step")
    assert spans.summary()["step"]["count"] == 2


def test_span_syncs_only_a_card(monkeypatch):
    """The boundary sync is a CUDA synchronize of a tensor's device and a
    no-op for CPU tensors, ``None`` and trees without a tensor."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    for tree in (None, {"a": torch.zeros(2)}, {"n": 3}, (1.0, [2.0])):
        SpanRecorder._sync(tree)
    assert calls == []


# ---------------------------------------------------------------------------
# trust-ratio recorder
# ---------------------------------------------------------------------------

def test_leaf_names_are_the_reference_names():
    jmodel = jax_build_model(jax_bert.smoke().replace(**OFF))
    jparams = jmodel.init(jax.random.key(0))
    port = params_from_jax(jparams)
    assert leaf_names(port) == jax_leaf_names(jparams)
    assert "blocks.attn.wq" in leaf_names(port)


def test_trust_recorder_matches_reference():
    records = {"trust_ratio": {"a": np.array([0.5, 2.0]), "b": np.array(1.0)},
               "param_norm": {"a": np.array([1.0, 1.0]), "b": np.array(3.0)},
               "update_norm": {"a": np.array([2.0, 0.5]), "b": np.array(3.0)}}
    port_records = {k: {n: torch.tensor(v, dtype=torch.float32) for n, v in d.items()}
                    for k, d in records.items()}
    rec, ref = TrustRecorder(log=EventLog.memory()), JaxTrustRecorder(log=JaxEventLog.memory())
    layers = rec.record(10, port_records)
    assert layers == ref.record(10, records)
    assert layers["a"]["per_layer"] == [0.5, 2.0] and layers["b"]["param_norm"] == [3.0]
    s = rec.summary()
    assert s == ref.summary()
    assert s["per_leaf"]["a"] == {"min": 0.5, "max": 2.0, "mean": 1.25}
    assert sum(s["hist"]["counts"]) == 3
    strip = lambda e: {k: v for k, v in e.items() if k != "t"}  # noqa: E731
    assert strip(rec.log.events[0]) == strip(ref.log.events[0])
    assert TrustRecorder().summary() == {}


# ---------------------------------------------------------------------------
# the Trainer with telemetry off and on
# ---------------------------------------------------------------------------

TIMING_KEYS = {"wall_s"}


@pytest.mark.parametrize("fused", [True, False])
def test_history_identical_with_telemetry_off_vs_on(fused):
    """Telemetry on (events, spans and the per-layer records) leaves every
    history value bit-identical to a run with the null sink."""
    h_off = _fit(use_fused_lamb=fused).history
    h_on = _fit(telemetry=EventLog.memory(), use_fused_lamb=fused,
                record_trust_ratios=True).history
    assert len(h_off) == len(h_on) == 2
    for a, b in zip(h_off, h_on):
        assert set(a) == set(b)
        for k in a:
            if k not in TIMING_KEYS:
                assert a[k] == b[k], k


def test_trainer_emits_run_events():
    log = EventLog.memory()
    tr = _fit(telemetry=log, use_fused_lamb=True, record_trust_ratios=True,
              log_trust_ratios=True)
    types = [e["event"] for e in log.events]
    assert types[0] == "run_start" and types[-1] == "run_end"
    prov = log.events[0]["provenance"]
    for k in ("git_sha", "torch_version", "device_kind", "config_hash"):
        assert k in prov, k
    assert types.count("step") == 2 and types.count("span") == 2
    assert types.count("trust_ratios") == 2
    step_ev = next(e for e in log.events if e["event"] == "step")
    assert step_ev["step_time_s"] > 0 and "loss/total" in step_ev["metrics"]
    assert all(PER_LAYER_KEY not in h for h in tr.history)
    trust = next(e for e in log.events if e["event"] == "trust_ratios")
    assert len(trust["layers"]) == len(tr.state.params)
    assert len(trust["layers"]["blocks.attn.wq"]["per_layer"]) == _smoke().n_layers
    end = log.events[-1]
    assert end["status"] == "ok" and end["final_step"] == 4
    for ev in log.events:
        validate_event(ev)


def test_fit_stages_emits_stage_start_and_spans():
    log = EventLog.memory()
    tr = Trainer(build_model(_smoke()), TrainConfig(optimizer="lamb", learning_rate=1e-3),
                 device="cpu", log_every=1, log_fn=lambda s: None, telemetry=log)
    stages = [core.make_stage("s1", 16, 4, 2, base_lr=1e-3, base_batch=4,
                              base_warmup_ratio=0.25),
              core.make_stage("s2", 32, 2, 1, base_lr=1e-3, base_batch=4,
                              base_warmup_ratio=0.25)]
    hist = tr.fit_stages(stages)
    walls = [h["wall_s"] for h in hist]
    assert len(walls) == 3 and walls == sorted(walls)
    assert [e["name"] for e in log.events if e["event"] == "stage_start"] == ["s1", "s2"]
    assert [e["stage"] for e in log.events if e["event"] == "step"] == [0, 0, 1]
    assert sum(e["event"] == "span" for e in log.events) == 3
    assert log.events[-1]["event"] == "run_end" and log.events[-1]["status"] == "ok"


def test_checkpoint_events_sync_and_async(tmp_path):
    log = EventLog.memory()
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3)
    tr = Trainer(build_model(_smoke()), tc, device="cpu", log_every=10,
                 log_fn=lambda s: None, telemetry=log,
                 checkpoint_dir=str(tmp_path / "sync"), checkpoint_every=1)
    tr.fit(iter(_batches(2)), 2)
    sync = [e for e in log.events if e["event"] == "checkpoint"]
    assert [(e["step"], e["mode"]) for e in sync] == [(1, "sync"), (2, "sync")]
    assert all(e["write_s"] > 0 for e in sync)
    alog = EventLog.memory()
    with AsyncCheckpointer(str(tmp_path / "async"), telemetry=alog) as ck:
        ck.save(7, tr.state)
        ck.wait()
    (ev,) = alog.events
    assert ev["event"] == "checkpoint" and ev["mode"] == "async" and ev["step"] == 7
    for k in ("snapshot_s", "blocked_s", "write_s", "copy_s"):
        assert ev[k] >= 0, k
    assert ev["path"].endswith("step_00000007")


# ---------------------------------------------------------------------------
# the per-layer records against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_per_layer_records_match_jax(fused):
    """``record_trust_ratios``, fp32, two steps each taken by both packages
    from the JAX package's state: the fused path's records carry the ratios
    K2 applied (its aux output; the reference's Pallas ``with_aux`` in
    interpret mode), the chain's the post-hoc phi(||x||)/||Δx||.  Param
    norms come from the same weights (rtol 1e-5); ratios and update norms
    at the update-norm bound of ``test_torch_train.py`` (rtol 1e-4)."""
    jcfg = jax_bert.smoke().replace(activation_dtype="float32", **OFF)
    kw = dict(optimizer="lamb", use_fused_lamb=fused, learning_rate=0.01,
              record_trust_ratios=True)
    jinit, jstep = jax_make_train_step(jax_build_model(jcfg),
                                       JaxTrainConfig(fused_backend="interpret", **kw),
                                       jax_warmup_poly_decay(0.01, 10, 0))
    jstep = jax.jit(jstep)
    _, step = make_train_step(build_model(_smoke().replace(activation_dtype="float32")),
                              TrainConfig(**kw), warmup_poly_decay(0.01, 10, 0))
    jstate = jinit(jax.random.key(0))
    data = jax_synthetic.batch_iterator(jcfg, 8, 32, seed=1)
    for _ in range(2):
        batch = next(data)
        state = train_state_from_jax(jstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        _, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got, want = m[PER_LAYER_KEY], jax.device_get(jm[PER_LAYER_KEY])
        assert set(got) == {"trust_ratio", "param_norm", "update_norm"}
        for kind, rtol in (("param_norm", 1e-5), ("trust_ratio", 1e-4),
                           ("update_norm", 1e-4)):
            ref = flatten(want[kind])
            assert list(got[kind]) == list(ref), kind
            for k, v in ref.items():
                np.testing.assert_allclose(got[kind][k].numpy(), np.asarray(v),
                                           rtol=rtol, err_msg=f"{kind}/{k}")
                assert got[kind][k].device.type == "cpu"   # left on the step's device
    ratios = np.concatenate([v.numpy().reshape(-1) for v in got["trust_ratio"].values()])
    assert (ratios != 1.0).any()   # past the first step's zero moments, not all masked


# ---------------------------------------------------------------------------
# run reports in both packages
# ---------------------------------------------------------------------------

def test_run_report_folds_and_loads_in_both_packages(tmp_path):
    """One event list (a port run's, with trust records, checkpoints and
    spans) folds to the same dict in both packages; the port's report loads
    in the reference's ``RunReport`` and compares equal, and the reverse."""
    log = EventLog.memory()
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True,
                     record_trust_ratios=True)
    tr = Trainer(build_model(_smoke()), tc, device="cpu", log_every=1,
                 log_fn=lambda s: None, telemetry=log,
                 checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                 async_checkpoint=True)
    tr.fit(iter(_batches(2)), 2)
    events = json.loads(json.dumps(log.events))
    port = RunReport.from_events(events).report
    assert port == JaxRunReport.from_events(events).report
    for section in ("provenance", "train", "spans", "trust_ratios", "checkpoints",
                    "run_end", "events"):
        assert section in port, section
    assert port["checkpoints"]["async"]["count"] == 1
    path = RunReport(port).write(tmp_path / "RUN_REPORT.json")
    loaded = JaxRunReport.load(path)
    assert loaded.report == json.loads(json.dumps(port))
    tols = {"train.final.loss/total": 0.0, "train.steps": 0.0,
            "provenance.device_kind": 0.0, "spans.step.mean_s": None}
    assert loaded.compare(RunReport.load(path).report, tols).ok
    assert RunReport.load(path).compare(loaded.report, tols).ok
    # the reverse: a JAX run's events fold the same in the port
    jlog = JaxEventLog.memory()
    jtr = JaxTrainer(jax_build_model(tiny_dense()),
                     JaxTrainConfig(optimizer="lamb", learning_rate=1e-3,
                                    use_fused_lamb=True, record_trust_ratios=True),
                     log_every=1, log_fn=lambda s: None, telemetry=jlog)
    from repro.data import make_batch

    jtr.fit(itertools.repeat(make_batch(tiny_dense(), np.random.default_rng(0), 2, 16)), 2)
    jevents = json.loads(json.dumps(jlog.events, default=jax_jsonable))
    assert RunReport.from_events(jevents).report == JaxRunReport.from_events(jevents).report


def test_run_report_compare_gates():
    log = EventLog.memory()
    _fit(telemetry=log, steps=2, log_every=1, record_trust_ratios=True, use_fused_lamb=True)
    rep = RunReport.from_events(log)
    base = json.loads(json.dumps(rep.report))
    base["train"]["final"]["loss/total"] *= 1.01
    assert rep.compare(base, {"train.final.loss/total": 0.05, "train.logged_steps": 0.0,
                              "provenance.torch_version": 0.0}).ok
    base["train"]["final"]["loss/total"] *= 2.0
    base["serve"] = {"requests": 1}
    res = rep.compare(base, {"train.final.loss/total": 0.05, "no.such.key": None})
    statuses = {c.key: c.status for c in res.checks}
    assert not res.ok and "FAIL" in res.render()
    assert statuses["train.final.loss/total"] == "regressed"
    assert statuses["section:serve"] == "missing" and statuses["no.such.key"] == "missing"
