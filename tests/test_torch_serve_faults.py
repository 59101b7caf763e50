"""The port's serving reliability layer against the JAX package's: the fault
injector's scenarios on both packages' classes, then the reliability
scenarios of ``tests/test_serve_faults.py`` (retries, retry exhaustion,
quarantine, decode timeout, stall-watchdog degrade, drain, the terminal-state
invariant) on the port's ``ContinuousEngine``.

Models are ``tiny_dense`` in fp32 with the JAX weights carried across.
Where an outcome does not hang on wall time, the port's terminal counts,
lifecycle events and ``RUN_REPORT.json`` serve section (``by_status``,
``lifecycle``, the terminal counts of ``stats``) must equal the JAX
engine's on the same scenario, and greedy tokens must be identical."""
import dataclasses

import jax
import numpy as np
import pytest

import repro.serve as jax_serve
import repro.telemetry as jax_telemetry
import repro_torch.serve as serve
from conftest import tiny_dense
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax
from repro_torch.serve import (
    ContinuousEngine,
    RequestStatus,
    ServeFaultInjector,
    ServeFaultSpec,
    ServeRequest,
)
from repro_torch.telemetry import EventLog, RunReport

STATUSES = ("completed", "shed", "timed_out", "failed")


@pytest.fixture(scope="module")
def served():
    jcfg = tiny_dense(activation_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jmodel, jparams, model, params_from_jax(jparams)


def _reqs(mod, n, *, max_new=4, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [mod.ServeRequest(rng.integers(0, 256, size=8).astype(np.int32),
                             max_new_tokens=max_new, rid=i, **kw) for i in range(n)]


def _counts(reqs):
    return {s: sum(1 for r in reqs if r.status.value == s) for s in STATUSES}


def _serve_section(log, report_cls):
    """The report's serve section without its wall-time numbers."""
    serve_ = report_cls.from_events(log).report["serve"]
    stats = {k: serve_["stats"][k] for k in ("submitted", *STATUSES, "dropped", "retries",
                                             "quarantines", "decode_steps")}
    return dict(requests=serve_["requests"], dropped=serve_["dropped"],
                by_status=serve_["by_status"], lifecycle=serve_.get("lifecycle"), stats=stats)


def _both(served, make_faults, reqs_kw, **eng_kw):
    """Run one scenario on the JAX engine and on the port's; returns
    ((requests, log, engine) of JAX, the same of the port)."""
    jmodel, jparams, model, params = served
    out = []
    for mod, tel, m, p in ((jax_serve, jax_telemetry, jmodel, jparams),
                           (serve, None, model, params)):
        log = (tel.EventLog if tel else EventLog).memory()
        faults = mod.ServeFaultInjector(make_faults(mod)) if make_faults else None
        eng = mod.ContinuousEngine(m, p, **{"n_slots": 2, "max_len": 32, **eng_kw},
                                   telemetry=log, faults=faults)
        out.append((eng.generate(_reqs(mod, **reqs_kw)), log, eng))
    return out


# ---------------------------------------------------------------------------
# injector: the JAX suite's scenarios on both packages' classes
# ---------------------------------------------------------------------------

def _once(mod):
    inj = mod.ServeFaultInjector([mod.ServeFaultSpec("sample_nan", at=3)])
    out = [inj.fire_request(2), inj.fire_request(3), inj.fire_request(3)]
    inj.reset()
    return out + [inj.fire_request(3)]


def _persistent(mod):
    inj = mod.ServeFaultInjector([mod.ServeFaultSpec("sample_nan", at=1, once=False),
                                  mod.ServeFaultSpec("slot_corrupt", at=1)])
    return [inj.fire_request(1) for _ in range(3)] + [inj.fire_counts()]


def _stall(mod):
    inj = mod.ServeFaultInjector([
        mod.ServeFaultSpec("decode_stall", at=2, stall_s=0.1),
        mod.ServeFaultSpec("decode_stall", at=-1, stall_s=0.01, once=False)])
    return [round(inj.stall_s(o), 9) for o in (0, 2, 2)]


def _parse(mod):
    specs = mod.parse_fault_specs(
        "sample_nan@1,slot_corrupt@2:persist,decode_stall@3:stall=0.2")
    errors = []
    for text in ("sample_nan", "oom@1", "sample_nan@1:never"):
        with pytest.raises(ValueError) as e:
            mod.parse_fault_specs(text)
        errors.append(str(e.value))
    return [(s.kind, s.at, s.once, s.stall_s) for s in specs] + errors


INJECTOR_SCENARIOS = {
    "once semantics and replay": (_once, [None, "sample_nan", None, "sample_nan"]),
    "persistent and priority": (_persistent, ["slot_corrupt", "sample_nan", "sample_nan",
                                              {"slot_corrupt": 1, "sample_nan": 2}]),
    "stall keyed by step ordinal": (_stall, [0.01, 0.11, 0.01]),
    "parse fault specs": (_parse, None),
}


@pytest.mark.parametrize("name", list(INJECTOR_SCENARIOS))
def test_injector_scenarios_equal_jax(name):
    scenario, want = INJECTOR_SCENARIOS[name]
    out = scenario(serve)
    assert out == scenario(jax_serve)
    if want is not None:
        assert out == want


# ---------------------------------------------------------------------------
# engine scenarios held to the JAX engine
# ---------------------------------------------------------------------------

def test_transient_fault_retries_then_completes(served):
    """A once-fault frees the slot and requeues the request; the retry
    completes with the tokens an unfaulted run produces, as in JAX."""
    (jout, jlog, _), (out, log, eng) = _both(
        served, lambda m: [m.ServeFaultSpec("sample_nan", at=1)], dict(n=3))
    _, _, model, params = served
    ref = ContinuousEngine(model, params, n_slots=2, max_len=32).generate(_reqs(serve, 3))
    assert _counts(out) == _counts(jout) == {"completed": 3, "shed": 0, "timed_out": 0,
                                             "failed": 0}
    assert out[1].attempts == 2
    assert [e["rid"] for e in log.events if e["event"] == "serve_retry"] == [1]
    for r, j, s in zip(out, jout, ref):
        assert r.out_tokens == [int(t) for t in j.out_tokens] == s.out_tokens
    assert eng.pool.n_free == 2
    assert _serve_section(log, RunReport) == _serve_section(jlog, jax_telemetry.RunReport)


def test_retry_budget_exhaustion_fails_not_drops(served):
    (jout, jlog, _), (out, log, _) = _both(
        served, lambda m: [m.ServeFaultSpec("sample_nan", at=0, once=False)], dict(n=2),
        max_retries=2)
    assert out[0].status is RequestStatus.FAILED and out[0].fail_reason == "sample_nan"
    assert not out[0].dropped and out[0].attempts == 3
    assert out[1].status is RequestStatus.COMPLETED
    assert [e["attempt"] for e in log.events if e["event"] == "serve_retry"] == [1, 2]
    assert sorted(e["status"] for e in log.events if e["event"] == "serve_request") == [
        "completed", "failed"]
    assert _counts(out) == _counts(jout)
    assert _serve_section(log, RunReport) == _serve_section(jlog, jax_telemetry.RunReport)


def test_slot_corruption_quarantines_and_recovers(served):
    (jout, jlog, _), (out, log, eng) = _both(
        served, lambda m: [m.ServeFaultSpec("slot_corrupt", at=0)], dict(n=3, max_new=6),
        quarantine_steps=2)
    assert _counts(out)["completed"] == 3
    quar = [e for e in log.events if e["event"] == "serve_quarantine"]
    assert len(quar) == 1 and quar[0]["rid"] == 0
    assert eng.pool.n_free == 2
    assert [r.out_tokens for r in out] == [[int(t) for t in r.out_tokens] for r in jout]
    assert _serve_section(log, RunReport) == _serve_section(jlog, jax_telemetry.RunReport)


def test_quarantine_cannot_deadlock_single_slot(served):
    _, _, model, params = served
    eng = ContinuousEngine(
        model, params, n_slots=1, max_len=32, quarantine_steps=1000,
        faults=ServeFaultInjector([ServeFaultSpec("slot_corrupt", at=0)]))
    out = eng.generate(_reqs(serve, 2))
    assert _counts(out)["completed"] == 2
    assert eng.pool.n_free == 1


def test_report_folds_serve_lifecycle_as_jax(served):
    (jout, jlog, _), (out, log, _) = _both(
        served, lambda m: [m.ServeFaultSpec("sample_nan", at=0),
                           m.ServeFaultSpec("slot_corrupt", at=1, once=False)],
        dict(n=4), max_retries=1)
    section = _serve_section(log, RunReport)
    assert section == _serve_section(jlog, jax_telemetry.RunReport)
    assert section["by_status"] == _counts(out) == _counts(jout)
    assert sum(section["by_status"].values()) == section["requests"] == 4
    assert section["lifecycle"]["retries"] == 2 and section["lifecycle"]["quarantines"] == 2
    assert section["stats"]["failed"] == 1 and section["stats"]["submitted"] == 4
    assert RunReport.from_events(log).report["serve"]["stats"]["device"] == "cpu"


def test_every_request_one_terminal_state_under_chaos(served):
    """Overload + mixed faults: the four terminal counts stay disjoint, sum
    to the submitted total, replay exactly, and equal the JAX engine's."""
    jmodel, jparams, model, params = served
    results = []
    for mod, m, p in ((jax_serve, jmodel, jparams), (serve, model, params)):
        eng = mod.ContinuousEngine(
            m, p, n_slots=2, max_len=32, scheduler=mod.FCFSScheduler(max_queue=2),
            faults=mod.ServeFaultInjector([mod.ServeFaultSpec("slot_corrupt", at=0),
                                           mod.ServeFaultSpec("sample_nan", at=1,
                                                              once=False)]))
        runs = []
        for _ in range(2):
            eng.faults.reset()
            eng.scheduler = mod.FCFSScheduler(max_queue=2)
            out = eng.generate(_reqs(mod, 8, max_new=6))
            for r in out:
                assert [r.status.value == s for s in STATUSES].count(True) == 1
            runs.append(_counts(out))
        assert runs[0] == runs[1]
        results.append(runs[0])
    assert results[0] == results[1]
    assert sum(results[1].values()) == 8
    assert results[1]["failed"] == 1 and results[1]["shed"] > 0


# ---------------------------------------------------------------------------
# scenarios that hang on wall time: the port's engine alone
# ---------------------------------------------------------------------------

def test_decode_timeout_frees_slot_for_next_request(served):
    _, _, model, params = served
    log = EventLog.memory()
    eng = ContinuousEngine(
        model, params, n_slots=1, max_len=64, telemetry=log,
        faults=ServeFaultInjector([ServeFaultSpec("decode_stall", at=-1, stall_s=0.01,
                                                  once=False)]))
    slow = ServeRequest(np.zeros(8, np.int32), max_new_tokens=40, timeout_s=0.03, rid=0)
    quick = ServeRequest(np.zeros(8, np.int32), max_new_tokens=2, rid=1)
    out = eng.generate([slow, quick])
    assert out[0].status is RequestStatus.TIMED_OUT and out[0].dropped
    assert 0 < len(out[0].out_tokens) < 40
    assert out[1].status is RequestStatus.COMPLETED
    assert eng.pool.n_free == 1
    t = [e for e in log.events if e["event"] == "serve_timeout"]
    assert len(t) == 1 and t[0]["where"] == "decode"


def test_stall_watchdog_degrades_new_admissions(served):
    _, _, model, params = served
    log = EventLog.memory()
    eng = ContinuousEngine(
        model, params, n_slots=1, max_len=64, telemetry=log, stall_slo_s=0.05,
        degrade_max_new_tokens=2, degrade_recovery_steps=10_000,
        faults=ServeFaultInjector([ServeFaultSpec("decode_stall", at=0, stall_s=0.2)]))
    out = eng.generate(_reqs(serve, 2, max_new=8))
    degraded = [e for e in log.events if e["event"] == "serve_degraded"]
    assert degraded and degraded[0]["active"] is True
    assert [len(r.out_tokens) for r in out] == [8, 2]
    assert all(r.status is RequestStatus.COMPLETED for r in out)


def test_drain_under_load_finishes_inflight_sheds_queue(served):
    _, _, model, params = served
    log = EventLog.memory()
    eng = ContinuousEngine(model, params, n_slots=1, max_len=32, telemetry=log)
    flag = {"drain": False}
    out = eng.generate(_reqs(serve, 4, max_new=6),
                       on_token=lambda r, t: flag.__setitem__("drain", True),
                       should_drain=lambda: flag["drain"], drain_grace_s=30.0)
    assert _counts(out) == {"completed": 1, "shed": 3, "timed_out": 0, "failed": 0}
    assert all(r.shed_reason == "drain" for r in out[1:])
    drains = [e for e in log.events if e["event"] == "serve_drain"]
    assert len(drains) == 1 and drains[0]["queued"] == 3 and drains[0]["in_flight"] == 1
    assert eng.pool.n_free == 1


def test_drain_grace_expiry_sheds_inflight(served):
    _, _, model, params = served
    eng = ContinuousEngine(model, params, n_slots=1, max_len=64)
    flag = {"drain": False}
    out = eng.generate(_reqs(serve, 2, max_new=40),
                       on_token=lambda r, t: flag.__setitem__("drain", True),
                       should_drain=lambda: flag["drain"], drain_grace_s=0.0)
    assert all(r.status is RequestStatus.SHED for r in out)
    assert out[0].out_tokens
    assert eng.pool.n_free == 1


def test_nonterminal_roster_raises(served):
    _, _, model, params = served
    eng = ContinuousEngine(model, params, n_slots=1, max_len=32)
    eng.submit(ServeRequest(np.zeros(4, np.int32), max_new_tokens=2))
    eng.scheduler._queue.clear()   # a scheduler that loses a request
    eng.scheduler._keys.clear()
    with pytest.raises(RuntimeError, match="non-terminal"):
        eng.generate()


def test_launch_serve_faults_and_telemetry_on_cpu(tmp_path, capsys):
    """The launcher's reliability flags and telemetry: one terminal state a
    request, valid events, a RUN_REPORT.json whose serve section names the
    device."""
    import json

    from repro_torch.launch import serve as launch_serve
    from repro_torch.telemetry import read_events

    launch_serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--continuous",
                       "--slots", "2", "--requests", "4", "--prompt-len", "6", "--max-new",
                       "4", "--inject-faults", "sample_nan@1,slot_corrupt@2:persist",
                       "--telemetry-dir", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[-2].startswith("faults fired")
    events = read_events(tmp_path / "events.jsonl")
    assert events[0]["event"] == "run_start" and events[-1]["event"] == "run_end"
    report = json.loads((tmp_path / "RUN_REPORT.json").read_text())
    assert report["serve"]["by_status"] == {"completed": 3, "shed": 0, "timed_out": 0,
                                            "failed": 1}
    assert report["serve"]["stats"]["device"] == "cpu"
