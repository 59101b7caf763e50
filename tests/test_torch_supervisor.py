"""The port's loss-spike supervisor and preemption handler
(``repro_torch.train.{supervisor,preempt}``) against the JAX package's:
the spike detector's two-sided contract on the reference's grids, the same
trips, ``last_good`` and diagnostics from one loss sequence, and the
flag-only SIGTERM handler."""
import math
import os
import signal

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

from repro.train import DivergenceError as JaxDivergenceError
from repro.train import SpikeDetector as JaxSpikeDetector
from repro.train import SupervisorConfig as JaxSupervisorConfig
from repro.train import TrainingSupervisor as JaxTrainingSupervisor
from repro_torch.train import (
    DivergenceError,
    PreemptionHandler,
    SpikeDetector,
    SupervisorConfig,
    TrainingSupervisor,
)


def _fresh_detector():
    return SpikeDetector(window=32, zmax=8.0, min_history=8, min_rel_jump=0.5)


# ---------------------------------------------------------------------------
# spike detector: the reference's two-sided properties and grid cases
# ---------------------------------------------------------------------------

PROPERTY = hypothesis.settings(deadline=None, max_examples=25, derandomize=True, database=None,
                               suppress_health_check=[hypothesis.HealthCheck.too_slow])


@PROPERTY
@hypothesis.given(
    base=st.floats(0.5, 10.0, allow_nan=False, allow_subnormal=False),
    noise=st.lists(st.floats(-0.1, 0.1, allow_nan=False, allow_subnormal=False),
                   min_size=20, max_size=80),
)
def test_detector_never_trips_on_stationary_noise(base, noise):
    """Loss wobbling within ±10% of a stationary level never trips, in the
    port as in the reference."""
    det, ref = _fresh_detector(), JaxSpikeDetector(window=32, zmax=8.0, min_history=8,
                                                   min_rel_jump=0.5)
    for eps in noise:
        assert not det.observe(base * (1.0 + eps))
        assert not ref.observe(base * (1.0 + eps))


@PROPERTY
@hypothesis.given(
    base=st.floats(0.5, 10.0, allow_nan=False, allow_subnormal=False),
    noise=st.lists(st.floats(-0.05, 0.05, allow_nan=False, allow_subnormal=False),
                   min_size=12, max_size=40),
    factor=st.floats(10.0, 1e4, allow_nan=False, allow_subnormal=False),
)
def test_detector_always_trips_on_spike(base, noise, factor):
    """A >= 10x excursion after a settled window always trips."""
    det = _fresh_detector()
    for eps in noise:
        det.observe(base * (1.0 + eps))
    assert det.observe(base * factor)


@pytest.mark.parametrize("base", [0.5, 1.0, 2.7, 10.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_never_trips_on_stationary_noise_grid(base, seed):
    rng = np.random.default_rng(seed)
    det = _fresh_detector()
    for eps in rng.uniform(-0.1, 0.1, size=60):
        assert not det.observe(base * (1.0 + float(eps)))


@pytest.mark.parametrize("base", [0.5, 1.0, 2.7, 10.0])
@pytest.mark.parametrize("factor", [10.0, 100.0, 1e4])
def test_detector_always_trips_on_spike_grid(base, factor):
    rng = np.random.default_rng(0)
    det = _fresh_detector()
    for eps in rng.uniform(-0.05, 0.05, size=20):
        det.observe(base * (1.0 + float(eps)))
    assert det.observe(base * factor)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_detector_trips_on_nonfinite_loss(bad):
    det = _fresh_detector()
    for _ in range(12):
        det.observe(2.7)
    assert det.observe(bad)


def test_detector_spike_not_fed_into_window_and_zero_mad():
    det = _fresh_detector()
    for _ in range(12):
        det.observe(1.0)
    assert det.observe(50.0) and det.observe(50.0)
    det = _fresh_detector()
    for _ in range(12):
        det.observe(2.0)
    assert not det.observe(2.0 + 1e-6)
    assert det.observe(50.0)
    with pytest.raises(ValueError, match="min_history"):
        SpikeDetector(min_history=1)


# ---------------------------------------------------------------------------
# the same decisions as the reference on one sequence
# ---------------------------------------------------------------------------

def _sequence(seed: int):
    """(step, loss, skipped_total) observations: noisy decay with spikes,
    a NaN, guard skips in a row, and a healthy tail."""
    rng = np.random.default_rng(seed)
    obs, step, skipped = [], 0, 0
    for i in range(80):
        loss = 5.0 * math.exp(-i / 60) * (1 + float(rng.uniform(-0.05, 0.05)))
        if i in (20, 47):
            loss *= 30.0
        if i == 33:
            loss = float("nan")
        if 55 <= i < 55 + (seed % 4):
            skipped += 1
        else:
            step += 1
        obs.append((step, loss, skipped))
    return obs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cfg", [dict(), dict(spike_window=8, min_history=3, skip_budget=2),
                                 dict(spike_zmax=3.0, min_rel_jump=0.1, max_rollbacks=1)])
def test_supervisor_decisions_match_reference(seed, cfg):
    """Trips, ``last_good``, the rollback budget and the diagnostics, step
    for step, with a rollback noted (and the state re-synced) on each trip."""
    port, ref = TrainingSupervisor(SupervisorConfig(**cfg)), \
        JaxTrainingSupervisor(JaxSupervisorConfig(**cfg))
    trips = []
    for step, loss, skipped in _sequence(seed):
        a, b = port.observe(step, loss, skipped), ref.observe(step, loss, skipped)
        assert a == b and port.last_good == ref.last_good
        if a is None:
            continue
        trips.append(a)
        errs = []
        for sup in (port, ref):
            try:
                sup.note_rollback(a)
            except (DivergenceError, JaxDivergenceError) as e:
                errs.append((type(e).__name__, str(e), e.diagnostics))
            sup.after_rollback(skipped)
        assert len(errs) in (0, 2) and (not errs or errs[0] == errs[1])
        da, db = port.diagnostics(a), ref.diagnostics(a)
        assert da.keys() == db.keys()
        for k in da:
            if isinstance(da[k], float) and math.isnan(da[k]):
                assert math.isnan(db[k]), k
            else:
                assert da[k] == db[k], k
    assert trips and {"loss_spike", "nonfinite_loss"} <= set(trips)
    assert port.rollbacks == ref.rollbacks
    assert port.detector.stats() == ref.detector.stats()


def test_detector_matches_reference_statistics():
    rng = np.random.default_rng(5)
    port, ref = SpikeDetector(window=16, min_history=4), JaxSpikeDetector(window=16,
                                                                        min_history=4)
    for x in list(rng.normal(3.0, 0.2, 40)) + [30.0, float("inf"), 3.1]:
        assert port.observe(x) == ref.observe(x)
        if len(port._window) >= 1:
            assert port.stats() == ref.stats()


# ---------------------------------------------------------------------------
# supervisor semantics (the reference's unit cases)
# ---------------------------------------------------------------------------

def test_supervisor_validates_checkpoints_lazily():
    sup = TrainingSupervisor(SupervisorConfig(min_history=2))
    assert sup.last_good == -1
    assert sup.observe(1, 1.0, 0) is None and sup.last_good == 0
    assert sup.observe(5, 1.0, 0) is None and sup.last_good == 4
    assert TrainingSupervisor(SupervisorConfig()).observe(1, float("nan"), 0) == \
        "nonfinite_loss"


def test_supervisor_consecutive_skip_budget():
    sup = TrainingSupervisor(SupervisorConfig(skip_budget=3))
    assert sup.observe(1, 1.0, 1) is None
    assert sup.observe(1, 1.0, 2) is None
    assert sup.observe(1, 1.0, 3) == "nonfinite_budget"
    sup2 = TrainingSupervisor(SupervisorConfig(skip_budget=3))
    sup2.observe(1, 1.0, 1)
    sup2.observe(1, 1.0, 2)
    sup2.observe(2, 1.0, 2)   # a healthy step resets the streak
    assert sup2.observe(2, 1.0, 3) is None


def test_supervisor_rollback_budget_raises():
    sup = TrainingSupervisor(SupervisorConfig(max_rollbacks=2))
    sup.note_rollback("loss_spike")
    sup.note_rollback("loss_spike")
    with pytest.raises(DivergenceError) as ei:
        sup.note_rollback("loss_spike")
    assert ei.value.diagnostics["rollbacks"] == 3
    assert isinstance(ei.value, RuntimeError)


# ---------------------------------------------------------------------------
# preemption handler
# ---------------------------------------------------------------------------

def test_preemption_handler_sets_flag_once_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler(enabled=True, signals=(signal.SIGTERM,)) as h:
        assert not h.triggered and h.signal_name == "none"
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.triggered and h.signal_name == "SIGTERM"
        with pytest.raises(KeyboardInterrupt):   # a second delivery escalates
            os.kill(os.getpid(), signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) == before


def test_preemption_handler_disabled_is_noop():
    before = signal.getsignal(signal.SIGINT)
    with PreemptionHandler(enabled=False) as h:
        assert not h.triggered
        assert signal.getsignal(signal.SIGINT) == before
