"""The non-finite guard of the port against the JAX package's, at bert-smoke
size on the CPU (the plain version of K1/K2, which takes the same ``ok``
flag as the kernels).

A skipped step is held bit for bit: every param, moment and counter equal
to before the step.  Where a finite step is compared across the two
frameworks, the bounds are ``tests/test_torch_train.py``'s fp32 bounds
(loss and update norm to 1e-4 relative), and the LAMB state at
``tests/test_torch_lamb.py``'s (``F32``: 1e-5 relative, 1e-6 absolute).
"""
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
from repro.kernels import fused_lamb_init as jax_fused_lamb_init
from repro.kernels import make_fused_lamb_step as jax_make_fused_lamb_step
from repro.models import build_model as jax_build_model
from repro.train import FaultInjector as JaxFaultInjector
from repro.train import FaultSpec as JaxFaultSpec
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.data import DataPipeline
from repro_torch.kernels import fused_lamb_init, make_fused_lamb_step
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax, state_from_jax, train_state_from_jax, \
    train_state_to_numpy
from repro_torch.train import GUARD_KEY, FaultInjector, FaultSpec, Trainer, \
    make_train_step, tree_all_finite
from repro_torch.train.faults import FAULT_PREFIX, split_faults


F32 = dict(rtol=1e-5, atol=1e-6)
OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)
BATCH, SEQ = 8, 32

VARIANTS = {
    "accum1": dict(),
    "accum2": dict(accum_steps=2),
    "bf16": dict(accum_steps=2, precision="bf16"),
}


def _tc(**kw):
    base = dict(optimizer="lamb", use_fused_lamb=True, learning_rate=1e-3,
                skip_nonfinite=True)
    base.update(kw)
    return TrainConfig(**base)


def _batch(seed=0):
    b = next(jax_synthetic.batch_iterator(jax_bert.smoke(), BATCH, SEQ, seed=seed))
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_step(tc, cfg=None):
    model = build_model(cfg or bert_large.smoke())
    init, step = make_train_step(model, tc)
    return step, init(0, "cpu")


def _snapshot(state):
    return {k: v.copy() for k, v in train_state_to_numpy(state).items()}


def _assert_same(state, before):
    after = train_state_to_numpy(state)
    assert list(after) == list(before)
    for k, v in before.items():
        if k in ("step", "skipped"):
            continue
        assert after[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("kind", ["grad_nan", "grad_inf"])
def test_skip_step_leaves_state_bit_identical(variant, kind):
    """A poisoned step with the guard on writes nothing: every param, moment
    and optimizer counter bit for bit as before, ``step`` not advanced,
    ``skipped`` + 1 (as ``tests/test_fault_tolerance.py`` holds the JAX
    step)."""
    step, state = _port_step(_tc(**VARIANTS[variant]))
    before = _snapshot(state)
    state, metrics = step(state, FaultInjector([FaultSpec(kind, at=0)]).stamp(_batch(), 0))
    assert float(metrics[GUARD_KEY]) == 1.0
    assert float(metrics["update_norm"]) == 0.0
    assert int(state.step) == 0 and int(state.skipped) == 1
    _assert_same(state, before)


def test_skip_step_matches_jax_on_the_same_state():
    """The JAX step and the port's, from the same state and poisoned batch,
    both leave the state as it was: equal to each other bit for bit."""
    jcfg = jax_bert.smoke().replace(**OFF)
    jinit, jstep = jax_make_train_step(
        jax_build_model(jcfg), JaxTrainConfig(optimizer="lamb", use_fused_lamb=True,
                                              learning_rate=1e-3, skip_nonfinite=True))
    jstate = jax.jit(jinit)(jax.random.key(0))
    batch = next(jax_synthetic.batch_iterator(jcfg, BATCH, SEQ, seed=0))
    jbatch = JaxFaultInjector([JaxFaultSpec("grad_nan", at=0)]).stamp(dict(batch), 0)
    jstate, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in jbatch.items()})
    step, _ = _port_step(_tc(), bert_large.smoke().replace(**OFF))
    state = train_state_from_jax(jax.jit(jinit)(jax.random.key(0)))
    tbatch = FaultInjector([FaultSpec("grad_nan", at=0)]).stamp(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    state, m = step(state, tbatch)
    assert float(m[GUARD_KEY]) == float(jm["nonfinite/skip"]) == 1.0
    port, ref = train_state_to_numpy(state), train_state_to_numpy(train_state_from_jax(jstate))
    for k in ref:
        assert port[k].tobytes() == ref[k].tobytes(), k
    assert int(state.skipped) == int(jstate.skipped) == 1


def test_clean_step_advances_normally_with_guard():
    """From the same weights and batch, a clean step with the guard on takes
    the same step as JAX's: guard 0, ``step`` 1, loss and update norm at the
    fp32 bounds."""
    jcfg = jax_bert.smoke().replace(**OFF)
    jtc = JaxTrainConfig(optimizer="lamb", use_fused_lamb=True, learning_rate=0.01,
                         skip_nonfinite=True, fused_backend="interpret")
    jinit, jstep = jax_make_train_step(jax_build_model(jcfg), jtc,
                                       jax_warmup_poly_decay(0.01, 10, 0))
    jstate = jax.jit(jinit)(jax.random.key(0))
    model = build_model(bert_large.smoke().replace(**OFF))
    _, step = make_train_step(model, _tc(learning_rate=0.01), warmup_poly_decay(0.01, 10, 0))
    state = train_state_from_jax(jstate)
    batch = next(jax_synthetic.batch_iterator(jcfg, BATCH, SEQ, seed=0))
    jstate, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(m[GUARD_KEY]) == float(jm[GUARD_KEY]) == 0.0
    assert int(state.step) == int(jstate.step) == 1 and int(state.skipped) == 0
    assert int(state.opt_state.count) == int(state.opt_state.sched_count) == 1
    for k in ("loss/total", "update_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert float(m["update_norm"]) > 0.0


def test_guard_off_propagates_nan():
    """Without the guard a poisoned gradient corrupts the params: the
    failure the guard exists to stop."""
    step, state = _port_step(_tc(skip_nonfinite=False))
    state, metrics = step(state, FaultInjector([FaultSpec("grad_nan", at=0)]).stamp(_batch(), 0))
    assert GUARD_KEY not in metrics
    assert not bool(tree_all_finite(state.params))
    assert int(state.step) == 1


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_tree_all_finite_sees_every_leaf_and_the_loss(bad):
    tree = {"a": torch.zeros(3, 4), "b": torch.ones(5, dtype=torch.bfloat16),
            "i": torch.arange(4, dtype=torch.int32)}
    assert bool(tree_all_finite(tree, torch.tensor(1.0)))
    assert not bool(tree_all_finite(tree, torch.tensor(bad)))
    for k in ("a", "b"):
        poisoned = dict(tree)
        poisoned[k] = tree[k].clone()
        poisoned[k].view(-1)[-1] = bad
        assert not bool(tree_all_finite(poisoned, None)), k


def test_nan_skip_matches_dropped_ordinal_run():
    """Injected-and-skipped equals the clean run whose stream omits the
    poisoned batch, bit for bit (the JAX suite's gate, on the port)."""
    model = build_model(bert_large.smoke())
    tc = _tc()
    cfg = model.cfg

    def data():
        return DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0)

    tr = Trainer(model, tc, device="cpu", log_every=1000, log_fn=lambda s: None)
    tr.fit(FaultInjector([FaultSpec("grad_nan", at=1)]).wrap(data()), 4)

    def drop(it, k):
        for i, b in enumerate(it):
            if i != k:
                yield b

    clean = Trainer(model, tc, device="cpu", log_every=1000, log_fn=lambda s: None)
    clean.fit(drop(data(), 1), 3)
    assert int(tr.state.skipped) == 1 and tr.history[-1]["skipped_total"] == 1
    assert int(tr.state.step) == int(clean.state.step) == 3
    a, b = train_state_to_numpy(tr.state), train_state_to_numpy(clean.state)
    for k in a:
        if k != "skipped":
            assert a[k].tobytes() == b[k].tobytes(), k


def test_fault_channels_do_not_leak_into_loss():
    """A stamped-but-inactive batch trains bit-identically to a clean one."""
    step, s1 = _port_step(_tc())
    _, s2 = _port_step(_tc())
    batch = _batch()
    s1, m1 = step(s1, FaultInjector([FaultSpec("grad_nan", at=99)]).stamp(dict(batch), 0))
    s2, m2 = step(s2, batch)
    assert float(m1["loss/total"]) == float(m2["loss/total"])
    a, b = train_state_to_numpy(s1), train_state_to_numpy(s2)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_injector_is_deterministic_once_and_matches_jax():
    spec = [FaultSpec("grad_nan", at=2), FaultSpec("grad_inf", at=-1, once=False),
            FaultSpec("loss_spike", at=1, scale=5.0)]
    jspec = [JaxFaultSpec(f.kind, f.at, f.scale, f.once) for f in spec]
    batches = [{"x": np.zeros((4,), np.float32)} for _ in range(4)]
    inj, jinj = FaultInjector(spec), JaxFaultInjector(jspec)
    for i, b in enumerate(batches):
        port = inj.stamp({"x": torch.from_numpy(b["x"])}, i)
        ref = jinj.stamp(dict(b), i)
        assert set(port) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(port[k].numpy(), ref[k], err_msg=k)
    replay = inj.stamp({"x": torch.zeros(4)}, 2)   # once: no second firing
    assert float(replay[FAULT_PREFIX + "grad_nan"][0]) == 0.0
    poisoned = FaultInjector([FaultSpec("batch_nan", at=0)]).stamp({"x": torch.zeros(4)}, 0)
    assert torch.isnan(poisoned["x"][0]) and not torch.isnan(poisoned["x"][1:]).any()
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("grad_zero", at=0)
    clean = {"tokens": torch.zeros((2, 4), dtype=torch.int32)}
    b, f = split_faults(clean)
    assert b is clean and f == {}


def _lamb_steps(with_ok):
    """Two fused LAMB steps of each package over bert-smoke's tree with
    ``with_aux``, from the same weights and gradients: a taken step, then
    (with ``with_ok``) one that ``ok`` false skips."""
    jcfg = jax_bert.smoke().replace(**OFF)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(bert_large.smoke().replace(**OFF))
    params = params_from_jax(jparams)
    state, jstate = fused_lamb_init(params), jax_fused_lamb_init(jparams)
    kw = dict(weight_decay=0.01, grad_clip_norm=1.0, phi_bounds=(0.01, 10.0))
    jstep = jax_make_fused_lamb_step(
        jax_warmup_poly_decay(0.01, 10, 0), wd_mask=jmodel.wd_mask(),
        trust_mask=jmodel.trust_mask(), layer_axes=jmodel.layer_axes(),
        mode="interpret", with_aux=True, **kw)
    step = make_fused_lamb_step(
        warmup_poly_decay(0.01, 10, 0), wd_mask=model.wd_mask(),
        trust_mask=model.trust_mask(), layer_axes=model.layer_axes(), with_aux=True, **kw)
    rng = np.random.default_rng(5)
    out = []
    for ok in ([True, False] if with_ok else [None]):
        gnp = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)
        jok = None if ok is None else jnp.asarray(ok)
        before = {k: v.clone() for k, v in params.items()}
        jparams, jstate, jratio = jstep(jparams, jax.tree.map(jnp.asarray, gnp), jstate, ok=jok)
        dsq, ratio = step(params, params_from_jax(gnp), state,
                          ok=None if ok is None else torch.tensor(ok))
        out.append((ok, before, dsq, ratio, params_from_jax(jratio)))
    return params, state, jparams, jstate, out


@pytest.mark.parametrize("with_ok", [False, True])
def test_with_aux_ratios_and_ok_match_jax(with_ok):
    """``with_aux`` returns each leaf's applied trust ratio before the lr fold,
    equal to JAX ``make_fused_lamb_step(..., with_aux=True)`` (interpret) at
    F32; ``ok`` false writes no leaf and advances neither counter, as the
    reference's where-select does."""
    params, state, jparams, jstate, out = _lamb_steps(with_ok)
    for ok, before, dsq, ratio, jratio in out:
        assert list(ratio) == list(params)
        for k in params:
            assert ratio[k].shape == jratio[k].shape, k
            np.testing.assert_allclose(ratio[k].numpy(), jratio[k].numpy(), **F32, err_msg=k)
        if ok is False:
            assert float(dsq) == 0.0
            for k in params:
                assert torch.equal(params[k], before[k]), k
    ref = state_from_jax(jstate)
    assert int(state.count) == int(ref.count) == 1
    assert int(state.sched_count) == int(ref.sched_count) == 1
    for k, v in params_from_jax(jparams).items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), **F32, err_msg=k)
        np.testing.assert_allclose(state.mu[k].numpy(), ref.mu[k].numpy(), **F32, err_msg=k)
        np.testing.assert_allclose(state.nu[k].numpy(), ref.nu[k].numpy(), **F32, err_msg=k)
