"""The slice end to end: bert-smoke train steps of the port against the JAX
package's (fused LAMB: Pallas LAMB in interpret mode; every other
optimizer: its transform chain; flash and fused CE off), and the port's
launcher."""
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
from repro.train import FaultInjector as JaxFaultInjector
from repro.train import FaultSpec as JaxFaultSpec
from repro.train.step import _microbatch_grads as jax_microbatch_grads
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.nn import flatten, params_from_jax, state_from_jax, train_state_from_jax, \
    train_state_to_numpy
from repro_torch.train import GUARD_KEY, FaultInjector, FaultSpec, TrainState, \
    make_loss_fn, make_train_step
from repro_torch.train.step import TRUST_KEYS, _microbatch_grads


OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)
SMOKE = ["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "16",
         "--fused-lamb", "--no-flash", "--no-fused-ce", "--steps", "2"]
OPTIMIZERS = ["lamb", "lans", "lars", "nlamb", "nnlamb", "adam", "adamw", "adagrad",
              "momentum"]


def _run_both(accum: int, precision: str, activation_dtype: str, steps: int = 3,
              optimizer: str = "lamb", use_fused_lamb: bool = True,
              resync: bool = False, **extra):
    jcfg = jax_bert.smoke().replace(activation_dtype=activation_dtype, **OFF)
    cfg = bert_large.smoke().replace(activation_dtype=activation_dtype, **OFF)
    kw = dict(optimizer=optimizer, use_fused_lamb=use_fused_lamb, accum_steps=accum,
              precision=precision, learning_rate=0.01, **extra)
    jmodel = jax_build_model(jcfg)
    jinit, jstep = jax_make_train_step(
        jmodel, JaxTrainConfig(fused_backend="interpret", **kw),
        jax_warmup_poly_decay(0.01, 10, 2))
    jstep = jax.jit(jstep)
    _, step = make_train_step(build_model(cfg), TrainConfig(**kw),
                              warmup_poly_decay(0.01, 10, 2))
    jstate = jinit(jax.random.key(0))
    state = TrainState(params_from_jax(jstate.params), state_from_jax(jstate.opt_state))
    data = jax_synthetic.batch_iterator(jcfg, 8, 32, seed=1)
    losses = []
    for _ in range(steps):
        batch = next(data)
        if resync:   # each step from the JAX package's state
            state = train_state_from_jax(jstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append({k: (float(m[k]), float(jm[k])) for k in jm})
    return state, jstate, losses


def _assert_fp32_parity(state, jstate, losses):
    """The fp32 bounds of ``test_train_steps_match_jax_fp32``."""
    for m in losses:
        for k in ("loss/total", "loss/ce", "update_norm", "tokens/supervised"):
            np.testing.assert_allclose(*m[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(*m["grad_norm"], rtol=1e-3)
        np.testing.assert_allclose(*m["accuracy"], atol=1e-6)
    for k, v in params_from_jax(jstate.params).items():
        diff = (state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax_fp32(accum):
    state, jstate, losses = _run_both(accum, "fp32", "float32")
    for m in losses:
        for k in ("loss/total", "loss/ce", "update_norm", "tokens/supervised"):
            np.testing.assert_allclose(*m[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(*m["grad_norm"], rtol=1e-3)
        np.testing.assert_allclose(*m["accuracy"], atol=1e-6)
    assert losses[0]["update_norm"][0] == 0.0  # warmup: lr 0 at the first step
    assert losses[-1]["update_norm"][0] > 0.0
    assert state.step == 3 and int(state.opt_state.count) == 3
    # The two frameworks' gradients differ by fp32 rounding, ~1e-6 of the
    # gradient norm in every element.  bert-smoke's attention is saturated
    # at init, so that noise is a large relative error on the elements whose
    # gradient is small, and LAMB's direction m̂/√v̂ is scale-free: those
    # elements' updates (lr·ratio·u, ~1e-2 here) differ by up to ~1%.  So
    # nearly every weight agrees to 1e-5 and the few such weights to 1e-3.
    for k, v in params_from_jax(jstate.params).items():
        diff = (state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_unfused_train_steps_match_jax(optimizer):
    """Each ``tc.optimizer`` as a transform chain (LAMB without
    ``use_fused_lamb``), fp32, accumulation 2, three steps on the same
    batches, each taken by both packages from the JAX package's state (so
    moments and counters are past 0), at the fp32 bounds below; the state
    has the reference's leaf paths and its counters.

    Each step starts from JAX's state because, over steps, the two
    frameworks' fp32 gradients drift apart on saturated bert-smoke (see
    ``test_train_steps_match_jax_fp32``), and the optimizers without a
    clip or a trust ratio (Adam, Adagrad, momentum, and N-LAMB's and the
    baselines' norm scales) move weights whose gradient is at that noise
    by a full lr-sized step: from a shared state one step's weights agree
    to 1e-5 in all but < 1e-4 of elements, over three chained steps up to
    29% of a norm-scale leaf's elements are off by more.
    """
    state, jstate, losses = _run_both(2, "fp32", "float32", optimizer=optimizer,
                                      use_fused_lamb=False, resync=True)
    _assert_fp32_parity(state, jstate, losses)
    got, want = train_state_to_numpy(state), train_state_to_numpy(train_state_from_jax(jstate))
    assert list(got) == list(want)
    counters = [k for k, v in want.items() if v.dtype == np.int32]
    assert "step" in counters and len(counters) >= 3
    for k in counters:
        assert got[k] == want[k], k


@pytest.mark.parametrize("fused", [False, True])
def test_log_trust_ratios_match_jax(fused):
    """``log_trust_ratios``: the ``trust_ratio/{min,max,mean}`` summary of
    phi(||x||)/||Δx|| on the fused-direct path and on the chain, equal to
    the JAX package's at the fp32 bounds (the first step has lr 0: every
    ratio is 1)."""
    state, jstate, losses = _run_both(1, "fp32", "float32", use_fused_lamb=fused,
                                      log_trust_ratios=True)
    _assert_fp32_parity(state, jstate, losses)
    for m in losses:
        for k in TRUST_KEYS:
            np.testing.assert_allclose(*m[k], rtol=1e-4, err_msg=k)
    assert losses[0]["trust_ratio/min"][0] == losses[0]["trust_ratio/max"][0] == 1.0
    assert losses[-1]["trust_ratio/max"][0] > 1.0


def test_fused_direct_matches_unfused_lamb_in_the_port():
    """Fused-direct LAMB (K1/K2's plain version here) and the ``core.lamb``
    chain from the same weights, three guarded steps on the same batches:
    every param and moment within the reference's own fused-against-unfused
    bound (``tests/test_large_batch.py``: rtol 2e-4, atol 2e-5), the
    counters equal."""
    model = build_model(bert_large.smoke().replace(activation_dtype="float32", **OFF))
    kw = dict(optimizer="lamb", accum_steps=2, learning_rate=0.01, skip_nonfinite=True)
    sched = warmup_poly_decay(0.01, 10, 1)
    init_f, step_f = make_train_step(model, TrainConfig(use_fused_lamb=True, **kw), sched)
    init_u, step_u = make_train_step(model, TrainConfig(**kw), sched)
    fused, chain = init_f(0, "cpu"), init_u(0, "cpu")
    data = jax_synthetic.batch_iterator(model.cfg, 8, 32, seed=1)
    for _ in range(3):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        fused, mf = step_f(fused, batch)
        chain, mu = step_u(chain, batch)
        for k in ("loss/total", "update_norm", GUARD_KEY):
            np.testing.assert_allclose(float(mf[k]), float(mu[k]), rtol=2e-4, err_msg=k)
    adam, sched_state = chain.opt_state[1], chain.opt_state[-1]
    assert int(fused.opt_state.count) == int(adam.count) == 3
    assert int(fused.opt_state.sched_count) == int(sched_state.count) == 3
    assert int(fused.step) == int(chain.step) == 3
    for a, b in ((fused.params, chain.params), (fused.opt_state.mu, adam.mu),
                 (fused.opt_state.nu, adam.nu)):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("optimizer", ["lamb", "lars", "adagrad"])
def test_unfused_guard_skips_bit_identical_like_jax(optimizer):
    """A poisoned step on the chain with the guard on: every param and
    every chain-state leaf (schedule and moment counters included) bit for
    bit as before, ``step`` not advanced and ``skipped`` + 1, as the JAX
    step does from the same state and batch."""
    jcfg = jax_bert.smoke().replace(**OFF)
    kw = dict(optimizer=optimizer, learning_rate=1e-3, skip_nonfinite=True)
    jinit, jstep = jax_make_train_step(jax_build_model(jcfg), JaxTrainConfig(**kw))
    jstep = jax.jit(jstep)
    _, step = make_train_step(build_model(bert_large.smoke().replace(**OFF)), TrainConfig(**kw))
    data = jax_synthetic.batch_iterator(jcfg, 8, 32, seed=0)
    clean = next(data)
    jstate, _ = jstep(jax.jit(jinit)(jax.random.key(0)),
                      {k: jnp.asarray(v) for k, v in clean.items()})
    state = train_state_from_jax(jstate)    # moments and counters past 0
    before = {k: v.copy() for k, v in train_state_to_numpy(state).items()}
    batch = next(data)
    jb = JaxFaultInjector([JaxFaultSpec("grad_nan", at=0)]).stamp(dict(batch), 0)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
    tb = FaultInjector([FaultSpec("grad_nan", at=0)]).stamp(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    state, m = step(state, tb)
    assert float(m[GUARD_KEY]) == float(jm[GUARD_KEY]) == 1.0
    assert float(m["update_norm"]) == float(jm["update_norm"]) == 0.0
    got, ref = train_state_to_numpy(state), train_state_to_numpy(train_state_from_jax(jstate))
    assert list(got) == list(ref) == list(before)
    for k in before:
        if k != "skipped":
            assert got[k].tobytes() == before[k].tobytes() == ref[k].tobytes(), k
    assert int(state.step) == int(jstate.step) == 1
    assert int(state.skipped) == int(jstate.skipped) == 1
    assert any(k.endswith("/count") for k in before)   # a chain counter was held


def test_fused_lamb_kernel_config_takes_the_fused_path():
    """``cfg.use_fused_lamb_kernel`` alone selects fused-direct LAMB, as the
    reference's ``_wants_fused`` does: the state is a ``FusedLambState`` and
    the steps equal those under ``tc.use_fused_lamb`` bit for bit."""
    cfg = bert_large.smoke().replace(**OFF)
    batch = {k: torch.from_numpy(v) for k, v in next(
        jax_synthetic.batch_iterator(cfg, 8, 16, seed=0)).items()}
    states = []
    for c, fused in ((cfg.replace(use_fused_lamb_kernel=True), False), (cfg, True)):
        init, step = make_train_step(build_model(c), TrainConfig(
            optimizer="lamb", use_fused_lamb=fused, learning_rate=0.01))
        state, _ = step(init(0, "cpu"), batch)
        states.append(train_state_to_numpy(state))
    assert "opt_state/sched_count" in states[0]
    assert list(states[0]) == list(states[1])
    for k in states[0]:
        assert states[0][k].tobytes() == states[1][k].tobytes(), k
    with pytest.raises(ValueError, match="fused LAMB"):
        make_train_step(build_model(cfg.replace(use_fused_lamb_kernel=True)),
                        TrainConfig(optimizer="lamb", bias_correction=False))


def test_record_trust_ratios_and_unknown_optimizer_raise():
    """``record_trust_ratios`` is ported (it no longer raises: the records
    land under ``PER_LAYER_KEY``, ``tests/test_torch_telemetry.py``); an
    unknown optimizer still raises."""
    from repro_torch.telemetry.trust import PER_LAYER_KEY

    model = build_model(bert_large.smoke().replace(**OFF))
    init, step = make_train_step(model, TrainConfig(record_trust_ratios=True))
    batch = {k: torch.from_numpy(v) for k, v in next(
        jax_synthetic.batch_iterator(model.cfg, 4, 16, seed=0)).items()}
    _, m = step(init(0, "cpu"), batch)
    assert set(m[PER_LAYER_KEY]) == {"trust_ratio", "param_norm", "update_norm"}
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_train_step(model, TrainConfig(optimizer="rmsprop"))


def test_train_steps_match_jax_bf16():
    state, jstate, losses = _run_both(2, "bf16", "bfloat16")
    # bf16 activations and a bf16 copy of the weights: the losses (fp32
    # means over fp32 log-softmaxes of bf16 logits) agree to a few 1e-4;
    # the update norm is ~lr·‖x‖ per layer under LAMB, so it agrees closely
    # whatever the gradients' rounding.  The gradients themselves are held
    # to the fp32 truth in the next test.
    for m in losses:
        np.testing.assert_allclose(*m["loss/total"], rtol=2e-3)
        np.testing.assert_allclose(*m["update_norm"], rtol=1e-3)
    np.testing.assert_allclose(*losses[0]["grad_norm"], rtol=5e-2)  # same weights
    assert all(v.dtype == torch.float32 for v in state.params.values())
    assert all(torch.isfinite(v).all() for v in state.params.values())


def test_bf16_gradients_match_jax_within_bf16_noise():
    """From the same weights, the port's bf16 gradient is as close to the
    fp32 gradient as the JAX package's bf16 gradient is, and close to it.

    bert-smoke's attention is saturated at init (its q/k weights have
    std 1/2), so bf16 rounding of the scores changes which keys win: both
    bf16 gradients are 50–80% (relative L2) away from the fp32 gradient,
    while the two agree to ~10%.
    """
    jcfg = jax_bert.smoke().replace(**OFF)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = next(jax_synthetic.batch_iterator(jcfg, 8, 32, seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_grads(cfg, params):
        g = jax.grad(lambda p: jax_make_loss_fn(jax_build_model(cfg))(p, jb)[0])(params)
        return {k: np.asarray(v, np.float32) for k, v in flatten(g).items()}

    g32 = jax_grads(jcfg.replace(activation_dtype="float32"), jparams)
    g16 = jax_grads(jcfg, jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams))
    params = {k: v.to(torch.bfloat16).requires_grad_()
              for k, v in params_from_jax(jparams).items()}
    model = build_model(bert_large.smoke().replace(**OFF))
    grads, _ = _microbatch_grads(make_loss_fn(model), params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    for k, ref in g32.items():
        port = grads[k].numpy()
        scale = np.linalg.norm(ref)
        assert np.linalg.norm(port - ref) <= 1.1 * np.linalg.norm(g16[k] - ref) + 1e-6, k
        assert np.linalg.norm(port - g16[k]) <= 0.15 * scale + 1e-6, k


def test_accumulation_without_token_count_matches_jax():
    """A loss that reports no ``tokens/supervised`` averages its microbatches
    uniformly, as the JAX package's ``_microbatch_grads`` does, and neither
    package writes the key into the metrics.  A least-squares loss on the
    same numpy weights and batch, accumulation 2, at the file's fp32 bounds."""
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((6, 3)).astype(np.float32)
    b0 = rng.standard_normal((3,)).astype(np.float32)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    x[4:] *= 3.0   # the two microbatches' losses and gradients differ

    def jloss(p, b):
        err = b["x"] @ p["w"] + p["b"] - b["y"]
        lo = jnp.mean(err**2)
        return lo, {"loss/total": lo, "loss/max": jnp.max(jnp.abs(err))}

    def tloss(p, b):
        err = b["x"] @ p["w"] + p["b"] - b["y"]
        lo = torch.mean(err**2)
        return lo, {"loss/total": lo, "loss/max": err.abs().max()}

    jg, jm = jax_microbatch_grads(jloss, {"w": jnp.asarray(w0), "b": jnp.asarray(b0)},
                                  {"x": jnp.asarray(x), "y": jnp.asarray(y)}, 2)
    params = {"w": torch.from_numpy(w0).requires_grad_(),
              "b": torch.from_numpy(b0).requires_grad_()}
    g, m = _microbatch_grads(tloss, params,
                             {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, 2)
    assert set(m) == set(jm) == {"loss/total", "loss/max"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    for k in jg:
        assert g[k].dtype == torch.float32
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # uniform weights: the plain mean of the two microbatches' gradients
    halves = [_microbatch_grads(tloss, params, {"x": torch.from_numpy(x[i:i + 4]),
                                                "y": torch.from_numpy(y[i:i + 4])}, 1)[0]
              for i in (0, 4)]
    for k in g:
        torch.testing.assert_close(g[k], (halves[0][k] + halves[1][k]) / 2)


def test_indivisible_accum_raises():
    cfg = bert_large.smoke().replace(**OFF)
    init, step = make_train_step(build_model(cfg), TrainConfig(
        optimizer="lamb", use_fused_lamb=True, accum_steps=3))
    state = init(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(
        jax_synthetic.batch_iterator(jax_bert.smoke(), 8, 16)).items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(state, batch)


def test_launcher_smoke_runs_to_done(capsys):
    trainer = launch_train.main(SMOKE + ["--accum-steps", "2", "--precision", "bf16",
                                         "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "done: step=2 " in out and "status=ok" in out
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss/total"]) for h in trainer.history)


def test_launcher_flash_smoke_runs_to_done(capsys, monkeypatch):
    """``--flash`` on the CPU: the plain version of K3–K5 in every layer."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention_fwd_plain", "fwd"), ("flash_attention_bwd_plain", "bwd")):
        def counted(*a, _f=getattr(flash_module, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(flash_module, name, counted)
    argv = [a for a in SMOKE if a != "--no-flash"]
    trainer = launch_train.main(argv + ["--flash", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "flash=True" in out and "done: step=2 " in out and "status=ok" in out
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss/total"]) for h in trainer.history)
    assert calls == {"fwd": 4, "bwd": 4}   # 2 layers x 2 steps


@pytest.mark.parametrize("extra", [["--optimizer", o] for o in OPTIMIZERS]
                         + [["--log-trust-ratios"]])
def test_launcher_optimizer_runs_to_done(extra, capsys):
    """Every optimizer through the launcher (LAMB as the chain, without
    ``--fused-lamb``), and ``--log-trust-ratios`` on the fused path, on the
    CPU smoke to ``status=ok``."""
    argv = SMOKE + ["--device", "cpu", "--log-every", "1"]
    if extra[0] == "--optimizer":
        argv.remove("--fused-lamb")
    trainer = launch_train.main(argv + extra)
    out = capsys.readouterr().out
    assert "done: step=2 " in out and "status=ok" in out
    assert len(trainer.history) == 2 and int(trainer.state.step) == 2
    assert all(np.isfinite(h["loss/total"]) for h in trainer.history)
    if extra[0] == "--optimizer":
        assert f"optimizer={extra[1]} " in out
        assert isinstance(trainer.state.opt_state, tuple)
    else:
        assert all(set(TRUST_KEYS) <= set(h) for h in trainer.history)


# what the launcher refused before and now runs: a mesh axis besides pod,
# data and model, and parameters stored under any rule (--param-rule); two
# pipe ranks train as one process in tests/test_torch_sharding.py
# (test_any_layout_and_mesh_axis_train_as_one_process)
@pytest.mark.parametrize("extra", [["--arch", "deepseek-v3-671b", "--mesh",
                                    "data=1,model=1,pipe=2"]])
def test_launcher_unported_options_raise(extra, capsys):
    """The mesh is taken and raises only for the ranks it lacks; over one
    rank of it, with ``embed`` stored over data and model, it trains to
    ``status=ok``."""
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        launch_train.main(SMOKE + ["--device", "cpu"] + extra)
    one = [a.replace("pipe=2", "pipe=1") for a in extra]
    trainer = launch_train.main(SMOKE + ["--device", "cpu", "--param-rule", "embed=data,model"]
                                + one)
    out = capsys.readouterr().out
    assert "done: step=2 " in out and "status=ok" in out
    assert trainer.mesh.shape == {"data": 1, "model": 1, "pipe": 1}
    assert trainer.param_rules["embed"] == ("data", "model")


def test_launcher_skip_nonfinite_runs_to_done(capsys):
    trainer = launch_train.main(SMOKE + ["--skip-nonfinite", "--device", "cpu",
                                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert "done: step=2 " in out and "status=ok" in out
    assert [(h["nonfinite/skip"], h["skipped_total"]) for h in trainer.history] == [(0.0, 0)] * 2


def test_launcher_checkpoint_and_resume_run_to_done(tmp_path, capsys):
    ckpt = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2", "--device", "cpu"]
    launch_train.main(SMOKE + ckpt)
    assert capsys.readouterr().out.count("done: step=2 ") == 1
    argv = [a if a != "2" else "3" for a in SMOKE]   # --steps 3
    trainer = launch_train.main(argv + ckpt + ["--resume", "--async-checkpoint",
                                               "--log-every", "1"])
    out = capsys.readouterr().out
    assert "resumed step 2" in out and "done: step=3 " in out and "status=ok" in out
    assert len(trainer.history) == 1 and int(trainer.state.step) == 3
    with pytest.raises(SystemExit, match="--resume requires --checkpoint-dir"):
        launch_train.main(SMOKE + ["--resume", "--device", "cpu"])


def test_launcher_without_device_raises_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(SMOKE)
