"""The slice end to end: bert-smoke train steps of the port against the JAX
package's fused-LAMB train step (Pallas LAMB in interpret mode, flash and
fused CE off), and the port's launcher."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.train.step import _microbatch_grads as jax_microbatch_grads
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.nn import flatten, params_from_jax, state_from_jax
from repro_torch.train import TrainState, make_loss_fn, make_train_step
from repro_torch.train.step import _microbatch_grads

OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)
SMOKE = ["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "16",
         "--fused-lamb", "--no-flash", "--no-fused-ce", "--steps", "2"]


def _run_both(accum: int, precision: str, activation_dtype: str, steps: int = 3):
    jcfg = jax_bert.smoke().replace(activation_dtype=activation_dtype, **OFF)
    cfg = bert_large.smoke().replace(activation_dtype=activation_dtype, **OFF)
    kw = dict(optimizer="lamb", use_fused_lamb=True, accum_steps=accum,
              precision=precision, learning_rate=0.01)
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
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append({k: (float(m[k]), float(jm[k])) for k in jm})
    return state, jstate, losses


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


@pytest.mark.parametrize("extra", [
    ["--log-trust-ratios"], ["--optimizer", "adamw"], ["--mesh", "data=4"],
    ["--rollback-on-spike"], ["--telemetry-dir", "runs"], ["--optimizer", "lans"],
])
def test_launcher_unported_options_raise(extra):
    argv = SMOKE + ["--device", "cpu"]
    if extra[0] == "--optimizer":
        argv.remove("--fused-lamb")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_train.main(argv + extra)


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
