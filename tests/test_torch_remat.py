"""``remat="full"`` in the port (``torch.utils.checkpoint`` around each
block) against no remat and against the JAX package's ``remat="full"``
(``jax.checkpoint`` on the block body), at bert-smoke size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import bert_large as jax_bert
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.models import build_model
from repro_torch.nn import flatten, params_from_jax, train_state_to_numpy
from repro_torch.train import make_loss_fn, make_train_step
from repro_torch.train.step import _microbatch_grads


OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)
ON = dict(use_flash_kernel=True, use_fused_ce_head=True)


def _batch(cfg, batch=4, seq=32, seed=1):
    return {k: torch.from_numpy(v) for k, v in
            next(jax_synthetic.batch_iterator(cfg, batch, seq, seed=seed)).items()}


def _grads(cfg, params, batch, dtype=None):
    model = build_model(cfg)
    leaves = {k: (v if dtype is None else v.to(dtype)).detach().requires_grad_()
              for k, v in params.items()}
    grads, metrics = _microbatch_grads(make_loss_fn(model), leaves, batch, 2)
    return grads, metrics


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_equal_no_remat(kernels, dtype):
    """The recomputed forward saves the same residuals (flash's o and lse
    included), so remat changes no bit of the gradients or metrics."""
    cfg = bert_large.smoke().replace(activation_dtype=dtype,
                                     **(ON if kernels == "on" else OFF))
    params = build_model(cfg).init(0, "cpu")
    batch = _batch(cfg)
    cast = None if dtype == "float32" else torch.bfloat16
    g0, m0 = _grads(cfg, params, batch, cast)
    g1, m1 = _grads(cfg.replace(remat="full"), params, batch, cast)
    assert list(g0) == list(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def test_remat_recomputes_the_flash_forward(monkeypatch):
    """Under remat each layer's flash forward (K3's plain version here) runs
    once more in the backward; the backward itself runs once per layer."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention_fwd_plain", "fwd"),
                      ("flash_attention_bwd_plain", "bwd")):
        def counted(*a, _f=getattr(flash_module, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(flash_module, name, counted)
    cfg = bert_large.smoke().replace(activation_dtype="float32", **ON)
    params = build_model(cfg).init(0, "cpu")
    batch = _batch(cfg)
    layers, micro = cfg.n_layers, 2
    _grads(cfg, params, batch)
    assert calls == {"fwd": layers * micro, "bwd": layers * micro}
    calls.update(fwd=0, bwd=0)
    _grads(cfg.replace(remat="full"), params, batch)
    assert calls == {"fwd": 2 * layers * micro, "bwd": layers * micro}


def test_remat_gradients_match_jax_remat():
    """The port's remat gradients against the JAX package's ``remat="full"``
    model's on the same weights and batch, fp32: the loss within the
    forward tolerance of ``tests/test_torch_model.py`` (rtol 1e-5), each
    gradient leaf within 1e-4 of its norm (relative L2), and no farther
    from JAX's than without remat (both frameworks' remat leave their own
    gradients within a few 1e-6).

    Elementwise 1e-5 does not hold between the frameworks' fp32 gradients
    with or without remat: bert-smoke's attention is saturated at init and
    the two differ by ~2e-5 of each leaf's norm (see
    ``tests/test_torch_train.py``)."""
    batch = next(jax_synthetic.batch_iterator(jax_bert.smoke(), 4, 32, seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    dist = {}
    for remat in ("none", "full"):
        jcfg = jax_bert.smoke().replace(activation_dtype="float32", remat=remat, **OFF)
        jparams = jax_build_model(jcfg).init(jax.random.key(0))
        jloss = jax_make_loss_fn(jax_build_model(jcfg))
        jg = flatten(jax.grad(lambda p: jloss(p, jb)[0])(jparams))
        cfg = bert_large.smoke().replace(activation_dtype="float32", remat=remat, **OFF)
        params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
        loss, _ = make_loss_fn(build_model(cfg))(params, {k: torch.from_numpy(v)
                                                          for k, v in batch.items()})
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        np.testing.assert_allclose(float(loss.detach()), float(jloss(jparams, jb)[0]),
                                   rtol=1e-5)
        dist[remat] = {k: float(np.linalg.norm(grads[k].numpy() - np.asarray(ref))
                                / np.linalg.norm(np.asarray(ref))) for k, ref in jg.items()}
    for k, d in dist["full"].items():
        assert d <= 1e-4, (k, d)
        assert d <= dist["none"][k] + 5e-6, (k, d, dist["none"][k])


@pytest.mark.parametrize("fused", [True, False])
def test_remat_train_steps_bit_equal(fused):
    """Two LAMB train steps (fused-direct and the chain, accumulation 2,
    flash and the fused CE head on) with and without remat: the whole
    train state equal bit for bit."""
    states = []
    for remat in ("none", "full"):
        cfg = bert_large.smoke().replace(remat=remat, **ON)
        init, step = make_train_step(build_model(cfg), TrainConfig(
            optimizer="lamb", use_fused_lamb=fused, accum_steps=2, learning_rate=0.01),
            warmup_poly_decay(0.01, 10, 0))
        state = init(0, "cpu")
        for seed in (1, 2):
            state, _ = step(state, _batch(cfg, 8, 16, seed))
        states.append(train_state_to_numpy(state))
    assert list(states[0]) == list(states[1])
    for k in states[0]:
        assert states[0][k].tobytes() == states[1][k].tobytes(), k


def test_launcher_build_takes_remat_and_trainer_overrides():
    """``build(args, remat=, **trainer_kw)``: the model config's ``remat``
    and the given Trainer keywords replace the launcher's; the rest still
    comes from the flags."""
    from repro_torch.launch.train import build, parse_args
    from repro_torch.telemetry import EventLog

    args = parse_args(["--arch", "bert-large", "--smoke", "--steps", "2", "--device", "cpu",
                       "--log-every", "7"])
    trainer, _, cfg = build(args)
    assert cfg.remat == "none" and not trainer.telemetry.enabled
    log = EventLog.memory()
    trainer, _, cfg = build(args, remat="full", telemetry=log, checkpoint_every=3)
    assert cfg.remat == trainer.model.cfg.remat == "full"
    assert trainer.telemetry is log and trainer.checkpoint_every == 3
    assert trainer.log_every == 7
