"""deepseek-v3 in the port against the JAX package at smoke size: the config,
the leaves and optimizer masks with and without MTP, the MLA layer (naive
and absorbed, fp32 and bf16, ragged lengths), the forward over the dense
prefix and the MoE segment with its aux, remat and ``scan_layers``, the MTP
head and ``lm_loss`` with it (dense and fused head), one LAMB step with MTP,
and the per-leaf-cast init.  Serving: tests/test_torch_deepseek_serve.py.

Tolerances, relative to the reference tensor's scale ``max(1, max|ref|)``
unless a test says otherwise: 3e-5 in fp32 and 3e-2 in bf16 (a few bf16
ulps: the frameworks round bf16 products and sums in another order), as
tests/test_torch_serve.py; the zoo's 1e-4 for whole-model fp32 logits; the
JAX suite's 2e-4 for absorbed against naive (tests/test_arch_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro import nn as jax_nn
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_transformer
from repro.models.layers import mla as jax_mla
from repro.train import loss as jax_loss
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import nn
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.models import build_model, transformer
from repro_torch.models.layers import mla
from repro_torch.nn import flatten, params_from_jax, state_from_jax
from repro_torch.train import TrainState, loss, make_train_step

ARCH = "deepseek-v3-671b"
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(a, ref, tol, msg=""):
    ref = _f32(ref)
    np.testing.assert_allclose(_f32(a), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=msg)


def _pair(**kw):
    kw = {**OFF, **kw}
    return jax_smoke_config(ARCH).replace(**kw), smoke_config(ARCH).replace(**kw)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def fp32():
    """(jax model, jax params, port model, port params) of deepseek-smoke
    with MTP, in fp32."""
    jcfg, cfg = _pair(activation_dtype="float32", use_mtp=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    return jmodel, jparams, build_model(cfg), params_from_jax(jparams)


# ---------------------------------------------------------------------------
# config and leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_deepseek_config_equals_jax_copy(smoke):
    ref = jax_smoke_config(ARCH) if smoke else jax_get_config(ARCH)
    port = smoke_config(ARCH) if smoke else get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("mtp", [False, True])
def test_deepseek_leaves_and_masks_match_jax(mtp):
    """Every leaf (the MLA's, ``dense_blocks/*``, ``mtp/*``, the shared
    expert's) bridges by path with its shape, and the weight-decay,
    trust-ratio and layer-axis masks equal the reference's leaf for leaf;
    the MLA's latent norms take neither decay nor the trust ratio."""
    jcfg, cfg = _pair(use_mtp=mtp)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = flatten(jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))))
    params = params_from_jax(jparams)
    assert list(params) == list(jparams) == list(model.wd_mask())
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: p.shape for k, p in flatten(model.defs).items()}
    assert model.param_count() == jmodel.param_count()
    assert model.wd_mask() == flatten(jmodel.wd_mask())
    assert model.trust_mask() == flatten(jmodel.trust_mask())
    assert model.layer_axes() == flatten(jmodel.layer_axes())
    assert len(params) == (48 if mtp else 33)
    for k in ("blocks/attn/q_norm", "dense_blocks/attn/kv_norm"):
        assert not model.wd_mask()[k] and not model.trust_mask()[k]
    assert {"dense_blocks/mlp/wg", "blocks/moe/shared/wi", "blocks/attn/wkv_a"} <= set(params)
    assert mtp == ("mtp/proj" in params and "mtp/block/attn/wq_b" in params)
    # full width, cut to one dense and one MoE block: the served model
    full = get_config(ARCH).replace(n_layers=2, n_dense_layers=1)
    assert build_model(full).param_count() == jax_build_model(
        jax_get_config(ARCH).replace(n_layers=2, n_dense_layers=1)).param_count() \
        == 13_944_134_656


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

def _mla_pair(dtype, absorb):
    jcfg, cfg = _pair(activation_dtype=dtype, mla_absorb=absorb)
    jp = jax_nn.init_params(jax_mla.mla_defs(jcfg), jax.random.key(3))
    return jcfg, cfg, jp, params_from_jax(jp)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(dtype, absorb, ragged):
    """The layer alone on the same weights and x (B 3, S 12), without a
    cache; ragged: valid lengths 12, 5 and 0 (clamped to 1)."""
    jcfg, cfg, jp, p = _mla_pair(dtype, absorb)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12)).copy()
    valid = np.array([12, 5, 0], np.int32) if ragged else None
    ref, _ = jax_mla.mla_attention(jp, jnp.asarray(x, dtype), jnp.asarray(pos), jcfg,
                                   valid_len=None if valid is None else jnp.asarray(valid))
    out = mla.mla_attention(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos), cfg,
                            valid_len=None if valid is None else torch.from_numpy(valid))
    assert out.dtype == getattr(torch, dtype) and out.shape == (3, 12, cfg.d_model)
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("index", ["scalar", "per-slot"])
def test_mla_prefill_then_decode_matches_jax(index, absorb):
    """A ragged prefill (valid 9, 6) into a cache of 16, then one decode
    step: a scalar index (two tokens at once) or a (B,) index; the output,
    the latent cache and its index against the reference's, fp32."""
    jcfg, cfg, jp, p = _mla_pair("float32", absorb)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    valid = np.array([9, 6], np.int32)
    jcache = jax_mla.init_mla_cache(2, 16, jcfg, jnp.float32)
    ref, jcache = jax_mla.mla_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                        cache=jcache, valid_len=jnp.asarray(valid))
    cache = mla.init_mla_cache(2, 16, cfg, torch.float32)
    out = mla.mla_attention(p, torch.from_numpy(x), torch.from_numpy(pos), cfg, cache=cache,
                            valid_len=torch.from_numpy(valid))
    _close(out, ref, TOL["float32"], "prefill")
    for k in ("c_kv", "k_rope", "index"):
        _close(cache[k], jcache[k], TOL["float32"], k)
    if index == "scalar":
        s, dpos = 2, np.broadcast_to(np.arange(9, 11, dtype=np.int32), (2, 2)).copy()
    else:
        s, dpos = 1, np.array([[9], [6]], np.int32)
        jcache["index"] = jnp.asarray([9, 6], jnp.int32)
        cache["index"] = torch.tensor([9, 6], dtype=torch.int32)
    xd = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    ref, jcache = jax_mla.mla_attention(jp, jnp.asarray(xd), jnp.asarray(dpos), jcfg,
                                        cache=jcache, decode=True)
    out = mla.mla_attention(p, torch.from_numpy(xd), torch.from_numpy(dpos), cfg, cache=cache,
                            decode=True)
    _close(out, ref, TOL["float32"], "decode")
    for k in ("c_kv", "k_rope", "index"):
        _close(cache[k], jcache[k], TOL["float32"], k)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("absorb", [False, True])
def test_deepseek_forward_matches_jax(fp32, absorb):
    """fp32 logits and every aux entry (the MoE losses of the one MoE
    segment, the dense prefix reporting none; MTP's hidden states) from the
    same weights and batch: the zoo's 1e-4 of the logits' scale."""
    jmodel, jparams, model, params = fp32
    if absorb:
        jmodel = jax_build_model(jmodel.cfg.replace(mla_absorb=True))
        model = build_model(model.cfg.replace(mla_absorb=True))
    batch = jax_synthetic.make_batch(jmodel.cfg, np.random.default_rng(6), 2, 16)
    ref, raux = jmodel.apply(jparams, _j(batch))
    out, aux = model.apply(params, _t(batch))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 16, model.cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert sorted(aux) == sorted(raux)
    assert {"moe_lb_loss", "moe_max_prob", "moe_drop_fraction", "mtp_hidden"} <= set(aux)
    for k in raux:
        np.testing.assert_allclose(_f32(aux[k]), _f32(raux[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_mla_absorbed_equals_naive(fp32):
    """The port's own two paths on one batch, fp32: test_arch_smoke's 2e-4."""
    _, _, model, params = fp32
    batch = _t(jax_synthetic.make_batch(model.cfg, np.random.default_rng(7), 2, 16))
    naive, _ = model.apply(params, batch)
    absorbed, _ = build_model(model.cfg.replace(mla_absorb=True)).apply(params, batch)
    np.testing.assert_allclose(absorbed.numpy(), naive.numpy(), rtol=2e-4, atol=2e-4)


def test_dense_prefix_aux_merge_matches_jax():
    """Two MoE layers after one dense: the main segment averages its own
    aux over its own layers (a loop over ``cfg.n_layers`` or the first
    layer's keys would not); the dense prefix reports none."""
    jcfg, cfg = _pair(activation_dtype="float32", n_layers=4)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(2))
    batch = jax_synthetic.make_batch(jcfg, np.random.default_rng(8), 2, 12)
    _, raux = jmodel.apply(jparams, _j(batch))
    _, aux = model.apply(params_from_jax(jparams), _t(batch))
    assert sorted(aux) == sorted(raux) == ["moe_drop_fraction", "moe_lb_loss", "moe_max_prob"]
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("field", [dict(scan_layers=False), dict(remat="full")])
def test_scan_layers_and_remat_give_the_same_result(fp32, field):
    """``scan_layers=False`` (no effect: one path) and ``remat="full"``
    (both segments checkpointed): logits bit-equal, and every leaf's
    gradient of the MTP loss bit-equal too."""
    _, _, model, params = fp32
    other = build_model(model.cfg.replace(**field))
    batch = _t(jax_synthetic.make_batch(model.cfg, np.random.default_rng(9), 2, 16))
    grads = []
    for m in (model, other):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        logits, aux = m.apply(p, batch)
        total, _ = loss.lm_loss(logits, batch, aux, m.cfg, params=p)
        grads.append((logits.detach(), torch.autograd.grad(total, list(p.values()))))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_mtp_logits_match_jax(fp32):
    """The MTP head on the forward's hidden states: embed, roll by -1 (the
    last position wraps), project, one block, norm, the untied head."""
    jmodel, jparams, model, params = fp32
    batch = jax_synthetic.make_batch(jmodel.cfg, np.random.default_rng(10), 2, 16)
    _, raux = jmodel.apply(jparams, _j(batch))
    _, aux = model.apply(params, _t(batch))
    ref = jax_transformer.mtp_logits(jparams, raux["mtp_hidden"], _j(batch), jmodel.cfg)
    out = transformer.mtp_logits(params, aux["mtp_hidden"], _t(batch), model.cfg)
    assert out.shape == (2, 16, model.cfg.vocab_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("fused", [False, True])
def test_lm_loss_with_mtp_matches_jax(fp32, fused):
    """``lm_loss`` with MTP (labels shifted one further, the last position
    unsupervised, the MTP CE dense either way): every metric and the loss's
    gradient of each leaf, dense head or the fused head's plain version (K6–
    K8's twin), fp32: 1e-5 on the metrics, 1e-4 of each gradient's scale."""
    jmodel, jparams, model, params = fp32
    jcfg = jmodel.cfg.replace(use_fused_ce_head=fused)
    cfg = model.cfg.replace(use_fused_ce_head=fused)
    batch = jax_synthetic.make_batch(jcfg, np.random.default_rng(11), 2, 16)

    def jloss(p):
        if fused:
            hidden, aux = jmodel.apply(p, _j(batch), return_hidden=True)
            return jax_loss.lm_loss(None, _j(batch), aux, jcfg, params=p, hidden=hidden)
        logits, aux = jmodel.apply(p, _j(batch))
        return jax_loss.lm_loss(logits, _j(batch), aux, jcfg, params=p)

    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    if fused:
        hidden, aux = model.apply(p, _t(batch), return_hidden=True)
        total, m = loss.lm_loss(None, _t(batch), aux, cfg, params=p, hidden=hidden)
    else:
        logits, aux = model.apply(p, _t(batch))
        total, m = loss.lm_loss(logits, _t(batch), aux, cfg, params=p)
    assert sorted(m) == sorted(jm) and "loss/mtp" in m
    for k in jm:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
    for k, ref in flatten(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * max(1e-30, float(np.abs(ref).max())), err_msg=k)


@pytest.mark.parametrize("fused,head", [(True, True), (False, False)])
def test_one_lamb_step_with_mtp_matches_jax(fused, head):
    """One fp32 LAMB step of deepseek-smoke with MTP (fused: the JAX
    package's Pallas kernels in interpret mode against K1/K2's plain
    version; else the transform chain; head: the fused CE head) from the
    same state on the same batch, accumulation 2, the counterpart of
    ``tests/test_arch_smoke.py::test_deepseek_mtp_smoke``: the losses to
    1e-4 and every weight as ``tests/test_torch_zoo_step.py`` bounds it (at
    most 1% of a leaf's elements past 1e-5, none past 1e-3)."""
    jcfg, cfg = _pair(activation_dtype="float32", use_mtp=True, use_fused_ce_head=head)
    kw = dict(optimizer="lamb", use_fused_lamb=fused, accum_steps=2, learning_rate=0.01)
    jinit, jstep = jax_make_train_step(
        jax_build_model(jcfg), JaxTrainConfig(fused_backend="interpret", **kw),
        jax_warmup_poly_decay(0.01, 10, 0))
    _, step = make_train_step(build_model(cfg), TrainConfig(**kw), warmup_poly_decay(0.01, 10, 0))
    jstate = jinit(jax.random.key(0))
    state = TrainState(params_from_jax(jstate.params), state_from_jax(jstate.opt_state))
    batch = next(jax_synthetic.batch_iterator(jcfg, 4, 16, seed=1))
    jstate, jm = jax.jit(jstep)(jstate, _j(batch))
    state, m = step(state, _t(batch))
    assert sorted(k for k in m if "/" in k) == sorted(k for k in jm if "/" in k)
    assert "loss/mtp" in m and np.isfinite(float(m["loss/total"]))
    for k in ("loss/total", "loss/ce", "loss/mtp", "loss/moe_lb", "moe/drop_fraction",
              "update_norm", "tokens/supervised"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k, v in params_from_jax(jstate.params).items():
        diff = (state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-2, k
        assert float(diff.max()) < 1e-3, k


# ---------------------------------------------------------------------------
# the init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["bert-large", ARCH])
def test_init_casts_each_leaf_bit_equal_to_cast_after(arch):
    """``Model.init`` casts each leaf as it is drawn; the values are the
    fp32 tree's cast afterwards, bit for bit, in bf16."""
    cfg = smoke_config(arch).replace(param_dtype="bfloat16", use_mtp=arch == ARCH)
    model = build_model(cfg)
    got = model.init(3, "cpu")
    want = nn.cast_tree(nn.init_params(model.defs, 3, torch.device("cpu")), "bfloat16")
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.bfloat16 and torch.equal(got[k], v), k


def test_trainer_history_keeps_the_mtp_loss():
    """The Trainer's history rows carry ``loss/mtp`` beside the MoE terms
    where the loss reports it, as the reference's history keeps every
    metric."""
    from repro_torch.data import DataPipeline
    from repro_torch.train import Trainer

    cfg = smoke_config(ARCH).replace(use_mtp=True)
    trainer = Trainer(build_model(cfg), TrainConfig(accum_steps=2), device="cpu", log_every=1,
                      log_fn=lambda msg: None)
    trainer.fit(DataPipeline(cfg, 4, 16, device="cpu", seed=0), 2)
    assert len(trainer.history) == 2
    for row in trainer.history:
        assert {"loss/mtp", "loss/moe_lb", "moe/drop_fraction"} <= set(row)
        assert np.isfinite(row["loss/mtp"]) and row["loss/total"] > row["loss/ce"]
