"""The transformer zoo of the port (command-r, mistral-nemo, granite-20b,
paligemma, hubert, granite-moe) against the JAX package at smoke size: the
configs, the data, the forward with its MoE aux, the optimizer masks,
prefill then decode, and the MoE layer's routing and drop order, on bridged
weights and the same numpy inputs (one LAMB step each:
tests/test_torch_zoo_step.py)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.models.layers import attention as jax_attention
from repro.models.layers import moe as jax_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import batch_iterator, make_batch
from repro_torch.models import build_model
from repro_torch.models.layers import attention, moe
from repro_torch.nn import flatten, params_from_jax
from repro_torch.train.loss import head_weights

ZOO = ["command-r-35b", "mistral-nemo-12b", "granite-20b", "paligemma-3b", "hubert-xlarge",
       "granite-moe-1b-a400m"]
DECODERS = [a for a in ZOO if a != "hubert-xlarge"]
OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)


def _pair(arch, **kw):
    return jax_smoke_config(arch).replace(**OFF, **kw), smoke_config(arch).replace(**OFF, **kw)


def _jax_params(jmodel, seed=1):
    """JAX init, with every all-zero leaf (the qkv biases) drawn at random so
    that the forward uses it."""
    params = jmodel.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
                        if not np.asarray(a).any() else a, params)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("smoke", [False, True])
def test_zoo_configs_equal_jax_copies(arch, smoke):
    ref = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    port = smoke_config(arch) if smoke else get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_stub_batches_byte_equal_to_jax(arch):
    """The vision and audio stubs' batches, from the same seed."""
    jcfg, cfg = _pair(arch)
    for seed in (0, 3):
        a = make_batch(cfg, np.random.default_rng(seed), 3, 24)
        b = jax_synthetic.make_batch(jcfg, np.random.default_rng(seed), 3, 24)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    it, jit_ = batch_iterator(cfg, 4, 16, seed=2), jax_synthetic.batch_iterator(jcfg, 4, 16, seed=2)
    for _ in range(2):
        a, b = next(it), next(jit_)
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_forward_matches_jax(arch):
    """fp32 logits and every aux entry (the MoE losses, averaged over the
    layers) of the smoke config, from the same weights and batch.  The sums
    run in another order in the two frameworks: 1e-4 relative plus 1e-4 of
    the logits' scale."""
    jcfg, cfg = _pair(arch, activation_dtype="float32")
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = _jax_params(jmodel)
    batch = jax_synthetic.make_batch(jcfg, np.random.default_rng(5), 2, 16)
    ref, raux = jmodel.apply(jparams, _j(batch))
    out, aux = model.apply(params_from_jax(jparams), _t(batch))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert sorted(aux) == sorted(raux)
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if arch == "granite-moe-1b-a400m":
        assert {"moe_lb_loss", "moe_max_prob", "moe_drop_fraction"} <= set(aux)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_leaves_and_masks_match_jax(arch):
    """Every leaf (the qkv biases, ``unembed``, ``mask_embed``, the MoE
    router and experts) bridges by path, and the weight-decay, trust-ratio
    and layer-axis masks equal the reference's leaf for leaf."""
    jcfg, cfg = _pair(arch)
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
    new = {"granite-20b": ["blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv", "unembed"],
           "mistral-nemo-12b": ["unembed"], "hubert-xlarge": ["mask_embed"],
           "granite-moe-1b-a400m": ["blocks/moe/router", "blocks/moe/wi", "blocks/moe/wg",
                                    "blocks/moe/wo"]}.get(arch, [])
    assert set(new) <= set(params)
    for k in new:
        if "/b" in k:   # the biases: no decay, no trust ratio
            assert not model.wd_mask()[k] and not model.trust_mask()[k]


def test_shared_expert_leaves_bridge():
    """The shared-expert branch (no zoo config of this slice sets it): its
    ``moe/shared/*`` leaves and the layer's output match the reference."""
    jcfg, cfg = _pair("granite-moe-1b-a400m", activation_dtype="float32", n_shared_experts=1)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(2))
    params = params_from_jax(jparams)
    assert {"blocks/moe/shared/wi", "blocks/moe/shared/wg", "blocks/moe/shared/wo"} <= set(params)
    batch = jax_synthetic.make_batch(jcfg, np.random.default_rng(1), 2, 8)
    ref, _ = jmodel.apply(jparams, _j(batch))
    out, _ = model.apply(params, _t(batch))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# serving: prefill then decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_consistency(arch):
    """prefill(s tokens) then decode(token s) gives the full forward's logits
    at position s (the reference's test of the same name).  MoE capacity is
    raised so that no token drops: drops depend on how many tokens a call
    routes and would legitimately differ between the two paths."""
    _, cfg = _pair(arch, activation_dtype="float32", capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    s = 12
    batch = _t(make_batch(cfg, np.random.default_rng(1), 2, s + 1))
    batch.pop("labels")
    with torch.inference_mode():
        full, _ = model.apply(params, batch)
        if cfg.frontend == "vision_stub":
            pre = {"tokens": batch["tokens"][:, :-1], "image_embeds": batch["image_embeds"]}
            pos = torch.full((2, 1), batch["tokens"].shape[1] - 1 + cfg.n_prefix_tokens,
                             dtype=torch.int32)
        else:
            pre = {"tokens": batch["tokens"][:, :-1]}
            pos = torch.full((2, 1), s, dtype=torch.int32)
        cache = model.make_cache(2, s + 8, "cpu")
        _, cache = model.prefill(params, pre, cache)
        out, _ = model.decode(params, {"tokens": batch["tokens"][:, -1:]}, cache, pos)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-1b-a400m"])
def test_engines_greedy_tokens_equal_jax(arch):
    """The static and continuous engines decode through the untied head and
    the MoE blocks, dropping the aux as the reference's do: fp32 greedy
    tokens equal the JAX engines' on the same weights (capacity raised so
    that no call drops: a drop depends on how many tokens the call routes)."""
    import repro.serve as jax_serve
    from repro_torch.serve import ContinuousEngine, Engine, Request, ServeRequest

    jcfg, cfg = _pair(arch, activation_dtype="float32", capacity_factor=8.0)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(4))
    params = params_from_jax(jparams)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32) for _ in range(3)]
    ref = jax_serve.Engine(jmodel, jparams, max_len=24).generate_batch(
        [jax_serve.Request(p, max_new_tokens=6) for p in prompts])
    out = Engine(model, params, max_len=24).generate_batch(
        [Request(p, max_new_tokens=6) for p in prompts])
    cont = ContinuousEngine(model, params, n_slots=2, max_len=24).generate(
        [ServeRequest(p, max_new_tokens=6) for p in prompts])
    for a, b, r in zip(out, cont, ref):
        np.testing.assert_array_equal(a.out_tokens, np.asarray(r.out_tokens))
        np.testing.assert_array_equal(np.asarray(b.out_tokens), np.asarray(r.out_tokens))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_inputs(jcfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    d, e, f = jcfg.d_model, jcfg.n_experts, jcfg.moe_d_ff
    p = {"router": rng.standard_normal((d, e)) * 0.3,
         "wi": rng.standard_normal((e, d, f)) * 0.1, "wg": rng.standard_normal((e, d, f)) * 0.1,
         "wo": rng.standard_normal((e, f, d)) * 0.1}
    x = rng.standard_normal((b, s, d))
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


@pytest.mark.parametrize("tokens", [1, 7, 32, 4096])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_capacity_matches_jax(tokens, cf):
    jcfg, cfg = _pair("granite-moe-1b-a400m", capacity_factor=cf)
    assert moe.capacity(tokens, cfg) == jax_moe.capacity(tokens, jcfg)
    full = get_config("granite-moe-1b-a400m")
    assert moe.capacity(tokens, full) == jax_moe.capacity(tokens, jax_get_config(
        "granite-moe-1b-a400m"))


@pytest.mark.parametrize("z", [0.0, 1e-3])
def test_route_matches_jax(z):
    """Top-k gates (renormalised), expert ids, the load-balance loss, the
    max mean probability and, with ``router_z_coef``, the z-loss."""
    jcfg, cfg = _pair("granite-moe-1b-a400m", router_z_coef=z)
    logits = np.random.default_rng(3).standard_normal((40, cfg.n_experts)).astype(np.float32) * 2
    jg, ji, jaux = jax_moe.route(jnp.asarray(logits), jcfg)
    g, i, aux = moe.route(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    assert sorted(aux) == sorted(jaux) and ("moe_z_loss" in aux) == bool(z)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_moe_drop_order_matches_jax(cf):
    """The layer's output and aux under forced drops (capacity factor 0.5:
    half the assignments fit) equal the reference's: the same (token, slot)
    pairs are kept, ranked token-major then slot within each expert.  A
    dropped pair contributes nothing, so any other drop order would change
    the rows of the tokens it moves."""
    jcfg, cfg = _pair("granite-moe-1b-a400m", capacity_factor=cf)
    p, x = _moe_inputs(jcfg)
    ref, jaux = jax_moe.moe({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    out, aux = moe.moe({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)
    drop = float(aux["moe_drop_fraction"])
    assert (drop > 0.3) if cf == 0.5 else (drop == 0.0 if cf == 8.0 else True)


def test_moe_dropped_tokens_get_no_gradient():
    """The sink row takes the dropped assignments' rows and is sliced off:
    a token every one of whose slots is dropped gets an output of 0 and a
    gradient of 0 through the experts (its router gradient flows through
    its gates only if kept)."""
    _, cfg = _pair("granite-moe-1b-a400m", capacity_factor=0.5)
    p, x = _moe_inputs(cfg, seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    out, _ = moe.moe(pt, xt, cfg)
    logits = xt.detach().reshape(-1, cfg.d_model) @ pt["router"]
    _, idx, _ = moe.route(logits, cfg)
    flat = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, cfg.n_experts)
    rank = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = (rank < moe.capacity(x.shape[0] * x.shape[1], cfg)).reshape(-1, cfg.n_experts_per_tok)
    gone = ~kept.any(1)
    assert int(gone.sum()) > 0
    assert float(out.detach().reshape(-1, cfg.d_model)[gone].abs().max()) == 0.0
    (gx,) = torch.autograd.grad(out.sum(), xt)
    assert float(gx.reshape(-1, cfg.d_model)[gone].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# softcaps and the untied head
# ---------------------------------------------------------------------------

def test_softcap_warns_once_and_takes_the_dense_path():
    """A logit softcap runs on the dense path only: with ``use_flash_kernel``
    the model refuses to build (the reference warns once and falls back to
    dense attention; the port never gives way to the plain path on the card).
    The dense path caps the scores as the reference caps them, and the
    model's final logits are capped too."""
    jcfg, cfg = _pair("mistral-nemo-12b", activation_dtype="float32", logit_softcap=2.0)
    with pytest.raises(ValueError, match="use_flash_kernel cannot apply logit_softcap"):
        build_model(cfg.replace(use_flash_kernel=True))
    rng = np.random.default_rng(6)
    b, s, d = 2, 10, cfg.d_model
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, h, dh)), "wk": rng.standard_normal((d, hkv, dh)),
         "wv": rng.standard_normal((d, hkv, dh)) * 0.1,
         "wo": rng.standard_normal((h, dh, d)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    ref, _ = jax_attention.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                     jnp.asarray(pos), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the dense path warns of nothing
        out = attention.attention(tp, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # the uncapped reference differs: the cap is applied
    plain, _ = jax_attention.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                       jnp.asarray(pos), jcfg.replace(logit_softcap=None))
    assert np.abs(np.asarray(plain) - np.asarray(ref)).max() > 1e-3
    # the whole model: capped final logits, as the reference's
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(3))
    batch = jax_synthetic.make_batch(jcfg, np.random.default_rng(2), 2, 8)
    jl, _ = jmodel.apply(jparams, _j(batch))
    tl, _ = model.apply(params_from_jax(jparams), _t(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert float(tl.abs().max()) <= 2.0


def test_untied_head_weights_for_the_fused_head():
    """The fused head's (V, D) projection of an untied model is ``unembed``
    transposed, with contiguous rows for the kernels."""
    _, cfg = _pair("mistral-nemo-12b")
    params = build_model(cfg).init(0, "cpu")
    w = head_weights(params, cfg)
    assert w.shape == (cfg.vocab_size, cfg.d_model) and w.is_contiguous()
    assert torch.equal(w, params["unembed"].t())
    _, tied = _pair("command-r-35b")
    tparams = build_model(tied).init(0, "cpu")
    assert head_weights(tparams, tied) is tparams["embed"]
