"""The recurrent families of the port, xLSTM (``ssm``: mLSTM + sLSTM) and
Jamba (``hybrid``: Mamba + attention + MoE), against the JAX package at
smoke size: the configs, the leaves and masks, each layer (the mLSTM
parallel form and recurrent step, the sLSTM scan, its state and gradients,
Mamba's parallel, chunked and decode paths), the forward in fp32 and bf16,
and the unrolled and remat paths (serving, one LAMB step and the
launchers: tests/test_torch_recurrent_serve.py).  Weights move by path
through the bridge; inputs are made with numpy.  Tolerances are the JAX
suite's own for these layers (tests/test_layers.py, tests/test_arch_smoke.py),
stated in each test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.models.layers import mamba as jax_mamba
from repro.models.layers import xlstm as jax_xlstm
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.layers import mamba, xlstm
from repro_torch.nn import Param, flatten, init_params, params_from_jax
from repro_torch.train.loss import check_fused_ce_supported

ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]
OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)
# a layer-test config as tests/test_layers.py's
LAYER = dict(name="layer-test", family="moe", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=4, d_ff=64, vocab_size=64, n_experts=4, n_experts_per_tok=2,
             moe_d_ff=16, capacity_factor=8.0, activation_dtype="float32")


def _pair(arch, **kw):
    return jax_smoke_config(arch).replace(**OFF, **kw), smoke_config(arch).replace(**OFF, **kw)


def _layer_pair(**kw):
    return JaxModelConfig(**LAYER).replace(**kw), ModelConfig(**LAYER).replace(**kw)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _np(x):
    return x.detach().to(torch.float32).numpy()


def _layer_params(jax_defs, seed):
    """A JAX layer's params, every all-zero leaf (the gate weights) drawn at
    random so that the cell uses it: (the nested JAX tree, the port's flat
    dict)."""
    from repro import nn as jax_nn

    params = jax_nn.init_params(jax_defs, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
                          if not np.asarray(a).any() else a, params)
    return params, params_from_jax(params)


# ---------------------------------------------------------------------------
# configs, leaves, masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_recurrent_configs_equal_jax_copies(arch, smoke):
    ref = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    port = smoke_config(arch) if smoke else get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_leaves_and_masks_match_jax(arch):
    """Every leaf bridges by path with the reference's shape and stacking,
    and the weight-decay, trust-ratio and layer-axis masks equal its own;
    the full-width configs build (defs only) with the reference's count."""
    jcfg, cfg = _pair(arch)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = flatten(jax.tree.map(np.asarray, jmodel.init(jax.random.key(0))))
    params = params_from_jax(jparams)
    assert list(params) == list(jparams) == list(model.wd_mask())
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: p.shape for k, p in flatten(model.defs).items()}
    assert model.wd_mask() == flatten(jmodel.wd_mask())
    assert model.trust_mask() == flatten(jmodel.trust_mask())
    assert model.layer_axes() == flatten(jmodel.layer_axes())
    assert model.unreachable() == frozenset()
    full, jfull = build_model(get_config(arch)), jax_build_model(jax_get_config(arch))
    assert full.param_count() == jfull.param_count()
    if arch == "xlstm-350m":
        assert full.param_count() == 391_583_840 and len(flatten(full.defs)) == 32
    # the port's own init: the reference's shapes, dtypes and constant leaves
    own = model.init(0, "cpu")
    for k, ref in jparams.items():
        assert own[k].shape == ref.shape and own[k].dtype == torch.float32, k
        if k.endswith(("b_fgate", "b_f", "/D", "out_norm", "scale")):
            np.testing.assert_array_equal(own[k].numpy(), ref, err_msg=k)


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_uniform_scalar_init_range(scale):
    """``uniform_scalar`` draws U(1e-3, 1) × scale, as the reference's: every
    value in [1e-3·scale, scale), mean near (1 + 1e-3)/2 · scale, and the
    same from the same seed."""
    p = Param((64, 128), ("inner", "state"), init="uniform_scalar", scale=scale)
    x = init_params({"a": p}, 3, torch.device("cpu"))["a"]
    assert x.dtype == torch.float32
    assert float(x.min()) >= 1e-3 * scale and float(x.max()) < scale
    assert abs(float(x.mean()) / scale - 0.5005) < 0.01
    assert torch.equal(x, init_params({"a": p}, 3, torch.device("cpu"))["a"])
    from repro import nn as jax_nn

    ref = np.asarray(jax_nn.init_params({"a": jax_nn.Param((64, 128), ("inner", "state"),
                                                           init="uniform_scalar",
                                                           scale=scale)},
                                        jax.random.key(0))["a"])
    assert ref.min() >= 1e-3 * scale and ref.max() <= scale


def test_fused_head_refused_and_hidden_transformer_only():
    """The recurrent families train through the dense CE: the fused head is
    refused (the reference's message) and ``return_hidden`` raises."""
    for arch in ARCHS:
        cfg = smoke_config(arch)
        with pytest.raises(ValueError, match="not supported for family"):
            check_fused_ce_supported(cfg)
        model = build_model(cfg.replace(**OFF))
        with pytest.raises(ValueError, match="transformer families only"):
            model.apply(model.init(0, "cpu"), {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                        return_hidden=True)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def test_mlstm_parallel_matches_jax():
    """The (B, H, S, S) log-gate-stabilised form on the same q, k, v and
    gates (3e-4, tests/test_layers.py's mLSTM bound)."""
    rng = np.random.default_rng(0)
    b, h, s, dh = 2, 2, 9, 16
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    i_pre, f_pre = (rng.standard_normal((b, h, s)).astype(np.float32) * 2 for _ in range(2))
    ref = jax_xlstm.mlstm_parallel(*(jnp.asarray(a) for a in (q, k, v, i_pre, f_pre)))
    out = xlstm.mlstm_parallel(*(torch.from_numpy(a) for a in (q, k, v, i_pre, f_pre)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4, atol=3e-4)


def test_mlstm_recurrent_step_matches_jax():
    """One decode step from a non-trivial state: the new C, n, m and h
    (3e-4)."""
    rng = np.random.default_rng(1)
    b, h, dh = 2, 2, 8
    state = {"c": rng.standard_normal((b, h, dh, dh)), "n": rng.standard_normal((b, h, dh)),
             "m": rng.standard_normal((b, h))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    q, k, v = (rng.standard_normal((b, h, dh)).astype(np.float32) for _ in range(3))
    i_pre, f_pre = (rng.standard_normal((b, h)).astype(np.float32) for _ in range(2))
    jst, jh = jax_xlstm.mlstm_recurrent_step(_j(state), *(jnp.asarray(a) for a in
                                                           (q, k, v, i_pre, f_pre)))
    st, hh = xlstm.mlstm_recurrent_step(_t(state), *(torch.from_numpy(a) for a in
                                                      (q, k, v, i_pre, f_pre)))
    np.testing.assert_allclose(hh.numpy(), np.asarray(jh), rtol=3e-4, atol=3e-4)
    for key in ("c", "n", "m"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]), rtol=3e-4,
                                   atol=3e-4, err_msg=key)


def test_mlstm_block_matches_jax_and_its_recurrence():
    """The block's parallel output against the reference's, token-by-token
    decode against the parallel form, and a prefill's rolled state against
    the reference's (3e-4, tests/test_layers.py)."""
    jcfg, cfg = _layer_pair(n_heads=2, n_kv_heads=2, xlstm_proj_factor=2.0)
    jp, p = _layer_params(jax_xlstm.mlstm_defs(jcfg), seed=2)
    x = np.random.default_rng(3).standard_normal((2, 6, 32)).astype(np.float32)
    ref, _ = jax_xlstm.mlstm_block(jp, jnp.asarray(x), jcfg)
    out, none = xlstm.mlstm_block(p, torch.from_numpy(x), cfg)
    assert none is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4, atol=3e-4)
    st = xlstm.init_mlstm_state(2, cfg)
    ys = []
    for t in range(6):
        y, st = xlstm.mlstm_block(p, torch.from_numpy(x[:, t:t + 1]), cfg, state=st, decode=True)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), out.numpy(), rtol=3e-4, atol=3e-4)
    # prefill with state: the prompt rolled through the recurrence
    _, jst = jax_xlstm.mlstm_block(jp, jnp.asarray(x), jcfg,
                                   state=jax_xlstm.init_mlstm_state(2, jcfg))
    _, pst = xlstm.mlstm_block(p, torch.from_numpy(x), cfg, state=xlstm.init_mlstm_state(2, cfg))
    for key in ("c", "n", "m"):
        np.testing.assert_allclose(pst[key].numpy(), np.asarray(jst[key]), rtol=3e-4,
                                   atol=3e-4, err_msg=key)
        np.testing.assert_allclose(pst[key].numpy(), st[key].numpy(), rtol=3e-4, atol=3e-4)


def test_slstm_prefix_state_matches_jax():
    """The sLSTM scan from its zero state: outputs and the final c, n, m, h
    against the reference's, and decode continuing a prefix's state gives
    the full scan's last output (2e-4, tests/test_layers.py)."""
    jcfg, cfg = _layer_pair(n_heads=2, n_kv_heads=2)
    jp, p = _layer_params(jax_xlstm.slstm_defs(jcfg), seed=4)
    x = np.random.default_rng(5).standard_normal((2, 7, 32)).astype(np.float32)
    ref, jst = jax_xlstm.slstm_block(jp, jnp.asarray(x), jcfg,
                                     state=jax_xlstm.init_slstm_state(2, jcfg))
    out, st = xlstm.slstm_block(p, torch.from_numpy(x), cfg, state=xlstm.init_slstm_state(2, cfg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    for key in ("c", "n", "m", "h"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]), rtol=2e-4, atol=2e-4,
                                   err_msg=key)
    _, pre = xlstm.slstm_block(p, torch.from_numpy(x[:, :6]), cfg)
    last, _ = xlstm.slstm_block(p, torch.from_numpy(x[:, 6:7]), cfg, state=pre, decode=True)
    np.testing.assert_allclose(last[:, 0].numpy(), out[:, -1].numpy(), rtol=2e-4, atol=2e-4)


def test_slstm_gradients_match_jax():
    """The backward through the time loop (the batched recurrent product and
    the stabiliser's max, whose tie at the first step both frameworks split
    evenly): gradients of every leaf and of x (2e-4 relative plus 2e-4 of
    each gradient's scale)."""
    jcfg, cfg = _layer_pair(n_heads=2, n_kv_heads=2)
    jp, p = _layer_params(jax_xlstm.slstm_defs(jcfg), seed=6)
    x = np.random.default_rng(7).standard_normal((2, 5, 32)).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(jnp.sin(jax_xlstm.slstm_block(params, xx, jcfg)[0]))

    jg, jgx = jax.grad(jloss, (0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    grads = torch.autograd.grad(torch.sin(xlstm.slstm_block(tp, tx, cfg)[0]).sum(),
                                [*tp.values(), tx])
    refs = {**flatten(jax.tree.map(np.asarray, jg)), "x": np.asarray(jgx)}
    for key, g in zip([*tp, "x"], grads):
        r = refs[key]
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=key)


def _slstm_loop(pre, r, bias, st):
    """The sLSTM's time loop as written before ``layers/scan.scan``."""
    c, n, m, h_prev = st["c"], st["n"], st["m"], st["h"]
    one = torch.ones(())
    hs = []
    for t in range(pre.shape[2]):
        rec = (h_prev.transpose(0, 1) @ r).transpose(1, 2)
        i_t, f_t, z_t, o_t = (pre[:, :, t] + rec + bias).unbind(0)
        log_fm = torch.nn.functional.logsigmoid(f_t) + m
        m_new = torch.maximum(log_fm, i_t)
        i_eff = torch.exp(i_t - m_new)
        f_eff = torch.exp(log_fm - m_new)
        c = f_eff * c + i_eff * torch.tanh(z_t)
        n = f_eff * n + i_eff
        h_prev = torch.sigmoid(o_t) * c / torch.maximum(n, one)
        m = m_new
        hs.append(h_prev)
    return {"c": c, "n": n, "m": m, "h": h_prev}, torch.stack(hs, 1)


def _mlstm_roll(state, q, k, v, i_pre, f_pre):
    """The mLSTM prefill's roll as written before ``layers/scan.scan``."""
    for t in range(q.shape[2]):
        state, _ = xlstm.mlstm_recurrent_step(state, q[:, :, t], k[:, :, t], v[:, :, t],
                                              i_pre[:, :, t], f_pre[:, :, t])
    return state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_is_bit_equal_to_the_loops_it_replaced(dtype, monkeypatch):
    """Each block's ``scan`` (the sLSTM's loop, the mLSTM prefill's roll)
    on the inputs the block hands it, against the loop it replaced: the
    outputs, the state and the gradients of the inputs bit-equal, in fp32
    and in bf16 activations (both loops run in fp32)."""
    cfg = smoke_config("xlstm-350m").replace(activation_dtype="float32")
    calls = []

    def recording(step, carry, xs, **kw):
        xs = [x.detach().requires_grad_() for x in xs]
        carry = {k: v.detach().requires_grad_() for k, v in carry.items()}
        calls.append((step, carry, xs, xlstm_scan(step, carry, xs, **kw)))
        return calls[-1][-1]

    xlstm_scan = xlstm.scan
    monkeypatch.setattr(xlstm, "scan", recording)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 9, cfg.d_model))
                         .astype(np.float32)).to(dtype)
    for i, defs in enumerate((xlstm.slstm_defs(cfg), xlstm.mlstm_defs(cfg))):
        p = init_params(defs, i, torch.device("cpu"))
        p = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
             for k, v in p.items()}
        if i == 0:
            xlstm.slstm_block(p, x, cfg, state=xlstm.init_slstm_state(2, cfg))
        else:
            xlstm.mlstm_block(p, x, cfg, state=xlstm.init_mlstm_state(2, cfg))
    (_, s_carry, s_xs, (s_state, s_hs)), (_, m_carry, m_xs, (m_state, m_hs)) = calls
    p = init_params(xlstm.slstm_defs(cfg), 0, torch.device("cpu"))
    p = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(0))
         for k, v in p.items()}
    r = torch.stack([p[f"r_{g}"] for g in xlstm.GATES])
    bias = torch.stack([p[f"b_{g}"] for g in xlstm.GATES])[:, None]
    want_state, want_hs = _slstm_loop(s_xs[0], r, bias, s_carry)
    assert torch.equal(s_hs, want_hs) and m_hs is None
    for k in want_state:
        assert torch.equal(s_state[k], want_state[k]), k
    wants = _mlstm_roll(m_carry, *m_xs)
    for k in wants:
        assert torch.equal(m_state[k], wants[k]), k
    for got, want, inputs in ((list(s_state.values()) + [s_hs], list(want_state.values())
                               + [want_hs], s_xs), (list(m_state.values()),
                                                    list(wants.values()), m_xs + [m_carry["c"]])):
        gg, gw = (torch.autograd.grad(sum(t.sin().sum() for t in ts), inputs,
                                      retain_graph=True, allow_unused=True) for ts in (got, want))
        assert [a is None for a in gg] == [b is None for b in gw]
        assert all(a is None or torch.equal(a, b) for a, b in zip(gg, gw))


def _mamba_pair(seed):
    jcfg, cfg = _layer_pair(mamba_expand=2, mamba_d_state=4, mamba_d_conv=3)
    jp, p = _layer_params(jax_mamba.mamba_defs(jcfg), seed)
    return jcfg, cfg, jp, p


def test_mamba_parallel_chunked_and_decode_match_jax():
    """Mamba's three paths from one zero state: the parallel scan, the
    chunked scan (chunk 4) and token-by-token decode, each against the
    reference's, and against each other, outputs and final ssm and conv
    state (2e-4, tests/test_layers.py)."""
    jcfg, cfg, jp, p = _mamba_pair(8)
    x = np.random.default_rng(9).standard_normal((2, 8, 32)).astype(np.float32)
    jst0 = jax_mamba.init_mamba_state(2, jcfg, jnp.float32)
    ref, jst = jax_mamba.mamba(jp, jnp.asarray(x), jcfg, state=jst0)
    ref_c, _ = jax_mamba.mamba(jp, jnp.asarray(x), jcfg, chunk=4)
    tol = dict(rtol=2e-4, atol=2e-4)
    outs = {}
    for name, chunk in (("parallel", None), ("chunked", 4)):
        st0 = mamba.init_mamba_state(2, cfg, torch.float32)
        outs[name] = mamba.mamba(p, torch.from_numpy(x), cfg, state=st0, chunk=chunk)
    st = mamba.init_mamba_state(2, cfg, torch.float32)
    ys = []
    for t in range(8):
        y, st = mamba.mamba(p, torch.from_numpy(x[:, t:t + 1]), cfg, state=st, decode=True)
        ys.append(y)
    outs["decode"] = (torch.cat(ys, 1), st)
    for name, (y, s) in outs.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), err_msg=name, **tol)
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(s[key].numpy(), np.asarray(jst[key]), err_msg=name, **tol)
    np.testing.assert_allclose(outs["chunked"][0].numpy(), np.asarray(ref_c), **tol)
    # stateless train path, and a length the chunk does not divide refused
    y, none = mamba.mamba(p, torch.from_numpy(x), cfg, chunk=4)
    assert none is None
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **tol)
    with pytest.raises(ValueError, match="not a multiple of mamba chunk 3"):
        mamba.mamba(p, torch.from_numpy(x), cfg, chunk=3)


@pytest.mark.parametrize("s,chunk", [(1, None), (13, None), (16, 4), (64, 16)])
def test_ssm_scan_equals_the_recurrence(s, chunk):
    """The Hillis–Steele scan (and its chunked form) against h_t = a_t h_{t-1}
    + b_t stepped one by one from a nonzero h0 (1e-5: fp32 products of
    factors below 1 in another order)."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3, 4)).astype(np.float32))
    bx = torch.from_numpy(rng.standard_normal((2, s, 3, 4)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    hs, last = mamba._ssm_scan(a, bx, h0, chunk)
    h, want = h0, []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    np.testing.assert_allclose(hs.numpy(), torch.stack(want, 1).numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(last, hs[:, -1])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _model_pair(arch, seed=1, **kw):
    jcfg, cfg = _pair(arch, **kw)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    # the mLSTM gate weights init to zero: draw them so the gates see x
    jparams = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
                           if not np.asarray(a).any() else a, jparams)
    return jcfg, cfg, jmodel, model, jparams


def _forward(arch, dtype):
    jcfg, cfg, jmodel, model, jparams = _model_pair(arch, activation_dtype=dtype)
    batch = jax_synthetic.make_batch(jcfg, np.random.default_rng(5), 2, 16)
    ref, raux = jmodel.apply(jparams, _j(batch))
    out, aux = model.apply(params_from_jax(jparams), _t(batch))
    assert out.shape == ref.shape == (2, 16, cfg.vocab_size)
    assert out.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    return _np(out), np.asarray(jnp.asarray(ref, jnp.float32)), aux, raux


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_forward_matches_jax_fp32(arch):
    """fp32 logits and the MoE aux of the smoke config from the same weights
    and tokens, to 2e-4 (tests/test_arch_smoke.py's bound between two
    lowerings of one model) of the logits' scale."""
    out, ref, aux, raux = _forward(arch, "float32")
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4 * max(1.0, np.abs(ref).max()))
    assert sorted(aux) == sorted(raux)
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    if arch == "jamba-1.5-large-398b":
        assert {"moe_lb_loss", "moe_max_prob", "moe_drop_fraction"} <= set(aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_forward_matches_jax_bf16(arch):
    """bf16 logits against the JAX package's bf16 logits.  The frameworks
    round bf16 products and elementwise ops at other places (one bf16 ulp
    a layer: torch's SiLU and softplus round once from fp32, XLA's in
    steps), and Jamba's random-init routing amplifies that, so the bound is
    the reference's own bf16 noise: the port's distance from JAX's bf16
    logits, largest and RMS, is within JAX's bf16 logits' distance from its
    fp32 ones; the aux losses to 1e-2."""
    out, ref, aux, raux = _forward(arch, "bfloat16")
    _, ref32, _, _ = _forward(arch, "float32")
    err, noise = np.abs(out - ref), np.abs(ref - ref32)
    assert noise.max() > 0 and err.max() <= noise.max(), (err.max(), noise.max())
    assert np.sqrt((err**2).mean()) <= np.sqrt((noise**2).mean())
    assert sorted(aux) == sorted(raux)
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-2, atol=1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_unrolled_and_remat_equal(arch):
    """``scan_layers=False`` is one path with the scanned one (the reference's
    test_unrolled_equals_scanned, 2e-5; here bit-equal), and ``remat="full"``
    gives the same logits and gradients (2e-5)."""
    _, cfg = _pair(arch, activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)))
    l1, _ = model.apply(params, {"tokens": toks})
    l2, _ = build_model(cfg.replace(scan_layers=False)).apply(params, {"tokens": toks})
    assert torch.equal(l1, l2)
    grads = []
    for remat in ("none", "full"):
        m = build_model(cfg.replace(remat=remat))
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        out, aux = m.apply(p, {"tokens": toks})
        loss = torch.sin(out).mean() + sum(aux.values(), torch.zeros(()))
        grads.append([out.detach(), *torch.autograd.grad(loss, list(p.values()))])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


def test_jamba_chunked_scan_at_model_level():
    """``mamba_chunk`` through the model (tests/test_arch_smoke.py, 2e-4)."""
    _, cfg = _pair("jamba-1.5-large-398b", activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)))
    l1, _ = model.apply(params, {"tokens": toks})
    l2, _ = build_model(cfg.replace(mamba_chunk=4)).apply(params, {"tokens": toks})
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=2e-4, atol=2e-4)
