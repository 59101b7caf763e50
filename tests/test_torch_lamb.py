"""The port's fused LAMB (plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode and its pure-jnp oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as jax_bert
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.kernels import fused_lamb_init as jax_fused_lamb_init
from repro.kernels import lamb_update as jax_lamb_update
from repro.kernels import make_fused_lamb_step as jax_make_fused_lamb_step
from repro.kernels.ref import lamb_update_ref
from repro.models import build_model as jax_build_model
from repro_torch.configs import bert_large
from repro_torch.core import warmup_poly_decay
from repro_torch.kernels import fused_lamb_init, lamb_update, make_fused_lamb_step
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax, state_from_jax

# fp32: the two sides sum the norms in different orders
F32 = dict(rtol=1e-5, atol=1e-6)

LAMB_SHAPES = [
    ((128,), None),
    ((1000,), None),        # per-layer size not a multiple of 128
    ((8, 16), None),
    ((4, 300), 0),          # stacked, ragged per-layer size
    ((2, 64, 32), 0),
    ((3, 4099), 0),         # stacked, more than one kernel block per layer
]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_close(port: torch.Tensor, ref, dtype) -> None:
    a = port.to(torch.float32).numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "bfloat16":
        # the same fp32 value rounds the same way; a one-ulp gap is the most
        # a last-bit fp32 difference can leave after the cast to bf16
        assert np.all(np.abs(a - b) <= _bf16_ulp(b)), np.max(np.abs(a - b))
    else:
        np.testing.assert_allclose(a, b, **F32)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = torch.from_numpy(x).to(tdt)
    tg = torch.from_numpy(g).to(tdt)
    return (jx, jg, jnp.asarray(m), jnp.asarray(v)), (tx, tg, torch.from_numpy(m), torch.from_numpy(v))


def _port(tin, step, lr, **kw):
    x, g, m, v = (t.clone() for t in tin)
    return lamb_update(x, g, m, v, torch.tensor(step, dtype=torch.int32),
                       torch.tensor(lr), **kw)


@pytest.mark.parametrize("shape,axis", LAMB_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lamb_update_matches_jax_kernel_and_ref(shape, axis, dtype):
    jin, tin = _inputs(shape, dtype)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    out = _port(tin, 5, 0.01, layer_axis=axis, **kw)
    x1, m1, v1, r1 = jax_lamb_update(*jin, jnp.asarray(5), lr=0.01, layer_axis=axis,
                                     interpret=True, return_ratio=True, **kw)
    x2, m2, v2, r2 = lamb_update_ref(*jin, lr=0.01, step=5, layer_axis=axis,
                                     return_ratio=True, **kw)
    for ref_x, ref_m, ref_v, ref_r in ((x1, m1, v1, r1), (x2, m2, v2, r2)):
        assert_close(out.x, ref_x, dtype)
        assert_close(out.m, ref_m, "float32")
        assert_close(out.v, ref_v, "float32")
        assert_close(out.ratio, ref_r, "float32")
    assert out.x.dtype == tin[0].dtype and out.x.shape == tin[0].shape
    # Σ(x'−x)² is the squared update of the leaf in its own dtype
    old = tin[0].to(torch.float32)
    np.testing.assert_allclose(float(out.delta_sq),
                               float(((out.x.to(torch.float32) - old) ** 2).sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["phi_bounds", "no_trust", "no_wd", "zero_x"])
def test_lamb_update_options_match_jax(case):
    shape = (2, 500)
    jin, tin = _inputs(shape, "float32", seed=1)
    if case == "zero_x":  # ‖x‖ = 0: the ratio falls back to 1
        jin = (jnp.zeros(shape),) + jin[1:]
        tin = (torch.zeros(shape),) + tin[1:]
    ref_kw = dict(lr=0.1, weight_decay=0.01, step=3, layer_axis=0, return_ratio=True)
    port_kw = dict(weight_decay=0.01, layer_axis=0)
    if case == "phi_bounds":
        ref_kw["phi_bounds"] = (0.5, 2.0)
        port_kw.update(phi_lo=0.5, phi_hi=2.0)
    elif case == "no_trust":
        ref_kw["apply_trust"] = port_kw["apply_trust"] = False
    elif case == "no_wd":
        ref_kw["weight_decay"] = port_kw["weight_decay"] = 0.0
    out = _port(tin, 3, 0.1, **port_kw)
    x2, m2, v2, r2 = lamb_update_ref(*jin, **ref_kw)
    assert_close(out.x, x2, "float32")
    assert_close(out.m, m2, "float32")
    assert_close(out.v, v2, "float32")
    assert_close(out.ratio, r2, "float32")
    if case == "zero_x":
        assert torch.all(out.ratio == 1.0)


def test_lamb_update_rejects_bad_inputs():
    x = torch.zeros(4, 8)
    good = dict(g=torch.zeros(4, 8), m=torch.zeros(4, 8), v=torch.zeros(4, 8))
    with pytest.raises(ValueError):
        lamb_update(x, good["g"], good["m"], good["v"], 1, 0.1, layer_axis=1)
    with pytest.raises(ValueError):
        lamb_update(x, torch.zeros(4, 9), good["m"], good["v"], 1, 0.1)
    with pytest.raises(TypeError):
        lamb_update(x, good["g"], good["m"].double(), good["v"], 1, 0.1)
    with pytest.raises(ValueError):
        lamb_update(x, good["g"].t(), good["m"], good["v"], 1, 0.1)


def test_fused_lamb_step_matches_jax_over_bert_smoke():
    """Three steps of make_fused_lamb_step over the bert-smoke tree, with its
    masks and layer axes, a warmup schedule and clipping, from the same
    weights and gradients as JAX's make_fused_lamb_step(mode="interpret")."""
    jcfg = jax_bert.smoke().replace(use_flash_kernel=False, use_fused_ce_head=False)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(bert_large.smoke().replace(use_flash_kernel=False,
                                                   use_fused_ce_head=False))
    params = params_from_jax(jparams)
    state = fused_lamb_init(params)
    jstate = jax_fused_lamb_init(jparams)
    kw = dict(grad_clip_norm=1.0)
    jstep = jax_make_fused_lamb_step(
        jax_warmup_poly_decay(0.01, 10, 2), weight_decay=0.01,
        wd_mask=jmodel.wd_mask(), trust_mask=jmodel.trust_mask(),
        layer_axes=jmodel.layer_axes(), mode="interpret", **kw)
    step = make_fused_lamb_step(
        warmup_poly_decay(0.01, 10, 2), weight_decay=0.01,
        wd_mask=model.wd_mask(), trust_mask=model.trust_mask(),
        layer_axes=model.layer_axes(), **kw)
    assert list(params) == list(model.wd_mask())
    rng = np.random.default_rng(3)
    for _ in range(3):
        gnp = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                           jparams)
        jparams, jstate = jstep(jparams, jax.tree.map(jnp.asarray, gnp), jstate)
        step(params, params_from_jax(gnp), state)
    for k, v in params_from_jax(jparams).items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    ref_state = state_from_jax(jstate)
    assert int(state.count) == int(ref_state.count) == 3
    assert int(state.sched_count) == int(ref_state.sched_count) == 3
    for k in params:
        np.testing.assert_allclose(state.mu[k].numpy(), ref_state.mu[k].numpy(), **F32)
        np.testing.assert_allclose(state.nu[k].numpy(), ref_state.nu[k].numpy(), **F32)
