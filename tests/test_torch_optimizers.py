"""The port's unfused optimizers against the JAX package's: every transform
of ``optim/base``, ``core/{strategy,trust_ratio,lamb,lars,nlamb,lans}`` and
``optim/baselines``, all ten optimizers, and the transform form of fused
LAMB, on one small tree with a stacked leaf and masked-out leaves.

Inputs are numpy draws from a seed; each case runs 3 updates from the
same state and holds the updates and every state leaf (under the
reference's leaf paths) at the port's ``F32`` (rtol 1e-5, atol 1e-6,
``tests/test_torch_lamb.py``), bf16 moments at the JAX suite's own bound
for them (rtol 0.05, atol 5e-3, ``tests/test_optimizers.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import optim as joptim
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.kernels import fused_lamb as jax_fused_lamb
from repro_torch import core, optim
from repro_torch.checkpoint import tree_leaves_with_paths
from repro_torch.core import warmup_poly_decay
from repro_torch.kernels import fused_lamb
from repro_torch.nn import flatten, state_from_jax

F32 = dict(rtol=1e-5, atol=1e-6)
BF16_MOMENTS = dict(rtol=0.05, atol=5e-3)
STEPS = 3

# the model's metadata, nested as the JAX package takes it
LAYER_AXES = {"blocks": {"w": 0, "scale": 0}, "embed": -1, "bias": -1}
WD_MASK = {"blocks": {"w": True, "scale": False}, "embed": True, "bias": False}
TRUST_MASK = {"blocks": {"w": True, "scale": False}, "embed": True, "bias": True}
META = dict(layer_axes=LAYER_AXES, wd_mask=WD_MASK, trust_mask=TRUST_MASK)


def _tree(rng, scale=1.0):
    shapes = {"blocks": {"w": (3, 4, 5), "scale": (3, 5)}, "embed": (7, 6), "bias": (6,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)

    return draw(shapes)


def _inputs(grad_scale=1.0):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    params["bias"][:] = 0.0     # a zero leaf: trust ratio 1
    grads = [_tree(rng, grad_scale) for _ in range(STEPS)]
    grads[1]["blocks"]["w"][1] = 0.0   # a zero layer slice of a stacked leaf
    return params, grads


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()}


def _flat_meta(meta):
    return {k: flatten(v) if isinstance(v, dict) else v for k, v in meta.items()}


def _leaves(state):
    return [(p, v.to(torch.float32).numpy()) for p, v in tree_leaves_with_paths(state)]


def _run(jtx, ptx, *, grad_scale=1.0, tol=F32, state_tol=None):
    """3 updates of both transforms on the same inputs; updates and state
    compared after each (state through the bridge, so its paths too)."""
    params, grads = _inputs(grad_scale)
    jp, pp = _jax(params), _port(params)
    js, ps = jtx.init(jp), ptx.init(pp)
    for g in grads:
        ju, js = jtx.update(_jax(g), js, jp)
        pu, ps = ptx.update(_port(g), ps, pp)
        ref = {k: np.asarray(v, np.float32) for k, v in flatten(ju).items()}
        assert list(pu) == list(ref)
        for k in ref:
            np.testing.assert_allclose(pu[k].to(torch.float32).numpy(), ref[k], **tol,
                                       err_msg=k)
        got, want = _leaves(ps), _leaves(state_from_jax(js))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, **(state_tol or tol), err_msg=p)
    return ps


def _schedules():
    return jax_warmup_poly_decay(0.1, 10, 2), warmup_poly_decay(0.1, 10, 2)


# ---------------------------------------------------------------------------
# every transform of optim/base, core/strategy and core/lans
# ---------------------------------------------------------------------------

def _pair(name):
    """(JAX transform, port transform, state tolerance or None)."""
    m = _flat_meta(META)
    jsched, sched = _schedules()
    adam_kw = {
        "adam": {}, "adam_nesterov_m": dict(nesterov_m=True),
        "adam_nesterov_mv": dict(nesterov_m=True, nesterov_v=True),
        "adam_no_bias_correction": dict(bias_correction=False),
        "adam_bf16_moments": dict(moment_dtype="bfloat16"),
    }
    if name in adam_kw:
        kw = adam_kw[name]
        tol = BF16_MOMENTS if "moment_dtype" in kw else None
        return joptim.scale_by_adam(0.9, 0.99, 1e-6, **kw), optim.scale_by_adam(
            0.9, 0.99, 1e-6, **kw), tol
    trust_kw = {
        "trust": dict(layer_axes=LAYER_AXES, trust_mask=TRUST_MASK),
        "trust_phi_bounds": dict(layer_axes=LAYER_AXES, phi_bounds=(0.5, 2.0)),
        "trust_unstacked_eps": dict(eps=1e-3),
        "trust_l1": dict(layer_axes=LAYER_AXES, norm_ord="l1"),
        "trust_linf": dict(layer_axes=LAYER_AXES, norm_ord="linf"),
    }
    if name in trust_kw:
        kw = trust_kw[name]
        pkw = {k: flatten(v) if isinstance(v, dict) else v for k, v in kw.items()}
        return jcore.layerwise_adaptation(**kw), core.layerwise_adaptation(**pkw), None
    return {
        "trace": (joptim.trace(0.9), optim.trace(0.9), None),
        "trace_sum": (joptim.trace(0.8, average=False), optim.trace(0.8, average=False),
                      None),
        "adagrad": (joptim.scale_by_adagrad(), optim.scale_by_adagrad(), None),
        "decay": (joptim.add_decayed_weights(0.1), optim.add_decayed_weights(0.1), None),
        "decay_mask": (joptim.add_decayed_weights(0.1, WD_MASK),
                       optim.add_decayed_weights(0.1, m["wd_mask"]), None),
        "clip": (joptim.clip_by_global_norm(1.0), optim.clip_by_global_norm(1.0), None),
        "clip_no_op": (joptim.clip_by_global_norm(1e3), optim.clip_by_global_norm(1e3),
                       None),
        "scale": (joptim.scale(-0.5), optim.scale(-0.5), None),
        "identity": (joptim.identity(), optim.identity(), None),
        "lr_schedule": (joptim.scale_by_learning_rate(jsched),
                        optim.scale_by_learning_rate(sched), None),
        "lr_constant_no_flip": (joptim.scale_by_learning_rate(0.3, flip_sign=False),
                                optim.scale_by_learning_rate(0.3, flip_sign=False), None),
        "lans_direction": (jcore.scale_by_lans(0.9, 0.99, 1e-6, 0.01, **META),
                           core.scale_by_lans(0.9, 0.99, 1e-6, 0.01, **m), None),
        "lans_direction_l1_no_bias_correction": (
            jcore.scale_by_lans(bias_correction=False, norm_ord="l1", **META),
            core.scale_by_lans(bias_correction=False, norm_ord="l1", **m), None),
        "layerwise_adapt_trace": (
            jcore.layerwise_adapt(joptim.trace(0.9), layer_axes=LAYER_AXES),
            core.layerwise_adapt(optim.trace(0.9), layer_axes=m["layer_axes"]), None),
    }[name]


TRANSFORMS = [
    "adam", "adam_nesterov_m", "adam_nesterov_mv", "adam_no_bias_correction",
    "adam_bf16_moments", "trace", "trace_sum", "adagrad", "decay", "decay_mask", "clip",
    "clip_no_op", "scale", "identity", "lr_schedule", "lr_constant_no_flip", "trust",
    "trust_phi_bounds", "trust_unstacked_eps", "trust_l1", "trust_linf",
    "lans_direction", "lans_direction_l1_no_bias_correction", "layerwise_adapt_trace",
]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(name):
    jtx, ptx, state_tol = _pair(name)
    _run(jtx, ptx, grad_scale=3.0, state_tol=state_tol,
         tol=BF16_MOMENTS if state_tol else F32)


def test_transforms_write_nothing_they_are_given():
    """The guard's select needs the old state: no transform writes its inputs."""
    m = _flat_meta(META)
    params, grads = _inputs()
    pp, g = _port(params), _port(grads[0])
    opt = core.lans(0.1, grad_clip_norm=1.0, **m)
    state = opt.update(g, opt.init(pp), pp)[1]
    before = [(p, v.clone()) for p, v in tree_leaves_with_paths((pp, g, state))]
    for o in (opt, core.lamb(0.1, grad_clip_norm=1.0, **m), core.lars(0.1, weight_decay=0.1, **m),
              optim.adagrad(0.1), fused_lamb(0.1, grad_clip_norm=1.0, **m)):
        o.update(g, o.init(pp) if o is not opt else state, pp)
    after = dict(tree_leaves_with_paths((pp, g, state)))
    for p, v in before:
        assert torch.equal(after[p], v), p


@pytest.mark.parametrize("norm_ord", ["l2", "l1", "linf"])
def test_normalize_grads_matches_jax(norm_ord):
    _, grads = _inputs(5.0)
    got = core.normalize_grads(_port(grads[1]), layer_axes=flatten(LAYER_AXES),
                               norm_ord=norm_ord)
    want = flatten(jcore.normalize_grads(_jax(grads[1]), layer_axes=LAYER_AXES,
                                         norm_ord=norm_ord))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), **F32, err_msg=k)


def test_trust_diagnostics_match_jax():
    params, grads = _inputs()
    kw = dict(phi_bounds=(0.5, 2.0))
    tree = core.trust_ratio_tree(_port(params), _port(grads[1]),
                                 layer_axes=flatten(LAYER_AXES), **kw)
    jtree = jcore.trust_ratio_tree(_jax(params), _jax(grads[1]), layer_axes=LAYER_AXES, **kw)
    recs = core.trust_records(_port(params), _port(grads[1]),
                              layer_axes=flatten(LAYER_AXES), **kw)
    jrecs = jcore.trust_records(_jax(params), _jax(grads[1]), layer_axes=LAYER_AXES, **kw)
    for got, want in [(tree, jtree)] + [(recs[k], jrecs[k]) for k in jrecs]:
        want = flatten(want)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == np.shape(want[k]), k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **F32, err_msg=k)
    summary, jsummary = core.summarize_trust_ratios(tree), jcore.summarize_trust_ratios(jtree)
    assert set(summary) == set(jsummary)
    for k in jsummary:
        np.testing.assert_allclose(float(summary[k]), float(jsummary[k]), **F32, err_msg=k)


# ---------------------------------------------------------------------------
# the ten optimizers
# ---------------------------------------------------------------------------

def _optimizers(name):
    m = _flat_meta(META)
    jsched, sched = _schedules()
    return {
        "lamb": (jcore.lamb(jsched, grad_clip_norm=1.0, **META),
                 core.lamb(sched, grad_clip_norm=1.0, **m)),
        "lans": (jcore.lans(jsched, grad_clip_norm=1.0, **META),
                 core.lans(sched, grad_clip_norm=1.0, **m)),
        "lars": (jcore.lars(jsched, 0.9, 0.01, **META), core.lars(sched, 0.9, 0.01, **m)),
        "nlamb": (jcore.nlamb(0.05, grad_clip_norm=1.0, **META),
                  core.nlamb(0.05, grad_clip_norm=1.0, **m)),
        "nnlamb": (jcore.nnlamb(0.05, **META), core.nnlamb(0.05, **m)),
        "sgd": (joptim.sgd(jsched), optim.sgd(sched)),
        "momentum": (joptim.momentum(0.05, 0.9, 0.01, WD_MASK),
                     optim.momentum(0.05, 0.9, 0.01, m["wd_mask"])),
        "adam": (joptim.adam(0.05, l2_regularization=0.01),
                 optim.adam(0.05, l2_regularization=0.01)),
        "adamw": (joptim.adamw(jsched, wd_mask=WD_MASK), optim.adamw(sched, wd_mask=m["wd_mask"])),
        "adagrad": (joptim.adagrad(0.05), optim.adagrad(0.05)),
    }[name]


@pytest.mark.parametrize("name", ["lamb", "lans", "lars", "nlamb", "nnlamb", "sgd",
                                  "momentum", "adam", "adamw", "adagrad"])
def test_optimizer_matches_jax(name):
    jopt, opt = _optimizers(name)
    _run(jopt, opt, grad_scale=3.0)


@pytest.mark.parametrize("name", ["lamb", "nlamb", "nnlamb", "lars"])
def test_first_update_has_norm_lr_times_x_norm(name):
    """The strategy's invariant: each trust-masked-in layer slice's update
    has norm lr·‖x‖, whatever the gradients' scale."""
    m = _flat_meta(META)
    params, grads = _inputs(1e6)
    pp = _port(params)
    opt = {"lamb": core.lamb, "nlamb": core.nlamb, "nnlamb": core.nnlamb}.get(
        name, lambda lr, **kw: core.lars(lr, weight_decay=0.01, **kw))(0.05, **m)
    u, _ = opt.update(_port(grads[0]), opt.init(pp), pp)
    for k, x in pp.items():
        if not m["trust_mask"][k] or not x.any():
            continue
        dims = tuple(range(1, x.ndim)) if m["layer_axes"][k] == 0 else None
        got = torch.linalg.vector_norm(u[k], dim=dims)
        want = 0.05 * torch.linalg.vector_norm(x, dim=dims)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# the transform form of fused LAMB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 1.0])
def test_fused_lamb_transform_matches_core_lamb_and_jax(clip):
    """``fused_lamb`` (the plain version of K1/K2 here) against the port's
    ``core.lamb`` chain and the JAX package's ``fused_lamb`` (Pallas in
    interpret mode): updates at ``F32``, and the moments of the two forms
    of the port against each other."""
    m = _flat_meta(META)
    jsched, sched = _schedules()
    state = _run(jax_fused_lamb(jsched, grad_clip_norm=clip, interpret=True, **META),
                 fused_lamb(sched, grad_clip_norm=clip, **m), grad_scale=3.0)
    chain_state = _run(jcore.lamb(jsched, grad_clip_norm=clip, **META),
                       core.lamb(sched, grad_clip_norm=clip, **m), grad_scale=3.0)
    adam = chain_state[1 if clip else 0]
    assert int(state.count) == int(adam.count) == STEPS
    assert int(state.sched_count) == int(chain_state[-1].count) == STEPS
    for k in state.mu:
        torch.testing.assert_close(state.mu[k], adam.mu[k], **F32)
        torch.testing.assert_close(state.nu[k], adam.nu[k], **F32)
