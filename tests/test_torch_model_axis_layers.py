"""The layers that split over ``model`` beyond the dense transformers, in one
process: the MoE (expert parallelism), MLA (naive and absorbed), Mamba and
the mLSTM and sLSTM blocks, each whole and as M ranks' shares, held to the
JAX package's layer on the same numpy weights, forward and backward.

The ranks are threads of ``collectives.run_plain_ranks``: each runs the
port's own layer on its block of every leaf (the spec's block, as the
train step hands it over; a leaf the specs keep whole is the one tensor
of every rank) under a ``ShardCtx`` whose ``model`` group is a plain group,
so that every cross-rank sum and gather is its plain version over the
ranks' operands; one backward pass over the joined graph gives every
rank's gradients (a leaf split over ``model`` compared as its ranks'
blocks laid side by side).  A replicated output (the MoE's aux losses) is
counted once, from rank 0.  Gradients are of ``Σ out·dy`` (plus the MoE's
load-balance and z-losses).

Bounds, fp32, each of the tensor's scale (its largest magnitude, at least
1): the ranks against the whole port layer within ``RANKS_TOL`` 1e-5 (the
fp32 sums add in other orders; measured at most 9.3e-7), the mLSTM's
within ``MLSTM_RANKS_TOL`` 3e-4 (measured 9.5e-5: the gradient of its gate
biases is a cancelling sum through exponential gates, which magnify the
order of the q, k, v and gate sums), and both against the JAX layer within
``JAX_TOL`` 3e-4, tests/test_torch_recurrent.py's bound for these cells
(measured at most 1.5e-4, the whole port mLSTM's gate bias; 1.5e-6
elsewhere).  Cases beyond the smoke configs: six experts over
four ranks (the specs keep the experts whole, and every rank runs the
whole layer), an mLSTM of three heads over two ranks (every rank runs
every head and keeps its ``inner`` columns of h), and a Mamba whose
2·d_inner splits over four ranks while d_inner does not (every rank runs
the whole layer on the gathered ``in_proj``).  With state (serving), each
layer over a ``model`` axis runs and equals the whole layer.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro import nn as jax_nn
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models.layers import mamba as jax_mamba
from repro.models.layers import mla as jax_mla
from repro.models.layers import moe as jax_moe
from repro.models.layers import xlstm as jax_xlstm
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import mamba, mla, moe, xlstm
from repro_torch.nn import flatten, params_from_jax
from repro_torch.sharding import ShardCtx, leaf_layout, specs_for, use_sharding
from repro_torch.sharding import collectives as C

RANKS_TOL = 1e-5      # the ranks against the whole port layer, of the scale
MLSTM_RANKS_TOL = 3e-4   # the mLSTM's: see the module docstring
JAX_TOL = 3e-4        # either against the JAX layer (tests/test_torch_recurrent.py's)
B, S = 2, 16
F32 = dict(activation_dtype="float32")
MOE = dict(capacity_factor=0.5, router_z_coef=1e-3, **F32)
AUX = ("moe_lb_loss", "moe_z_loss")


def _pair(arch, **kw):
    return jax_smoke_config(arch).replace(**kw), smoke_config(arch).replace(**kw)


def _own(**kw):
    return JaxModelConfig(**kw), ModelConfig(**kw)


# six experts (top-2) over four ranks: the experts stay whole
E6 = dict(name="moe-e6", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
          d_ff=64, vocab_size=64, n_experts=6, n_experts_per_tok=2, moe_d_ff=16, **MOE)
# three mLSTM heads over two ranks: inner (192) splits, the heads do not
H3 = dict(name="xlstm-h3", family="ssm", n_layers=2, d_model=96, n_heads=3, n_kv_heads=3,
          d_ff=0, vocab_size=64, slstm_ratio=2, xlstm_proj_factor=2.0, use_rope=False,
          norm_type="layernorm", **F32)
# Mamba with d_inner 30 over four ranks: in_proj's 60 columns split, d_inner does not
ODD = dict(name="mamba-odd", family="hybrid", n_layers=2, d_model=30, n_heads=2,
           n_kv_heads=2, d_ff=60, vocab_size=64, mamba_expand=1, **F32)


def _mla_call(lib):
    def call(p, x, cfg):
        b, s = x.shape[:2]
        if lib is jax_mla:
            out, _ = lib.mla_attention(p, x, jnp.broadcast_to(jnp.arange(s)[None], (b, s)), cfg)
        else:
            out = lib.mla_attention(p, x, torch.arange(s)[None].expand(b, s), cfg)
        return out, {}
    return call


def _first(fn):
    return lambda p, x, cfg: (fn(p, x, cfg)[0], {})


# name: ((JAX config, port config), JAX defs, port defs, JAX call, port call, ranks)
CASES = {
    "moe": (_pair("granite-moe-1b-a400m", **MOE), jax_moe.moe_defs, moe.moe_defs,
            jax_moe.moe, moe.moe, 2),
    "moe_shared": (_pair("deepseek-v3-671b", **MOE), jax_moe.moe_defs, moe.moe_defs,
                   jax_moe.moe, moe.moe, 2),
    "moe_e6_over_4": (_own(**E6), jax_moe.moe_defs, moe.moe_defs, jax_moe.moe, moe.moe, 4),
    "mla_naive": (_pair("deepseek-v3-671b", **F32), jax_mla.mla_defs, mla.mla_defs,
                  _mla_call(jax_mla), _mla_call(mla), 2),
    "mla_absorbed": (_pair("deepseek-v3-671b", mla_absorb=True, **F32), jax_mla.mla_defs,
                     mla.mla_defs, _mla_call(jax_mla), _mla_call(mla), 4),
    "mamba": (_pair("jamba-1.5-large-398b", **F32), jax_mamba.mamba_defs, mamba.mamba_defs,
              _first(jax_mamba.mamba), _first(mamba.mamba), 2),
    "mamba_over_4": (_pair("jamba-1.5-large-398b", **F32), jax_mamba.mamba_defs,
                     mamba.mamba_defs, _first(jax_mamba.mamba), _first(mamba.mamba), 4),
    "mamba_odd_inner": (_own(**ODD), jax_mamba.mamba_defs, mamba.mamba_defs,
                        _first(jax_mamba.mamba), _first(mamba.mamba), 4),
    "mlstm": (_pair("xlstm-350m", **F32), jax_xlstm.mlstm_defs, xlstm.mlstm_defs,
              _first(jax_xlstm.mlstm_block), _first(xlstm.mlstm_block), 2),
    "mlstm_h3_over_2": (_own(**H3), jax_xlstm.mlstm_defs, xlstm.mlstm_defs,
                        _first(jax_xlstm.mlstm_block), _first(xlstm.mlstm_block), 2),
    "slstm": (_pair("xlstm-350m", **F32), jax_xlstm.slstm_defs, xlstm.slstm_defs,
              _first(jax_xlstm.slstm_block), _first(xlstm.slstm_block), 2),
}


def _params(jax_defs, seed=0):
    """The JAX layer's params, every all-zero leaf drawn at random so that
    it is used: (the nested JAX tree, the port's flat dict)."""
    params = jax_nn.init_params(jax_defs, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
                          if not np.asarray(a).any() else a, params)
    return params, params_from_jax(params)


def _loss_terms(out, aux, dy):
    return (out * dy).sum() + sum(aux[k] for k in AUX if k in aux)


def _jax_grads(call, jparams, x, dy, cfg):
    def loss(p, xx):
        out, aux = call(p, xx, cfg)
        return jnp.sum(out * dy) + sum(aux[k] for k in AUX if k in aux), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jparams, jnp.asarray(x))
    return np.asarray(out), np.asarray(gx), {k: np.asarray(v) for k, v in flatten(gp).items()}


def _port_whole(call, params, x, dy, cfg):
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = torch.from_numpy(x).requires_grad_()
    out, aux = call(p, xx, cfg)
    _loss_terms(out, aux, torch.from_numpy(dy)).backward()
    return out.detach().numpy(), xx.grad.numpy(), {k: v.grad.numpy() for k, v in p.items()}


def _port_ranks(call, defs, params, x, dy, cfg, m):
    """Each of ``m`` ranks' layer on its blocks over a plain group; the
    outputs and gradients of the joined graph, leaves laid whole."""
    sizes = {"data": 1, "model": m}
    specs = specs_for(defs, Mesh(sizes))
    dims = {k: leaf_layout(s, Mesh(sizes)).model for k, s in specs.items()}
    shared = {k: v.clone().requires_grad_() for k, v in params.items() if dims[k] is None}
    blocks = [{k: shared[k] if dims[k] is None
               else C.shard_leaf(v, dims[k], m, r).requires_grad_()
               for k, v in params.items()} for r in range(m)]
    xx = torch.from_numpy(x).requires_grad_()

    def rank(group):
        mesh = Mesh(sizes, rank=group.index, groups={("model",): group})
        with use_sharding(ShardCtx(mesh, param_specs=specs)):
            return call(blocks[group.index], xx, cfg)

    got = C.run_plain_ranks(rank, m)
    out, aux = got[0]   # every rank's output is the whole (summed or replicated)
    _loss_terms(out, aux, torch.from_numpy(dy)).backward()
    grads = {k: (shared[k].grad if dims[k] is None else
                 C.gather_leaf_plain([b[k].grad for b in blocks], dims[k])).numpy()
             for k in params}
    return out.detach().numpy(), xx.grad.numpy(), grads, [g[1] for g in got]


def _close(a, ref, tol, msg):
    np.testing.assert_allclose(a, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_over_model_ranks_matches_whole_and_jax(case):
    (jcfg, cfg), jdefs, defs, jcall, call, m = CASES[case]
    jparams, params = _params(jdefs(jcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = _jax_grads(jcall, jparams, x, dy, jcfg)
    whole = _port_whole(call, params, x, dy, cfg)
    out, gx, grads, auxs = _port_ranks(call, defs(cfg), params, x, dy, cfg, m)
    for name, a, w, j in (("out", out, whole[0], want[0]), ("dx", gx, whole[1], want[1]),
                          *((f"d {k}", grads[k], whole[2][k], want[2][k]) for k in params)):
        _close(w, j, JAX_TOL, f"{case}: {name}, whole against JAX")
        _close(a, w, MLSTM_RANKS_TOL if case.startswith("mlstm") else RANKS_TOL,
               f"{case}: {name}, ranks against whole")
        _close(a, j, JAX_TOL, f"{case}: {name}, ranks against JAX")
    for aux in auxs:   # the routing is every rank's: its terms are the whole layer's
        for k, v in aux.items():
            assert torch.equal(v.detach(), auxs[0][k].detach()), (case, k)
    if case.startswith("moe") and case != "moe_e6_over_4":
        assert float(auxs[0]["moe_drop_fraction"].detach()) > 0, case   # tokens drop


def test_split_cases_split():
    """The cases split what they say: two experts a rank, the MLA's heads,
    Mamba's and the mLSTM's ``inner`` and the sLSTM's heads over
    ``model``; and six experts over four ranks, three mLSTM heads over two
    and d_inner 30 over four stay whole."""
    def dims(case):
        (_, cfg), _, defs, _, _, m = CASES[case]
        mesh = Mesh({"data": 1, "model": m})
        return {k: leaf_layout(s, mesh).model for k, s in specs_for(defs(cfg), mesh).items()}

    assert dims("moe") == {"router": 1, "wi": 0, "wg": 0, "wo": 0}
    assert dims("moe_shared")["shared/wi"] == 1
    assert set(dims("moe_e6_over_4").values()) == {None}
    assert dims("mla_naive")["wq_b"] == 1 and dims("mla_naive")["wq_a"] is None
    assert dims("mamba")["in_proj"] == 1 and dims("mamba")["x_proj"] == 0
    assert dims("mamba_odd_inner")["in_proj"] == 1 and dims("mamba_odd_inner")["D"] is None
    assert dims("mlstm")["wq"] == 0 and dims("mlstm")["b_igate"] == 0
    assert dims("mlstm_h3_over_2")["wq"] == 0 and dims("mlstm_h3_over_2")["b_igate"] is None
    assert dims("slstm")["w_i"] == 1 and dims("slstm")["out_norm"] is None


@pytest.mark.parametrize("layer", ["mla", "mamba", "mlstm", "slstm"])
def test_layers_with_state_on_a_mesh_raise(layer):
    """Prefill and decode with state over ``model`` were serving on a mesh
    (ROADMAP.md item 11 (e)), which each layer refused; they no longer
    raise.  Each layer over two plain ranks, with the state the rank's
    block of the cache (the MLA's latents whole, Mamba's state whole under
    the default rules, the cells' by heads), prefills 8 positions and
    decodes one step, and its outputs and final state equal the whole
    layer's within ``RANKS_TOL`` (the mLSTM's ``MLSTM_RANKS_TOL``), fp32
    (tests/test_torch_serve_mesh_layers.py holds every case to JAX)."""
    from repro_torch.sharding import cache_block, cache_shardings, default_act_rules, leaf_dims

    arch = {"mla": "deepseek-v3-671b", "mamba": "jamba-1.5-large-398b"}.get(layer, "xlstm-350m")
    jcfg, cfg = _pair(arch, **F32)
    jdefs, defs = {"mla": (jax_mla.mla_defs, mla.mla_defs),
                   "mamba": (jax_mamba.mamba_defs, mamba.mamba_defs),
                   "mlstm": (jax_xlstm.mlstm_defs, xlstm.mlstm_defs),
                   "slstm": (jax_xlstm.slstm_defs, xlstm.slstm_defs)}[layer]
    defs = defs(cfg)
    fresh = {"mla": lambda: mla.init_mla_cache(1, 12, cfg, torch.float32),
             "mamba": lambda: mamba.init_mamba_state(1, cfg, torch.float32),
             "mlstm": lambda: xlstm.init_mlstm_state(1, cfg),
             "slstm": lambda: xlstm.init_slstm_state(1, cfg)}[layer]
    _, params = _params(jdefs(jcfg))
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal((1, n, cfg.d_model)).astype(np.float32))
          for n in (8, 1)]
    pos = [torch.arange(8)[None], torch.full((1, 1), 8)]

    def serve(p, state):
        outs = []
        for i, (x, ps) in enumerate(zip(xs, pos)):
            if layer == "mla":
                outs.append(mla.mla_attention(p, x, ps, cfg, cache=state, decode=i > 0))
                continue
            fn = {"mamba": mamba.mamba, "mlstm": xlstm.mlstm_block,
                  "slstm": xlstm.slstm_block}[layer]
            out, state = fn(p, x, cfg, state=state, decode=i > 0)
            outs.append(out)
        return outs, state

    with torch.no_grad():
        want, want_state = serve(params, fresh())
    sizes = {"data": 1, "model": 2}
    specs = specs_for(defs, Mesh(sizes))
    rules = default_act_rules()
    stacked = {k: v[None] for k, v in fresh().items()}
    lays = leaf_dims(cache_shardings(stacked, Mesh(sizes), rules), Mesh(sizes))

    def rank(group):
        mesh = Mesh(sizes, rank=group.index, groups={("model",): group})
        block = {k: C.shard_leaf(v, leaf_layout(specs[k], mesh).model, 2, group.index)
                 for k, v in params.items()}
        state = {k: v[0] for k, v in cache_block(stacked, mesh, rules, "cpu").items()}
        with torch.no_grad(), use_sharding(ShardCtx(mesh, rules, specs)):
            return serve(block, state)

    got = C.run_plain_ranks(rank, 2)
    tol = MLSTM_RANKS_TOL if layer == "mlstm" else RANKS_TOL
    for a, w in zip(got[0][0], want):
        _close(a.numpy(), w.numpy(), tol, f"{layer}: output")
    for k, w in want_state.items():
        dim = lays[k].model
        a = C.gather_leaf_plain([g[1][k][None] for g in got], dim)[0]
        _close(a.numpy(), w.numpy(), tol, f"{layer}: state {k}")


def test_plain_ranks_swap_every_operand():
    """More ranks than cores and a short switch interval: every exchange of
    every round hands each rank every rank's operand of that round, in rank
    order; a rank that raises breaks the barrier, and its error is the one
    raised."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = C.run_plain_ranks(lambda g: [g.exchange((g.index, i)) for i in range(100)], 16,
                                timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert got == [[[(r, i) for r in range(16)] for i in range(100)]] * 16

    def one_fails(group):
        if group.index == 1:
            raise ValueError("rank 1")
        group.exchange(group.index)

    with pytest.raises(ValueError, match="rank 1"):
        C.run_plain_ranks(one_fails, 4, timeout=60)
