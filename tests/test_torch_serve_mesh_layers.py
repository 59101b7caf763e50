"""Serving on a mesh, layer by layer, in one process: each layer that holds a
cache or state, as M ranks' shares, runs a prefill and four decode steps,
held to the whole port layer and to the JAX layer on the same numpy
weights.

The ranks are threads of ``collectives.run_plain_ranks`` (as in
``tests/test_torch_model_axis_layers.py``): each runs the port's own layer
on its parameter blocks and on its block of the cache, the block that
``placement.cache_block`` cuts under the context's activation rules, under
a ``ShardCtx`` whose group is a plain group, so that every cross-rank sum,
gather, max and combine is its plain version over the ranks' tensors.

Over ``model``: attention with its kv heads split, with one kv head whole
on every rank and with twelve heads over three kv heads (a rank's q heads
straddle their kv heads unevenly); MLA naive and absorbed (the latent cache
whole on every rank); Mamba with the dry-run's ``inner`` rule (the rank's
slice of the state) and without it (the reference's default rules: the
state whole, each rank's new slice gathered); the mLSTM (also three heads
over two ranks, every rank running every head) and the sLSTM.  Over the
data-parallel ranks at batch 1 with the cache's sequence split (the
reference's ``cache_seq`` rule): attention and MLA at data=2 and data=4
with a 16-position cache, a 6-position prompt (at data=4 it ends inside
rank 1's block) and decode steps at positions 6–9 that cross a block
boundary, and attention under a sliding window of 4 (at data=4 rank 0's
block then holds no valid key).

Everything is fp32.  The ranks' outputs and their final cache or state
(the blocks laid whole) against the whole port layer within ``RANKS_TOL``
1e-5 of the tensor's scale (the fp32 sums add in other orders), the
mLSTM's within ``MLSTM_RANKS_TOL`` 3e-4 (its exponential gates magnify
the order of the row-parallel q, k, v and gate sums: measured 1.4e-5 of
the scale), and both against the JAX layer within ``JAX_TOL`` 3e-4 (the
bounds of ``tests/test_torch_model_axis_layers.py``).

The slot pool on a mesh (``KVPool(shard_ctx=)``): for each family's cache,
each rank of data=2,model=2 holds its block (four slots, two a data rank;
or three slots the data ranks do not divide under ``cache_seq``), and
inserts, an evict, a quarantine and its release, a decode step's
``advance`` and ``reset_inactive`` leave the blocks laid whole equal to the
whole pool, the index whole on every rank, and every block but the slot
owner's untouched by an insert.  The pool's per-slot index under the
sequence split: attention (also under a sliding window, at data=4) and MLA
decode three rows of their own lengths, one of which has no valid key in
a rank's block, on each rank's block of positions, against the whole
cache within ``RANKS_TOL``.

Budget: 90 s on one worker (about 20 s alone; 36-50 s in a whole run of
the suite with six workers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models.layers import attention as jax_attention
from repro.models.layers import mamba as jax_mamba
from repro.models.layers import mla as jax_mla
from repro.models.layers import xlstm as jax_xlstm
from repro_torch.checkpoint.io import tree_leaves_with_paths
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import attention, mamba, mla, xlstm
from repro_torch.nn import init_params
from repro_torch.sharding import (
    ShardCtx,
    cache_block,
    cache_shardings,
    default_act_rules,
    leaf_dims,
    leaf_layout,
    specs_for,
    use_sharding,
)
from repro_torch.sharding import collectives as C

RANKS_TOL = 1e-5   # the ranks against the whole port layer, of the scale
MLSTM_RANKS_TOL = 3e-4   # the mLSTM's: see the module docstring
JAX_TOL = 3e-4     # either against the JAX layer
B, S, T, STEPS = 2, 6, 16, 4
F32 = dict(activation_dtype="float32")
ATTN = dict(family="dense", n_layers=2, vocab_size=64, d_ff=64, **F32)


def _own(**kw):
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _pair(arch, **kw):
    return jax_smoke_config(arch).replace(**kw), smoke_config(arch).replace(**kw)


LAYERS = {
    "attention": (jax_attention.attention_defs, attention.attention_defs),
    "mla": (jax_mla.mla_defs, mla.mla_defs),
    "mamba": (jax_mamba.mamba_defs, mamba.mamba_defs),
    "mlstm": (jax_xlstm.mlstm_defs, xlstm.mlstm_defs),
    "slstm": (jax_xlstm.slstm_defs, xlstm.slstm_defs),
}   # (JAX defs, port defs): the port's draw the weights, by path

# name: (layer, (JAX config, port config), mesh axis, ranks, activation rule
# overrides, batch)
CASES = {
    "attn_kv_split": ("attention", _own(name="kv-split", d_model=64, n_heads=4, n_kv_heads=2,
                                       **ATTN), "model", 2, {}, B),
    "attn_kv_whole": ("attention", _own(name="kv-whole", d_model=64, n_heads=4, n_kv_heads=1,
                                        **ATTN), "model", 2, {}, B),
    "attn_kv_whole_uneven": ("attention", _own(name="kv-uneven", d_model=96, n_heads=12,
                                               n_kv_heads=3, **ATTN), "model", 2, {}, B),
    "mla_naive": ("mla", _pair("deepseek-v3-671b", **F32), "model", 2, {}, B),
    "mla_absorbed": ("mla", _pair("deepseek-v3-671b", mla_absorb=True, **F32), "model", 4,
                     {}, B),
    "mamba_inner_rule": ("mamba", _pair("jamba-1.5-large-398b", **F32), "model", 2,
                         {"inner": ("model",)}, B),
    "mamba_whole_state": ("mamba", _pair("jamba-1.5-large-398b", **F32), "model", 2, {}, B),
    "mlstm": ("mlstm", _pair("xlstm-350m", **F32), "model", 2, {}, B),
    "mlstm_h3_over_2": ("mlstm", _own(name="xlstm-h3", family="ssm", n_layers=2, d_model=96,
                                      n_heads=3, n_kv_heads=3, d_ff=0, vocab_size=64,
                                      slstm_ratio=2, xlstm_proj_factor=2.0, use_rope=False,
                                      norm_type="layernorm", **F32), "model", 2, {}, B),
    "slstm": ("slstm", _pair("xlstm-350m", **F32), "model", 2, {}, B),
    "attn_seq_data2": ("attention", _pair("smollm-360m", **F32), "data", 2,
                       {"cache_seq": ("data",)}, 1),
    "attn_seq_data4": ("attention", _pair("smollm-360m", **F32), "data", 4,
                       {"cache_seq": ("data",)}, 1),
    "attn_seq_window": ("attention", _pair("smollm-360m", sliding_window=4, **F32), "data", 4,
                        {"cache_seq": ("data",)}, 1),
    "mla_seq_data2": ("mla", _pair("deepseek-v3-671b", **F32), "data", 2,
                      {"cache_seq": ("data",)}, 1),
    "mla_seq_data4_absorbed": ("mla", _pair("deepseek-v3-671b", mla_absorb=True, **F32),
                               "data", 4, {"cache_seq": ("data",)}, 1),
}


def _params(defs, seed=0):
    """The port's init of the layer, every all-zero leaf drawn at random so
    that it is used: (the JAX layer's nested tree, the port's flat dict)."""
    rng = np.random.default_rng(seed)
    flat = {k: v.numpy() if v.any() else (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            for k, v in init_params(defs, seed, torch.device("cpu")).items()}
    tree: dict = {}
    for path, a in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(a)
    return tree, {k: torch.from_numpy(a) for k, a in flat.items()}


def _port_cache(layer, b, cfg):
    """The layer's fresh cache with a stacked-layer axis of one, as a
    model's ``make_cache`` leaves have (the placement keys on it)."""
    one = {"attention": lambda: attention.init_kv_cache(b, T, cfg, torch.float32),
           "mla": lambda: mla.init_mla_cache(b, T, cfg, torch.float32),
           "mamba": lambda: mamba.init_mamba_state(b, cfg, torch.float32),
           "mlstm": lambda: xlstm.init_mlstm_state(b, cfg),
           "slstm": lambda: xlstm.init_slstm_state(b, cfg)}[layer]()
    return {k: v[None] for k, v in one.items()}


def _jax_cache(layer, b, cfg):
    return {"attention": lambda: jax_attention.init_kv_cache(b, T, cfg, jnp.float32),
            "mla": lambda: jax_mla.init_mla_cache(b, T, cfg, jnp.float32),
            "mamba": lambda: jax_mamba.init_mamba_state(b, cfg, jnp.float32),
            "mlstm": lambda: jax_xlstm.init_mlstm_state(b, cfg),
            "slstm": lambda: jax_xlstm.init_slstm_state(b, cfg)}[layer]()


def _port_step(layer, p, x, pos, cfg, cache, decode):
    """One call of the port's layer: (out, the cache after it)."""
    if layer in ("attention", "mla"):
        fn = attention.attention if layer == "attention" else mla.mla_attention
        return fn(p, x, pos, cfg, cache=cache, decode=decode), cache
    fn = {"mamba": mamba.mamba, "mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}[layer]
    out, new = fn(p, x, cfg, state=cache, decode=decode)
    return out, new


def _jax_step(layer, cfg, decode):
    """The JAX layer's call, jitted: (p, x, positions, cache) → (out, cache)."""
    if layer in ("attention", "mla"):
        fn = jax_attention.attention if layer == "attention" else jax_mla.mla_attention
        return jax.jit(lambda p, x, pos, cache: fn(p, x, pos, cfg, cache=cache, decode=decode))
    fn = {"mamba": jax_mamba.mamba, "mlstm": jax_xlstm.mlstm_block,
          "slstm": jax_xlstm.slstm_block}[layer]
    return jax.jit(lambda p, x, pos, cache: fn(p, x, cfg, state=cache, decode=decode))


def _inputs(b, d):
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((b, S, d)).astype(np.float32)]
    xs += [rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(STEPS)]
    pos = [np.broadcast_to(np.arange(S, dtype=np.int32), (b, S))]
    pos += [np.full((b, 1), S + t, np.int32) for t in range(STEPS)]
    return xs, pos


def _serve_port(layer, p, cfg, cache, xs, pos):
    """Prefill then the decode steps: (each call's output, the last cache)."""
    outs = []
    for i, (x, ps) in enumerate(zip(xs, pos)):
        out, cache = _port_step(layer, p, torch.from_numpy(x), torch.from_numpy(ps.copy()),
                                cfg, cache, decode=i > 0)
        outs.append(out)
    return outs, cache


def _ranks(layer, case, defs, params, cfg, b, xs, pos):
    """Each rank's layer on its blocks over a plain group: the ranks'
    outputs (rank 0's, every rank's equal) and their final cache, each
    leaf's blocks laid whole."""
    _, _, axis, m, overrides, _ = CASES[case]
    sizes = {"data": m if axis == "data" else 1, "model": m if axis == "model" else 1}
    rules = dict(default_act_rules(), **overrides)
    specs = specs_for(defs, Mesh(sizes))
    dims = {k: leaf_layout(s, Mesh(sizes)).model for k, s in specs.items()}
    whole_cache = _port_cache(layer, b, cfg)
    lays = leaf_dims(cache_shardings(whole_cache, Mesh(sizes), rules), Mesh(sizes))

    def rank(group):
        mesh = Mesh(sizes, rank=group.index, groups={(axis,): group})
        block = {k: C.shard_leaf(v, dims[k], m, group.index) for k, v in params.items()}
        cache = cache_block(whole_cache, mesh, rules, "cpu")
        ctx = ShardCtx(mesh, rules, specs, cache_seq_split=axis == "data",
                       rows_split=axis != "data")
        with torch.no_grad(), use_sharding(ctx):
            outs, cache = _serve_port(layer, block, cfg, {k: v[0] for k, v in cache.items()},
                                      xs, pos)
        return outs, cache

    got = C.run_plain_ranks(rank, m)
    for outs, _ in got[1:]:
        for a, w in zip(outs, got[0][0]):
            torch.testing.assert_close(a, w, rtol=0, atol=0)
    final = {}
    for k, _ in tree_leaves_with_paths(whole_cache):
        lay = lays[k]
        dim = lay.data if axis == "data" else lay.model
        final[k] = C.gather_leaf_plain([g[1][k][None] for g in got],
                                       None if dim is None else dim).numpy()[0]
    return [o.numpy() for o in got[0][0]], final


def _close(a, ref, tol, msg):
    np.testing.assert_allclose(a, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())),
                               err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_serves_over_ranks_as_whole_and_jax(case):
    layer, (jcfg, cfg), axis, m, _, b = CASES[case]
    defs = LAYERS[layer][1]
    jparams, params = _params(defs(cfg))
    xs, pos = _inputs(b, cfg.d_model)

    jcache, jouts = _jax_cache(layer, b, jcfg), []
    prefill, decode = _jax_step(layer, jcfg, False), _jax_step(layer, jcfg, True)
    for i, (x, ps) in enumerate(zip(xs, pos)):
        out, jcache = (decode if i else prefill)(jparams, jnp.asarray(x), jnp.asarray(ps), jcache)
        jouts.append(np.asarray(out))
    with torch.no_grad():
        wouts, wcache = _serve_port(layer, params, cfg,
                                    {k: v[0] for k, v in _port_cache(layer, b, cfg).items()},
                                    xs, pos)
    wouts = [o.numpy() for o in wouts]
    routs, rcache = _ranks(layer, case, defs(cfg), params, cfg, b, xs, pos)
    tol = MLSTM_RANKS_TOL if layer == "mlstm" else RANKS_TOL

    for i, (r, w, j) in enumerate(zip(routs, wouts, jouts)):
        _close(w, j, JAX_TOL, f"{case}: call {i}, whole against JAX")
        _close(r, w, tol, f"{case}: call {i}, ranks against whole")
        _close(r, j, JAX_TOL, f"{case}: call {i}, ranks against JAX")
    for k, j in jcache.items():
        j = np.asarray(j)
        w = wcache[k].numpy()
        _close(w, j, JAX_TOL, f"{case}: cache {k}, whole against JAX")
        _close(rcache[k], w, tol, f"{case}: cache {k}, ranks against whole")


def test_cases_split_what_they_say():
    """The cases' caches split as their docstrings say: the kv heads over
    model or whole, the latent cache whole, Mamba's state by the ``inner``
    rule only, the cells' state by heads, and the sequence over data."""
    def cache_dims(case):
        layer, (_, cfg), axis, m, overrides, b = CASES[case]
        sizes = {"data": m if axis == "data" else 1, "model": m if axis == "model" else 1}
        rules = dict(default_act_rules(), **overrides)
        return {k: (lay.data, lay.model) for k, lay in leaf_dims(
            cache_shardings(_port_cache(layer, b, cfg), Mesh(sizes), rules),
            Mesh(sizes)).items()}

    # (the dimension data splits, the one model splits): the batch of two
    # splits over data=1, the batch of one over none
    assert cache_dims("attn_kv_split")["k"] == (1, 3)
    assert cache_dims("attn_kv_whole")["k"] == (1, None)
    assert cache_dims("attn_kv_whole_uneven")["v"] == (1, None)
    assert cache_dims("mla_naive")["c_kv"] == (1, None)
    assert cache_dims("mamba_inner_rule")["ssm"] == (1, 2)
    assert cache_dims("mamba_inner_rule")["conv"] == (1, 3)
    assert cache_dims("mamba_whole_state")["ssm"] == (1, None)
    assert cache_dims("mlstm")["c"] == (1, 2)
    assert cache_dims("mlstm_h3_over_2")["c"] == (1, None)
    assert cache_dims("slstm")["m"] == (1, 2)
    assert cache_dims("attn_seq_data4")["k"] == (2, None)
    assert cache_dims("mla_seq_data2")["k_rope"] == (2, None)


def test_serving_rows_follow_the_batch_rule():
    """A rank's rows of a serving batch: its block where the rules split
    the batch over every data-parallel axis, every row where they split it
    over none (batch 1), and a ``ValueError`` where they would split it
    over only some (two rows over pod=2,data=2)."""
    from repro_torch.sharding import serving_rows

    mesh = Mesh({"pod": 2, "data": 2, "model": 1}, rank=3)
    rules = default_act_rules(multi_pod=True)
    assert serving_rows(8, mesh, rules) == (6, 2, True)
    assert serving_rows(1, mesh, rules) == (0, 1, False)
    assert serving_rows(3, mesh, rules) == (0, 3, False)
    with pytest.raises(ValueError, match="every data-parallel axis"):
        serving_rows(2, mesh, rules)


def test_cache_block_is_make_cache_at_one_rank_and_a_block_beyond():
    """``placement.cache_block`` over one rank allocates what the family's
    ``make_cache`` does (the xLSTM stabiliser at -1e9, every other leaf 0);
    over model=2 each leaf at its block's shape, the rules of
    ``ShardCtx.with_rules``, which keeps the specs and flags."""
    from repro_torch.models import build_model

    for arch in ("xlstm-350m", "jamba-1.5-large-398b", "deepseek-v3-671b"):
        model = build_model(smoke_config(arch))
        whole = model.make_cache(2, 8, "cpu")
        one = cache_block(model.make_cache(2, 8, "meta"), Mesh({"data": 1, "model": 1}),
                          default_act_rules(), "cpu")
        for k, v in tree_leaves_with_paths(whole):
            got = dict(tree_leaves_with_paths(one))[k]
            assert got.dtype == v.dtype and torch.equal(got, v), (arch, k)
    model = build_model(smoke_config("xlstm-350m"))
    mesh = Mesh({"data": 1, "model": 2}, rank=1, groups={("model",): object()})
    ctx = ShardCtx(mesh, rows_split=False).with_rules(heads=("model",))
    assert not ctx.rows_split and ctx.act_rules["heads"] == ("model",)
    block = cache_block(model.make_cache(2, 8, "meta"), mesh, ctx.act_rules, "cpu")
    assert block["sub0"]["c"].shape == (1, 2, 2, 64, 64)
    assert block["sub1"]["m"].shape == (1, 2, 2, 32)
    assert float(block["sub1"]["m"].max()) == -1e9


def test_launch_counts_lose_no_update_across_rank_threads(monkeypatch):
    """The model ranks of one process launch K3 on threads (the card's
    phase 19): every wrapper's count (flash's, the fused CE head's, LAMB's
    and the copy counter) adds under ``launches.LOCK``, which a recording
    lock in its place sees taken once a count.  Then sixteen threads, more
    than the cores, each add 2000 through flash's count under a switch
    interval of 1 µs: none is lost."""
    import importlib
    import sys
    import threading

    from repro_torch.kernels import COPIES, LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.flash_attention import _count
    from repro_torch.kernels.fused_ce import _count as ce_count

    launches = importlib.import_module("repro_torch.kernels.launches")

    class Recording:
        def __init__(self):
            self.lock, self.taken = threading.Lock(), 0

        def __enter__(self):
            self.lock.acquire()
            self.taken += 1

        def __exit__(self, *exc):
            self.lock.release()

    saved = (dict(LAUNCHES), {k: dict(v) for k, v in VARIANT_LAUNCHES.items()}, dict(COPIES))
    counts = [lambda: _count("flash_fwd", torch.bfloat16),
              lambda: ce_count("fused_ce_fwd", "mma"),
              lambda: launches.count_launch("lamb_moments"),
              lambda: launches.count_copy("flash_do")]
    old = sys.getswitchinterval()
    try:
        for count in counts:
            rec = Recording()
            monkeypatch.setattr(launches, "LOCK", rec)
            count()
            count()
            assert rec.taken == 2
        monkeypatch.undo()
        before = (LAUNCHES["flash_fwd"], VARIANT_LAUNCHES["flash_fwd"]["mma"])
        sys.setswitchinterval(1e-6)
        C.run_plain_ranks(lambda g: [_count("flash_fwd", torch.bfloat16) for _ in range(2000)],
                          16, timeout=60)
        assert LAUNCHES["flash_fwd"] - before[0] == 16 * 2000
        assert VARIANT_LAUNCHES["flash_fwd"]["mma"] - before[1] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        LAUNCHES.update(saved[0])
        for k, v in saved[1].items():
            VARIANT_LAUNCHES[k].update(v)
        COPIES.update(saved[2])


# ---------------------------------------------------------------------------
# the slot pool on a mesh: each rank's block against the whole pool
# ---------------------------------------------------------------------------

POOL_ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "deepseek-v3-671b",
              "jamba-1.5-large-398b", "xlstm-350m")
POOL_MESH = {"data": 2, "model": 2}
# (slots, rule overrides): four slots, two a data rank; three, which the
# data ranks do not divide, under cache_seq (each rank its block of positions)
POOL_LAYOUTS = {"rows": (4, {}), "seq": (3, {"cache_seq": ("data",)})}
POOL_LEN = 8


def _pool_blocks(pools, lays, whole):
    """Every leaf of the ranks' pools laid whole (the blocks concatenated
    along the dimension data splits and the one model splits), the index
    checked whole and equal on every rank."""
    from repro_torch.launch.mesh import Mesh

    out = {}
    for k, w in tree_leaves_with_paths(whole.cache):
        leaves = [dict(tree_leaves_with_paths(p.cache))[k] for p in pools]
        if k.endswith("/index"):
            for leaf in leaves:
                assert torch.equal(leaf, w), k
            out[k] = leaves[0]
            continue
        lay = lays[k]
        coords = [Mesh(POOL_MESH, rank=r).coords() for r in range(len(pools))]
        by_data = [C.gather_leaf_plain([x for x, c in zip(leaves, coords) if c["data"] == d],
                                       lay.model) for d in range(POOL_MESH["data"])]
        out[k] = C.gather_leaf_plain(by_data, lay.data)
    return out


@pytest.mark.parametrize("layout", list(POOL_LAYOUTS))
@pytest.mark.parametrize("arch", POOL_ARCHS)
def test_pool_ops_on_rank_blocks_equal_the_whole_pool(arch, layout):
    """``KVPool(shard_ctx=)`` on each rank of data=2,model=2 against the
    whole pool: two inserts, an evict, a quarantine and its release, a
    decode step over each rank's ``decode_view`` and its ``advance``, and
    ``reset_inactive``.  After each, the
    ranks' blocks laid whole equal the whole pool, the (layers, slots)
    index is whole and equal on every rank, the host mirrors agree, and an
    insert changes no block but its slot's owner's."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.serve import KVPool
    from repro_torch.serve.kv_pool import reset_inactive

    slots, overrides = POOL_LAYOUTS[layout]
    model = build_model(smoke_config(arch).replace(**F32))
    rules = dict(default_act_rules(), **overrides)
    whole = KVPool(model, slots, POOL_LEN, "cpu")
    gen = torch.Generator().manual_seed(7)
    for _, leaf in tree_leaves_with_paths(whole.cache):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    n = Mesh(POOL_MESH).size
    meshes = [Mesh(POOL_MESH, rank=r) for r in range(n)]
    specs = specs_for(model.defs, meshes[0])
    pools = [KVPool(model, slots, POOL_LEN, "cpu", shard_ctx=ShardCtx(m, rules, specs))
             for m in meshes]
    meta = model.make_cache(slots, POOL_LEN, "meta")
    lays = leaf_dims(cache_shardings(meta, meshes[0], rules), meshes[0])
    for m, pool in zip(meshes, pools):   # the whole pool's state, each rank's block of it
        for k, leaf in tree_leaves_with_paths(pool.cache):
            if not k.endswith("/index"):
                leaf.copy_(C.shard_block(dict(tree_leaves_with_paths(whole.cache))[k],
                                         lays[k], m))

    def check(label):
        for k, got in _pool_blocks(pools, lays, whole).items():
            assert torch.equal(got, dict(tree_leaves_with_paths(whole.cache))[k]), (label, k)
        for pool in pools:
            assert (pool.lengths == whole.lengths).all() and pool._free == whole._free, label
            assert pool.n_free == whole.n_free, label

    if layout == "rows":
        assert [p.rows for p in pools] == [(0, 2), (0, 2), (2, 2), (2, 2)]
        assert not pools[0].ctx.cache_seq_split and pools[0].ctx.rows_split
    else:
        assert [p.rows for p in pools] == [(0, slots)] * n
        # the xLSTM's state has no sequence to split
        assert pools[0].ctx.cache_seq_split == (arch != "xlstm-350m")
        assert pools[0].row_ctx.cache_seq_split == pools[0].ctx.cache_seq_split
    assert not pools[0].row_ctx.rows_split
    check("fresh")
    for length in (5, 3):
        taken = {p.acquire() for p in [whole, *pools]}
        assert len(taken) == 1
        slot = taken.pop()
        single = whole.row_cache()
        for _, leaf in tree_leaves_with_paths(single):
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
        before = [{k: v.clone() for k, v in tree_leaves_with_paths(p.cache)} for p in pools]
        whole.insert(single, slot, length)
        for m, pool, old in zip(meshes, pools, before):
            row = {k: v.shape for k, v in tree_leaves_with_paths(pool.row_cache())}
            mine = {}
            for k, v in tree_leaves_with_paths(single):
                lay = lays[k] if not k.endswith("/index") else None
                # a row's block: the split of the batch dimension (1) dropped
                block = v if lay is None else C.shard_block(
                    v, lay._replace(splits=tuple(sp for sp in lay.splits
                                                 if sp != (1, lay.dp))), m)
                assert block.shape == row[k], (k, block.shape, row[k])
                mine[k] = block
            nested = {seg: {} for seg in single}
            for k, v in mine.items():
                seg, name = k.split("/")
                nested[seg][name] = v
            pool.insert(nested, slot, length)
            start, rows = pool.rows
            if not start <= slot < start + rows:
                for k, v in tree_leaves_with_paths(pool.cache):
                    if not k.endswith("/index"):
                        assert torch.equal(v, old[k]), ("a rank that does not own the slot "
                                                        "wrote it", k)
        check(f"insert {slot}")
    for p in [whole, *pools]:
        p.evict(1)
    check("evict")
    for p in [whole, *pools]:
        p.quarantine(0)
    check("quarantine")
    for p in [whole, *pools]:
        p.release(0)
    check("release")
    for p in [whole, *pools]:
        p.insert(p.row_cache(), p.acquire(), 2)
    active = torch.from_numpy(whole.active_mask)
    for leaves in whole.cache.values():   # a decode step over every row, then the clamp
        if "index" in leaves:
            leaves["index"].add_(1)
    reset_inactive(whole.cache, active)
    for pool in pools:   # the step moves its view's index, then the pool's advance
        for leaves in pool.decode_view().values():
            if "index" in leaves:
                leaves["index"].add_(1)
        pool.advance(active)
    check("advance")
    for p in [whole, *pools]:
        reset_inactive(p.cache, torch.zeros(slots, dtype=torch.bool))
    check("reset_inactive")


# the per-slot index under the sequence split: three rows at lengths 2, 7
# and 12 of a 16-position cache over data=2 and data=4 (row 0 has no valid
# key past rank 0's block), three decode steps crossing block boundaries
SLOT_LENGTHS, SLOT_STEPS = (2, 7, 12), 3
SLOT_CASES = {
    "attn_data2": ("attention", _pair("smollm-360m", **F32), 2),
    "attn_data4_window": ("attention", _pair("smollm-360m", sliding_window=4, **F32), 4),
    "mla_data2": ("mla", _pair("deepseek-v3-671b", **F32), 2),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_per_slot_decode_over_the_sequence_split_equals_the_whole_cache(case):
    """``write_decode`` with the slot pool's (B,) index on each data rank's
    block of positions: each row written by the rank whose block holds its
    index alone, each rank's keys masked against each row's own length and
    the ranks' partial softmaxes combined; the outputs and the final cache
    (blocks laid whole) against the whole cache's."""
    layer, (_, cfg), m = SLOT_CASES[case]
    defs = LAYERS[layer][1]
    _, params = _params(defs(cfg))
    b = len(SLOT_LENGTHS)
    whole = {k: v[0] for k, v in _port_cache(layer, b, cfg).items()}
    gen = torch.Generator().manual_seed(11)
    for k, v in whole.items():
        if k != "index":
            v.copy_(torch.randn(v.shape, generator=gen))
    whole["index"] = torch.tensor(SLOT_LENGTHS, dtype=torch.int32)
    start = whole["index"].clone()
    xs = [torch.randn((b, 1, cfg.d_model), generator=gen) for _ in range(SLOT_STEPS)]
    sizes = {"data": m, "model": 1}
    rules = dict(default_act_rules(), cache_seq=("data",))
    specs = specs_for(defs(cfg), Mesh(sizes))

    def serve(cache):
        outs = []
        for i, x in enumerate(xs):
            pos = (start + i)[:, None]
            outs.append(_port_step(layer, params, x, pos, cfg, cache, decode=True)[0])
        return outs, cache

    cache0 = {k: v.clone() for k, v in whole.items()}
    with torch.no_grad():
        wouts, wcache = serve(whole)

    def rank(group):
        mesh = Mesh(sizes, rank=group.index, groups={("data",): group})
        cache = {k: (v.clone() if k == "index" else C.shard_leaf(v, 1, m, group.index))
                 for k, v in cache0.items()}
        ctx = ShardCtx(mesh, rules, specs, cache_seq_split=True, rows_split=False)
        with torch.no_grad(), use_sharding(ctx):
            return serve(cache)

    got = C.run_plain_ranks(rank, m)
    for outs, cache in got:
        for i, (a, w) in enumerate(zip(outs, wouts)):
            _close(a.numpy(), w.numpy(), RANKS_TOL, f"{case}: step {i}")
        assert torch.equal(cache["index"], wcache["index"])
    for k, w in wcache.items():
        if k != "index":
            laid = C.gather_leaf_plain([g[1][k] for g in got], 1)
            _close(laid.numpy(), w.numpy(), RANKS_TOL, f"{case}: cache {k}")


def test_engines_serve_from_blocks_stored_under_a_param_rule():
    """smollm-smoke in fp32 over data=2,model=2 thread ranks, its params
    stored under ``--param-rule embed=data,model`` (each 2-D leaf cut into
    four blocks along ``embed``): both engines take each block to the
    layers' layout (``RankParams``: gathered over data and model, cut to
    the rank's heads), and every rank's greedy tokens equal the single
    process's."""
    from repro_torch.launch.mesh import run_plain_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine, Engine, Request, ServeRequest
    from repro_torch.sharding import ShardCtx, default_param_rules, override_rules, specs_for

    cfg = smoke_config("smollm-360m").replace(activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, torch.device("cpu"))
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n).astype(np.int32)
               for i, n in enumerate((6, 4, 6, 5))]
    rules = override_rules(default_param_rules(), ["embed=data,model"])

    def serve(mesh=None):
        ctx = None if mesh is None else ShardCtx(mesh, param_specs=specs_for(
            model.defs, mesh, rules))
        static = Engine(model, params, max_len=12, shard_ctx=ctx).generate_batch(
            [Request(p, max_new_tokens=4) for p in prompts])
        cont = ContinuousEngine(model, params, n_slots=2, max_len=12, shard_ctx=ctx)
        done = cont.generate([ServeRequest(p, max_new_tokens=4, rid=i)
                              for i, p in enumerate(prompts)])
        blocks = None if ctx is None else cont._rank.blocks
        return ([[int(t) for t in r.out_tokens] for r in static],
                [[int(t) for t in r.out_tokens] for r in done], blocks)

    static, cont, _ = serve()
    outs = run_plain_mesh(serve, {"data": 2, "model": 2})
    assert outs[0][2]["blocks/attn/wq"].shape[1] == params["blocks/attn/wq"].shape[1] // 4
    for got_static, got_cont, _ in outs:
        assert got_static == static and got_cont == cont
