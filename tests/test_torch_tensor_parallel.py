"""Tensor parallelism over a ``model`` axis, in process: each rank's layout
against the JAX package's specs, the vocab-parallel fused CE (the plain K6
on vocab slices, merged by the plain reductions) against the whole vocab
and the JAX package's fused CE, the ``model`` axis's operators on a gloo
group of one, per-rank state bytes of BERT-large, and what a ``model`` axis
still refuses.  The ranks themselves run in
``tests/test_torch_tensor_parallel_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.kernels import fused_ce as jax_fused_ce
from repro.launch.mesh import abstract_mesh as jax_abstract_mesh
from repro.models import build_model as jax_build_model
from repro.sharding import specs_for as jax_specs_for
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_ce import (
    combine_vocab_slices,
    fused_ce_dh_plain,
    fused_ce_dw_plain,
    fused_ce_fwd_plain,
)
from repro_torch.launch.mesh import Mesh, parse_mesh_spec
from repro_torch.models import build_model
from repro_torch.models.layers.attention import attention, init_kv_cache
from repro_torch.models.layers.tensor_parallel import column_matmul, row_matmul
from repro_torch.nn import flatten
from repro_torch.sharding import (
    ShardCtx,
    leaf_dims,
    per_device_state_bytes,
    shard_tree,
    specs_for,
    use_sharding,
)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.context import ModelAxis

TP_MESHES = ["data=2,model=2", "data=1,model=2", "data=4,model=4"]
# tests/_torch_sharded_harness.py's TINY
TINY = dict(name="tiny-sharded", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, tie_embeddings=True)
CONFIGS = {
    "bert-smoke": (lambda: smoke_config("bert-large"), lambda: jax_smoke_config("bert-large")),
    "tiny": (lambda: ModelConfig(**TINY), lambda: JaxModelConfig(**TINY)),
    "smollm-smoke": (lambda: smoke_config("smollm-360m"),
                     lambda: jax_smoke_config("smollm-360m")),
    # expert parallelism, the xLSTM/Mamba inner axis and MLA heads
    **{name: (lambda a=arch: smoke_config(a), lambda a=arch: jax_smoke_config(a))
       for name, arch in (("granite-moe-smoke", "granite-moe-1b-a400m"),
                          ("xlstm-smoke", "xlstm-350m"),
                          ("jamba-smoke", "jamba-1.5-large-398b"),
                          ("deepseek-smoke", "deepseek-v3-671b"))},
}
MODEL_AXIS_ARCHS = ["granite-moe-1b-a400m", "xlstm-350m", "jamba-1.5-large-398b",
                    "deepseek-v3-671b"]
F32 = dict(rtol=1e-5, atol=1e-5)        # tests/test_torch_fused_ce.py's bounds
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
IDX_INF = torch.iinfo(torch.int32).max


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


def _jax_layout(spec, sizes):
    """(data dim, model dim) of a JAX PartitionSpec entry list: the
    dimension naming ``data`` (size 1 too), and the one naming ``model``
    when the axis has more than one rank."""
    data = model = None
    for i, entry in enumerate(spec):
        names = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        if "data" in names:
            data = i
        if "model" in names and sizes["model"] > 1:
            model = i
    return data, model


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_rank_layouts_match_jax_specs(arch, mesh):
    """Each leaf's layout is the JAX spec's, and every rank's block is the
    one the spec gives that rank's coordinates: the blocks of all ranks,
    gathered along data then model, are the whole leaf."""
    sizes = parse_mesh_spec(mesh)
    port_cfg, jax_cfg = (f() for f in CONFIGS[arch])
    model = build_model(port_cfg)
    port_mesh = Mesh(sizes)
    layouts = leaf_dims(specs_for(model.defs, port_mesh), port_mesh)
    jspecs = _flat_specs(jax_specs_for(jax_build_model(jax_cfg).defs,
                                       jax_abstract_mesh(tuple(sizes.values()), tuple(sizes))))
    assert layouts.keys() == jspecs.keys()
    assert {k: (v.data, v.model) for k, v in layouts.items()} == {
        k: _jax_layout(s, sizes) for k, s in jspecs.items()}
    whole = model.init(0, torch.device("cpu"))
    n_data, n_model = sizes["data"], sizes["model"]
    blocks = {r: shard_tree(whole, layouts, Mesh(sizes, rank=r)) for r in range(n_data * n_model)}
    for k, x in whole.items():
        data, mdim = layouts[k].data, layouts[k].model
        rows = []
        for d in range(n_data):
            parts = [blocks[d * n_model + m][k] for m in range(n_model)]
            rows.append(C.gather_leaf_plain(parts, mdim) if mdim is not None else parts[0])
            assert all(torch.equal(p, parts[0]) for p in parts) or mdim is not None, k
        got = C.gather_leaf_plain(rows, data) if data is not None else rows[0]
        assert torch.equal(got, x), k


def _slices(h, w, lbl, m, block_v=64):
    """The plain K6 on ``m`` vocab slices of ``w`` and their merge by the
    plain reductions: ``(lse, label logit, argmax)`` and the slices."""
    vs = w.shape[0] // m
    stats = [fused_ce_fwd_plain(h, w[r * vs:(r + 1) * vs], lbl, block_v, v0=r * vs, stats=True)
             for r in range(m)]
    lse, ll, row_max, row_idx = (torch.stack([s[i] for s in stats]) for i in (2, 3, 4, 5))
    merged = combine_vocab_slices(lse, ll, row_max, row_idx,
                                  lambda op, x: C.all_reduce_plain(x.unbind(0), op))
    return merged, vs


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("n,d,v", [(48, 32, 320), (17, 16, 64), (64, 64, 1024)])
def test_vocab_parallel_ce_matches_whole_vocab_and_jax(n, d, v, m):
    """K6 on M slices, merged: nll and lse within 1e-5 of the whole vocab's
    plain K6 and the JAX package's fused CE (XLA backend), ``correct``
    equal on every row, a row whose maximum ties across two slices
    included (the first maximum wins); the slices' K7 partials summed and
    their K8 rows concatenated against the whole vocab's dh and dw and
    the JAX package's gradients, at tests/test_torch_fused_ce.py's fp32
    bounds."""
    rng = np.random.default_rng(n + v + m)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    lbl = rng.integers(0, v, n).astype(np.int32)
    vs = v // m
    # row 0: two equal maxima, at the last column of slice 0 and the first
    # of slice 1, with the label on the second; row 1: the label on the first
    w[vs - 1] = w[vs] = 4.0 * h[0] / np.linalg.norm(h[0]) ** 2 * 10.0
    h[1] = h[0]
    lbl[0], lbl[1] = vs, vs - 1
    wts = ((rng.random(n) > 0.3) * rng.random(n)).astype(np.float32)
    th, tw, tl, g = (torch.from_numpy(x) for x in (h, w, lbl, wts))
    (lse, ll, idx), _ = _slices(th, tw, tl, m)
    nll, correct = lse - ll, (idx == tl).to(torch.float32)
    want_nll, want_correct, want_lse = fused_ce_fwd_plain(th, tw, tl, 64)
    np.testing.assert_allclose(nll.numpy(), want_nll.numpy(), **F32)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **F32)
    assert torch.equal(correct, want_correct)
    assert correct[0] == 0.0 and correct[1] == 1.0 and int(idx[0]) == vs - 1

    jnll, jcorrect = jax_fused_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lbl),
                                  block_n=16, block_v=64, backend="xla")
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), **F32)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))

    dh = sum(fused_ce_dh_plain(th, tw[r * vs:(r + 1) * vs], tl - r * vs, lse, g, 64)
             for r in range(m))
    dw = torch.cat([fused_ce_dw_plain(th, tw[r * vs:(r + 1) * vs], tl - r * vs, lse, g, 64)
                    for r in range(m)])
    whole_dh = fused_ce_dh_plain(th, tw, tl, want_lse, g, 64)
    whole_dw = fused_ce_dw_plain(th, tw, tl, want_lse, g, 64)
    np.testing.assert_allclose(dh.numpy(), whole_dh.numpy(), **F32_GRAD)
    np.testing.assert_allclose(dw.numpy(), whole_dw.numpy(), **F32_GRAD)
    jdh, jdw = jax.grad(lambda a, b: jnp.sum(jax_fused_ce(
        a, b, jnp.asarray(lbl), block_n=16, block_v=64, backend="xla")[0] * wts),
        (0, 1))(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), **F32_GRAD)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **F32_GRAD)


def test_vocab_slice_statistics():
    """The slice statistics: the label logit only where the slice holds the
    label (else -1e30, and never correct), the row max and its first
    column as a global index."""
    gen = torch.Generator().manual_seed(3)
    h, w = torch.randn(9, 8, generator=gen), torch.randn(40, 8, generator=gen)
    lbl = torch.tensor([0, 5, 19, 20, 21, 39, 10, 30, 25], dtype=torch.int32)
    s = h @ w.t()
    nll, correct, lse, ll, row_max, row_idx = fused_ce_fwd_plain(h, w[20:], lbl, 8, v0=20,
                                                                 stats=True)
    mine = lbl >= 20
    pick = s[torch.arange(9), lbl.long()]
    assert torch.allclose(ll[mine], pick[mine], atol=1e-5) and (ll[~mine] == -1e30).all()
    assert torch.allclose(row_max, s[:, 20:].amax(1), atol=1e-5)
    assert torch.equal(row_idx, s[:, 20:].argmax(1).to(torch.int32) + 20)
    assert torch.allclose(lse, torch.logsumexp(s[:, 20:], 1), atol=1e-5)
    assert (correct[~mine] == 0).all()
    assert torch.equal(correct[mine], (row_idx[mine] == lbl[mine]).to(torch.float32))


@pytest.fixture
def group_of_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_axis_operators_equal_their_plain_versions(group_of_one, dtype):
    """copy_to_model (identity forward, sum backward) and reduce_from_model
    (sum forward, identity backward) against their plain versions, on a
    group of one; the plain versions' own autograd: the copy's gradient is
    the sum of the ranks', each partial's is the sum's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=gen).to(dtype).requires_grad_()
    dy = torch.randn(3, 5, generator=gen).to(dtype)
    y = C.copy_to_model(x, group_of_one)
    assert torch.equal(y, x)
    (gx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(gx, dy)
    z = C.reduce_from_model(x, group_of_one)
    assert torch.equal(z, C.reduce_from_model_plain([x]))
    (gz,) = torch.autograd.grad(z, x, dy)
    assert torch.equal(gz, dy)
    scales = [torch.randn(3, 5, generator=gen).to(dtype) for _ in range(3)]
    (gp,) = torch.autograd.grad(sum((c * s).sum() for c, s in
                                    zip(C.copy_to_model_plain(x, 3), scales)), x)
    assert torch.allclose(gp.float(), sum(s.float() for s in scales), atol=2e-2)
    parts = [torch.randn(3, 5, generator=gen).to(dtype).requires_grad_() for _ in range(3)]
    grads = torch.autograd.grad(C.reduce_from_model_plain(parts), parts, dy)
    assert all(torch.equal(g, dy) for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_parallel_products_round_split_contractions_once(group_of_one, dtype):
    """column_matmul and row_matmul on a group of one: what the ranks split
    (the row product's forward, the column product's input gradient) is the
    fp32 product of the operands rounded once; the rest is the plain
    product and its autograd."""
    gen = torch.Generator().manual_seed(0)
    tp = ModelAxis(group_of_one, 0, 2)
    x = torch.randn(2, 3, 16, generator=gen).to(dtype).requires_grad_()
    w = torch.randn(16, 8, generator=gen).to(dtype).requires_grad_()
    dy = torch.randn(2, 3, 8, generator=gen).to(dtype)

    def once(a, b):
        return (a.float() @ b.float()).to(dtype)

    y = column_matmul(x, w, tp)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    px, pw = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    want = px @ pw
    want_gx, want_gw = torch.autograd.grad(want, (px, pw), dy)
    assert torch.equal(y, want) and torch.equal(gw, want_gw)
    assert torch.equal(gx, once(dy, w.detach().t()))
    assert torch.allclose(gx.float(), want_gx.float(), rtol=1e-2, atol=1e-2)
    h = torch.randn(2, 3, 8, generator=gen).to(dtype).requires_grad_()
    w2 = torch.randn(8, 16, generator=gen).to(dtype).requires_grad_()
    dz = torch.randn(2, 3, 16, generator=gen).to(dtype)
    z = row_matmul(h, w2, tp)
    assert torch.equal(z, once(h.detach(), w2.detach()))
    gh, gw2 = torch.autograd.grad(z, (h, w2), dz)
    ph, pw2 = h.detach().clone().requires_grad_(), w2.detach().clone().requires_grad_()
    want_gh, want_gw2 = torch.autograd.grad(ph @ pw2, (ph, pw2), dz)
    assert torch.equal(gh, want_gh) and torch.equal(gw2, want_gw2)
    assert column_matmul(x, w, None).equal(x @ w) and row_matmul(h, w2, None).equal(h @ w2)


@pytest.mark.parametrize("mesh", ["data=2,model=2", "data=4,model=2", "data=4,model=4"])
def test_bert_large_per_rank_state_bytes(mesh):
    """Params + μ + ν of one rank of full-width BERT-large, from meta
    tensors cut to its block: what the JAX specs give (each dimension over
    the product of the mesh axes it names), and at least N/2 times smaller
    than whole over N ranks."""
    per, whole, sizes = _rank0_state_bytes("bert-large", mesh)
    world = sizes["data"] * sizes["model"]
    assert 3 * per_device_state_bytes(whole) / per >= world / 2


@pytest.mark.parametrize("mesh", ["data=1,model=2", "data=2,model=2", "data=2,model=4"])
@pytest.mark.parametrize("arch", MODEL_AXIS_ARCHS)
def test_model_axis_per_rank_state_bytes(arch, mesh):
    """Params + μ + ν of rank 0 of each arch's full-width config, whose
    experts, ``inner`` width or MLA heads split over ``model``: what the JAX
    specs give, and at least N/2 times smaller than whole over N ranks."""
    per, whole, sizes = _rank0_state_bytes(arch, mesh)
    assert 3 * per_device_state_bytes(whole) / per >= sizes["data"] * sizes["model"] / 2


def _rank0_state_bytes(arch, mesh):
    """Rank 0's params + μ + ν bytes from meta tensors cut to its block,
    checked against what the JAX specs give (each dimension over the
    product of the mesh axes it names): ``(bytes, whole leaves, sizes)``."""
    sizes = parse_mesh_spec(mesh)
    model = build_model(get_config(arch))
    port_mesh = Mesh(sizes)
    whole = {k: torch.empty(p.shape, device="meta") for k, p in flatten(model.defs).items()}
    rank0 = shard_tree(whole, leaf_dims(specs_for(model.defs, port_mesh), port_mesh), port_mesh)
    per = 3 * per_device_state_bytes(rank0)
    jspecs = _flat_specs(jax_specs_for(jax_build_model(jax_get_config(arch)).defs,
                                       jax_abstract_mesh(tuple(sizes.values()), tuple(sizes))))
    want = 0
    for k, x in whole.items():
        n = x.numel()
        for entry in jspecs[k]:
            for a in (() if entry is None else ((entry,) if isinstance(entry, str) else entry)):
                n //= sizes[a]
        want += 3 * 4 * n
    assert per == want
    return per, whole, sizes


def _fake_tp_ctx(cfg, rank=0, group=None):
    """A context whose ``model`` axis has two ranks and ``group``: a plain
    group of ``collectives.run_plain_ranks``, or a stand-in, enough for what
    raises before any collective runs."""
    mesh = Mesh({"data": 1, "model": 2}, rank=rank,
                groups={("model",): object() if group is None else group})
    return ShardCtx(mesh, param_specs=specs_for(build_model(cfg).defs, mesh))


def test_attention_refuses_split_heads_with_whole_kv_heads_and_a_cache():
    """Heads split over model=2 while a single kv head stays whole run:
    each rank's q heads attend against the whole kv head, and the two
    ranks' partial outputs (a group of one process sums nothing) add up
    to the whole attention, as do their partial kv gradients.  With a KV
    cache (serving on a mesh, which raised before item 11 (e)) each rank's
    cache holds the whole kv head: a prefill of 4 positions and a decode
    step on each rank add up to the whole layer's, and every rank's cache
    equals the whole one."""
    import torch.distributed as dist

    cfg = ModelConfig(**dict(TINY, n_kv_heads=1, activation_dtype="float32"))
    full = {k[len("blocks/attn/"):]: v[0] for k, v in
            build_model(cfg).init(0, torch.device("cpu")).items() if k.startswith("blocks/attn/")}
    x = torch.randn(2, 4, 64)
    pos = torch.arange(4)[None].expand(2, 4)
    dy = torch.randn(2, 4, 64)
    whole = {k: v.clone().requires_grad_() for k, v in full.items()}
    want = attention(whole, x, pos, cfg)
    (want * dy).sum().backward()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        outs, kv_grads = [], []
        for r in range(2):
            half = {k: (v[:, 2 * r:2 * r + 2] if k == "wq" else
                        v[2 * r:2 * r + 2] if k == "wo" else v).clone().requires_grad_()
                    for k, v in full.items()}
            mesh = Mesh({"data": 1, "model": 2}, rank=r, groups={("model",): dist.group.WORLD})
            with use_sharding(ShardCtx(mesh, param_specs=specs_for(build_model(cfg).defs,
                                                                    mesh))):
                out = attention(half, x, pos, cfg)
                (out * dy).sum().backward()
            outs.append(out.detach())
            kv_grads.append((half["wk"].grad, half["wv"].grad))
        x1, pos1 = torch.randn(2, 1, 64), torch.full((2, 1), 4)

        def serve(p, ctx):
            cache = init_kv_cache(2, 8, cfg, torch.float32)
            with torch.no_grad(), use_sharding(ctx):
                return (attention(p, x, pos, cfg, cache=cache),
                        attention(p, x1, pos1, cfg, cache=cache, decode=True), cache)

        whole_serve = serve(full, None)
        served = []
        for r in range(2):
            half = {k: (v[:, 2 * r:2 * r + 2] if k == "wq" else
                        v[2 * r:2 * r + 2] if k == "wo" else v) for k, v in full.items()}
            mesh = Mesh({"data": 1, "model": 2}, rank=r, groups={("model",): dist.group.WORLD})
            served.append(serve(half, ShardCtx(mesh, param_specs=specs_for(
                build_model(cfg).defs, mesh))))
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(outs[0] + outs[1], want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kv_grads[0][0] + kv_grads[1][0], whole["wk"].grad,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kv_grads[0][1] + kv_grads[1][1], whole["wv"].grad,
                               rtol=1e-5, atol=1e-5)
    for i in range(2):   # the prefill and the decode step
        torch.testing.assert_close(served[0][i] + served[1][i], whole_serve[i],
                                   rtol=1e-5, atol=1e-5)
    for k, v in whole_serve[2].items():
        for r in range(2):
            torch.testing.assert_close(served[r][2][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("arch", MODEL_AXIS_ARCHS)
def test_model_apply_over_plain_model_ranks_matches_whole(arch):
    """MoE (expert parallelism), the xLSTM/Mamba ``inner`` axis and MLA
    (with MTP) over model=2, which the launcher refused before: the
    model's own ``apply`` on each rank's blocks under ``_fake_tp_ctx``,
    the two ranks a thread each over a plain group
    (``collectives.run_plain_ranks``), gives the whole model's logits (its
    vocab columns side by side) and aux losses, fp32 activations, within
    the fp32 sums' order (1e-4 of the logits' scale, measured 5.4e-6)."""
    cfg = smoke_config(arch).replace(activation_dtype="float32",
                                     use_mtp=arch.startswith("deepseek"))
    model = build_model(cfg)
    whole = model.init(0, torch.device("cpu"))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator().manual_seed(0))}
    want, aux = model.apply(whole, batch)
    layouts = leaf_dims(specs_for(model.defs, Mesh({"data": 1, "model": 2})),
                        Mesh({"data": 1, "model": 2}))

    def rank(group):
        block = {k: C.shard_leaf(v, layouts[k].model, 2, group.index) for k, v in whole.items()}
        with use_sharding(_fake_tp_ctx(cfg, group.index, group)):
            return model.apply(block, batch)

    got = C.run_plain_ranks(rank, 2)
    logits = torch.cat([out for out, _ in got], -1)
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    for k, v in aux.items():   # the MoE losses, and MTP's hidden states
        tol = dict(rtol=1e-5, atol=1e-6) if v.dim() == 0 else dict(
            rtol=0, atol=1e-4 * float(v.abs().max()))
        for _, rank_aux in got:
            torch.testing.assert_close(rank_aux[k], v, **tol)
