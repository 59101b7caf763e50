"""The port's sharding plan against the JAX package's, in process: specs of
every arch's leaves on the reference's meshes, the mesh-spec parser's
errors, moment placement by path suffix, the collectives against their
plain versions (a gloo group of one), what a mesh still refuses, and what
it now runs under gloo ranks."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.launch.mesh import abstract_mesh as jax_abstract_mesh
from repro.models import build_model as jax_build_model
from repro.sharding import default_act_rules as jax_act_rules
from repro.sharding import default_param_rules as jax_param_rules
from repro.sharding import opt_state_shardings as jax_opt_state_shardings
from repro.sharding import resolve_spec as jax_resolve_spec
from repro.sharding import specs_for as jax_specs_for
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.configs import _ARCHS
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (
    Mesh,
    abstract_mesh,
    make_host_mesh,
    make_mesh_from_spec,
    parse_mesh_spec,
)
from repro_torch.models import build_model
from repro_torch.sharding import (
    ShardCtx,
    batch_axes,
    batch_rows,
    default_act_rules,
    default_param_rules,
    dp_size,
    opt_state_shardings,
    per_device_state_bytes,
    leaf_layout,
    resolve_spec,
    shard_act,
    specs_for,
    use_sharding,
)
from repro_torch.sharding import collectives as C
from repro_torch.train.step import make_train_step

MESHES = ["data=16,model=16", "pod=2,data=16,model=16", "data=8,model=1", "data=4,model=2"]


def _meshes(spec):
    axes = parse_mesh_spec(spec)
    return (abstract_mesh(tuple(axes.values()), tuple(axes)),
            jax_abstract_mesh(tuple(axes.values()), tuple(axes)))


def _flat_specs(tree, prefix=""):
    """A JAX spec tree (nested dicts of PartitionSpecs) as ``{path: tuple}``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(_ARCHS))
def test_specs_for_matches_jax(arch, mesh):
    """Every leaf of every arch's full-width defs gets the reference's spec
    (FSDP over data, TP over model, the drop-trailing-axes fallback)."""
    port, ref = _meshes(mesh)
    got = specs_for(build_model(get_config(arch)).defs, port)
    want = _flat_specs(jax_specs_for(jax_build_model(jax_get_config(arch)).defs, ref))
    assert got == want


@pytest.mark.parametrize("case", [
    ((960, 2560), ("embed", "ff")),
    ((6144, 1, 128), ("embed", "kv_heads", "head_dim")),   # MQA: kv 1 drops model
    ((960, 15, 64), ("embed", "heads", "head_dim")),       # 15 heads drop model
    ((8192, 22528), ("embed", "ff")),
    ((24, 1024, 16, 64), ("layers", "embed", "heads", "head_dim")),
    ((7, 5), ("embed", "ff")),                              # nothing divides
    ((0, 16), ("embed", "ff")),                             # empty dim replicates
])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["param", "act"])
def test_resolve_spec_matches_jax(case, mesh, kind):
    port, ref = _meshes(mesh)
    multi = "pod" in port.shape
    rules, jrules = ((default_param_rules(multi), jax_param_rules(multi)) if kind == "param"
                     else (default_act_rules(multi), jax_act_rules(multi)))
    shape, axes = case
    if kind == "act":
        axes = tuple({"embed": "batch", "layers": "seq"}.get(a, a) for a in axes)
    assert resolve_spec(shape, axes, rules, port) == tuple(
        jax_resolve_spec(shape, axes, jrules, ref))


def test_resolve_spec_never_reuses_a_mesh_axis():
    rules = {"a": ("data",), "b": ("data", "model")}
    port, ref = _meshes("data=16,model=16")
    got = resolve_spec((32, 32), ("a", "b"), rules, port)
    assert got == tuple(jax_resolve_spec((32, 32), ("a", "b"), rules, ref)) == ("data", "model")


def test_parse_mesh_spec():
    assert parse_mesh_spec("data=4,model=2") == {"data": 4, "model": 2}
    assert list(parse_mesh_spec("pod=2, data=8, model=4")) == ["pod", "data", "model"]


@pytest.mark.parametrize("bad", ["data", "data=x", "data=0", "data=2,data=4", "=4"])
def test_parse_mesh_spec_raises_as_jax(bad):
    from repro.launch.mesh import parse_mesh_spec as jax_parse

    with pytest.raises(ValueError) as want:
        jax_parse(bad)
    with pytest.raises(ValueError) as got:
        parse_mesh_spec(bad)
    assert str(got.value) == str(want.value)


def test_mesh_from_spec_needs_the_ranks():
    with pytest.raises(ValueError, match="devices"):
        make_mesh_from_spec("data=64,model=64")
    assert make_mesh_from_spec("data=4,model=2", world_size=8).shape == {"data": 4, "model": 2}


def test_make_host_mesh():
    with pytest.raises(ValueError, match="divisor of"):
        make_host_mesh(3)   # one process: 1 % 3 != 0
    assert make_host_mesh(2, world_size=8).shape == {"data": 4, "model": 2}


def test_mesh_coordinates_are_row_major():
    mesh = Mesh({"pod": 2, "data": 3, "model": 2}, rank=9)
    assert mesh.coords() == {"pod": 1, "data": 1, "model": 1}
    assert mesh.index(("pod", "data")) == 4 and mesh.extent(("pod", "data")) == 6
    assert batch_axes(mesh) == ("pod", "data") and dp_size(mesh) == 6
    assert mesh.abstract


@pytest.mark.parametrize("n,mesh", [(16, "data=4,model=1"), (12, "pod=2,data=3,model=1")])
def test_batch_rows_split_the_global_batch(n, mesh):
    sizes = parse_mesh_spec(mesh)
    world = int(np.prod(list(sizes.values())))
    rows = [batch_rows(n, Mesh(sizes, rank=r)) for r in range(world)]
    assert [start for start, _ in rows] == list(range(0, n, n // world))
    with pytest.raises(ValueError, match="divisible"):
        batch_rows(n + 1, Mesh(sizes))


@pytest.mark.parametrize("spec,want", [
    ((None, "data"), 1), (("data",), 0), ((None, "data", "model"), 1),
    ((), None), ((None, None, "model"), None),
])
def test_shard_dim_on_a_data_only_mesh(spec, want):
    """The data-parallel dimension of a leaf's layout; ``model`` of size 1
    splits nothing."""
    lay = leaf_layout(spec, Mesh({"data": 4, "model": 1}))
    assert (lay.data, lay.model) == (want, None)


def test_shard_dim_refuses_the_model_axis():
    """``model`` splits its own dimension, and any spec ``resolve_spec``
    gives is a layout: one dimension over ``data`` and ``model`` together
    (mixed radix, ``data`` the most significant), over part of the
    data-parallel axes, over an axis besides ``pod``, ``data`` and
    ``model``; an axis of one rank cuts nothing unless it is
    data-parallel."""
    lay = leaf_layout((None, "data", "model"), Mesh({"data": 2, "model": 2}))
    assert (lay.data, lay.model, lay.splits) == (1, 2, ((1, ("data",)), (2, ("model",))))
    both = leaf_layout((("data", "model"),), Mesh({"data": 2, "model": 2}))
    assert (both.data, both.model, both.splits) == (None, None, ((0, ("data", "model")),))
    part = leaf_layout(("data",), Mesh({"pod": 2, "data": 2}))
    assert (part.data, part.splits, part.dp) == (None, ((0, ("data",)),), ("pod", "data"))
    pipe = leaf_layout(("pipe", "model"), Mesh({"data": 1, "model": 1, "pipe": 2}))
    assert pipe.splits == ((0, ("pipe",)),) and pipe.axes == ("pipe",)
    x = torch.arange(8 * 3).reshape(8, 3)
    sizes = {"data": 2, "model": 2}
    for r in range(4):
        mesh = Mesh(sizes, rank=r)
        c = mesh.coords()
        assert torch.equal(C.shard_block(x, both, mesh),
                           x[2 * (2 * c["data"] + c["model"]):][:2])


@pytest.mark.parametrize("shape,rules", [({"pod": 2, "data": 2}, ["embed=data"]),
                                         ({"data": 1, "model": 1, "pipe": 2}, []),
                                         ({"data": 2, "model": 2}, ["embed=data,model"])])
def test_any_layout_and_mesh_axis_train_as_one_process(shape, rules):
    """bert-smoke in fp32 with fused LAMB and the fused CE head, 2 steps over
    plain ranks (threads of this process): ``embed`` stored over ``data``
    alone on a ``pod × data`` mesh (the gradient reduce-scattered over data,
    summed over pod); a ``pipe`` axis beside data and model (each pipe rank
    the same rows, each leaf's norm partial counted on pipe rank 0 alone);
    and ``embed`` over data and model together, the layers computing on
    their heads, ff columns and vocab rows over the graph the ranks'
    plain collectives join.  The losses and the whole params equal the
    single process's within the fp32 sums' order, at the gloo runs' bounds
    (``LOSS_TOL`` 1e-5, ``PARAM_TOL`` 2e-5, tests/test_torch_sharded_train.py;
    measured at most 4.8e-7 in loss and 8.3e-7 in params)."""
    from repro_torch.data import DataPipeline
    from repro_torch.launch.mesh import run_plain_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import default_param_rules, override_rules
    from repro_torch.train import Trainer

    cfg = smoke_config("bert-large").replace(activation_dtype="float32")
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True)
    model = build_model(cfg)

    def fit(mesh=None):
        rules_ = None
        if mesh is not None and rules:
            rules_ = override_rules(default_param_rules(multi_pod="pod" in mesh.shape), rules)
        tr = Trainer(model, tc, device="cpu", log_every=1, log_fn=lambda s: None, mesh=mesh,
                     param_rules=rules_)
        tr.fit(DataPipeline(cfg, 8, 16, device="cpu", seed=0,
                            rows=tr.batch_rows if mesh is not None else None), 2)
        return [h["loss/total"] for h in tr.history], tr.gather_state().params, tr.state.params

    losses, whole, _ = fit()
    outs = run_plain_mesh(fit, shape)
    if "pod" in shape:   # embed over data alone: half the FSDP blocks of pod x data
        assert outs[0][2]["embed"].shape == (whole["embed"].shape[0], 64)
    for got, params, _ in outs:
        np.testing.assert_allclose(got, losses, rtol=0, atol=1e-5)
        for k, x in params.items():
            np.testing.assert_allclose(x.numpy(), whole[k].numpy(), rtol=0, atol=2e-5,
                                       err_msg=k)


@pytest.mark.parametrize("optimizer,fused", [("lamb", True), ("lamb", False),
                                              ("lans", False), ("lars", False)])
@pytest.mark.parametrize("arch", ["bert-large", "hubert-xlarge"])
def test_moment_placement_matches_jax_by_path_suffix(arch, optimizer, fused):
    """Moments mirror their parameter's spec by component-aware path suffix
    (hubert's ``mu/mask_embed`` must not take ``embed``'s), scalars
    replicate: the same spec for every optimizer-state leaf as the JAX
    package gives."""
    port, ref = _meshes("data=4,model=2")
    kw = dict(optimizer=optimizer, use_fused_lamb=fused)
    model = build_model(smoke_config(arch))
    state = make_train_step(model, TrainConfig(**kw))[0](0, torch.device("cpu"))
    got = opt_state_shardings(state.opt_state, specs_for(model.defs, port), port)

    jmodel = jax_build_model(jax_smoke_config(arch))
    jinit, _ = jax_make_train_step(jmodel, JaxTrainConfig(**kw))
    jabs = jax.eval_shape(jinit, jax.random.key(0))
    real = jax.make_mesh((1, 1), ("data", "model"))
    want_tree = jax_opt_state_shardings(jabs.opt_state, jax_specs_for(jmodel.defs, ref), real)
    from repro.common.pytree import tree_leaves_with_paths as jax_leaves

    want = {p: tuple(getattr(s, "spec", s)) for p, s in jax_leaves(want_tree)}
    assert got == want
    assert any(v for v in got.values())


def test_per_device_state_bytes_counts_meta_tensors():
    x = torch.empty((1024, 8), device="meta")
    assert per_device_state_bytes({"a": x, "b": x.to(torch.bfloat16), "n": 3}) == 1024 * 8 * 6


def test_shard_act_is_the_identity_on_a_data_mesh():
    """An annotation, as the reference's: the identity over data and over
    model=2 alike (a layer takes its slice through ``model_parallel``); a
    name list that misses a dimension raises."""
    x = torch.randn(4, 8, 16)
    with use_sharding(ShardCtx(Mesh({"data": 4, "model": 1}))):
        assert shard_act(x, ("batch", "seq", "embed")) is x
    with use_sharding(ShardCtx(Mesh({"data": 2, "model": 2}, rank=3))):
        assert shard_act(x, ("batch", "seq", "ff")) is x
        assert shard_act(x, ("batch", "experts", "embed")) is x
        with pytest.raises(ValueError, match="rank mismatch"):
            shard_act(x, ("batch", "ff"))
    assert shard_act(x, ("batch", "seq", "ff")) is x


# ---------------------------------------------------------------------------
# collectives: plain versions, and the real ones on a gloo group of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("parts", [2, 4])
def test_plain_gather_undoes_the_shard(dim, parts):
    x = torch.randn(8, 4, 12)
    shards = [C.shard_leaf(x, dim, parts, i) for i in range(parts)]
    assert all(s.is_contiguous() for s in shards)
    assert torch.equal(C.gather_leaf_plain(shards, dim), x)
    grads = [torch.randn(8, 4, 12) for _ in range(parts)]
    total = torch.stack(grads).sum(0)
    assert torch.equal(C.gather_leaf_plain(C.scatter_grad_plain(grads, dim), dim), total)


@pytest.fixture
def group_of_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collectives_over_one_rank_equal_their_plain_version(group_of_one):
    x = torch.randn(6, 4, 3)
    for dim in (None, 0, 1, 2):
        for t in (x, x.to(torch.bfloat16)):
            assert torch.equal(C.gather_leaf(t, dim, group_of_one), C.gather_leaf_plain([t], dim))
        assert torch.equal(C.scatter_grad(x.clone(), dim, group_of_one),
                           C.scatter_grad_plain([x], dim)[0] if dim is not None else x)
    for op in C.OPS:
        assert torch.equal(C.all_reduce(x.clone(), op, group_of_one), C.all_reduce_plain([x], op))


# ---------------------------------------------------------------------------
# the launcher over a mesh
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--smoke", "--batch", "4", "--seq", "16", "--steps", "2", "--device", "cpu"]

# what the launcher refused before: each now runs under gloo ranks
MESH_RUNS = {
    # smollm-smoke: 3 heads split over model=3, its one kv head stays whole
    "smollm-model3": (["--arch", "smollm-360m", "--mesh", "data=1,model=3"], 3),
    "granite-moe-data2": (["--arch", "granite-moe-1b-a400m", "--mesh", "data=2,model=1",
                           "--accum-steps", "2"], 2),
    "bert-rollback-data2": (["--arch", "bert-large", "--mesh", "data=2,model=1",
                             "--rollback-on-spike", "--checkpoint-dir", "ck",
                             "--checkpoint-every", "1"], 2),
    "bert-preempt-data2": (["--arch", "bert-large", "--mesh", "data=2,model=1",
                            "--preempt-grace", "5", "--checkpoint-dir", "ck",
                            "--checkpoint-every", "1"], 2),
    # expert parallelism, the xLSTM/Mamba inner axis and MLA heads over model
    "granite-moe-model2": (["--arch", "granite-moe-1b-a400m", "--mesh", "data=1,model=2"], 2),
    "xlstm-model2": (["--arch", "xlstm-350m", "--mesh", "data=1,model=2"], 2),
    "granite-moe-data2-model2": (["--arch", "granite-moe-1b-a400m", "--mesh",
                                  "data=2,model=2"], 4),
    "deepseek-model2": (["--arch", "deepseek-v3-671b", "--mesh", "data=1,model=2"], 2),
    "jamba-model2": (["--arch", "jamba-1.5-large-398b", "--mesh", "data=1,model=2"], 2),
}
# jamba-smoke in bf16: its gradient is itself 11% from the fp32 one in norm
# (the ranks' within 0.6% of the one process's), and LAMB's second step
# magnifies that: the second loss at 3e-2 (measured 1.37e-2)
STEP2_ATOL = {"jamba-model2": 3e-2}


def _printed_losses(out: str):
    return [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]


@pytest.mark.parametrize("case", list(MESH_RUNS))
def test_launcher_runs_what_a_mesh_now_runs(tmp_path, case):
    """Under ``torch.distributed.run`` on 2-4 gloo ranks, with a single
    process of the same flags beside it: every rank exits 0, rank 0 alone
    prints, the first step's loss (same weights, same rows) within a
    printed unit of the single process's and the second within the JAX
    suite's sharded bound 1e-2 (bf16 activations round the ranks' products
    in other places; ``STEP2_ATOL`` where stated)."""
    argv, world = MESH_RUNS[case]
    i = argv.index("--mesh")
    common = ["-m", "repro_torch.launch.train", *SMOKE, "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(world), *common, *argv]
    single = [sys.executable, *common, *argv[:i], *argv[i + 2:]]
    outs = []
    for cmd, where in ((run, "mesh"), (single, "one")):
        (tmp_path / where).mkdir()
        outs.append(subprocess.Popen(cmd, cwd=str(tmp_path / where), env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True))
    printed = []
    for p in outs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err[-4000:]
        printed.append(out)
    sharded, one = printed
    assert sharded.count("done: step=2 ") == 1 and "status=ok" in sharded, sharded
    losses, want = _printed_losses(sharded), _printed_losses(one)
    assert len(losses) == len(want) == 2, (sharded, one)
    np.testing.assert_allclose(losses[:1], want[:1], atol=1.5e-4)
    np.testing.assert_allclose(losses, want, atol=STEP2_ATOL.get(case, 1e-2))


def test_launcher_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        launch_train.main(["--arch", "bert-large", "--mesh", "data=2,model=1"] + SMOKE)
