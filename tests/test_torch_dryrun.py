"""The dry-run and the roofline of the port (``launch/dryrun.py``,
``launch/roofline.py``, ``kernels/cost.py``), held to the JAX package on
the CPU: the plan and its notes, the dry-run's inputs, abstract caches,
parameter counts and per-device state bytes on the production meshes, the
collective byte rule, the roofline's arithmetic; the meta trace against
real CPU runs (a step's flops, a tensor-parallel forward's collectives);
the twin of ``tests/test_sharding.py``'s production dry-run; the serving
records' skips (the records themselves, ``ok`` on both meshes, are
``tests/test_torch_dryrun_serving_1pod.py`` and ``…_2pod.py``, through
:func:`check_serving_record`); the kernels' meta routes; and PERF.md's
bound column from ``kernels/cost.py``.

No JAX compile runs here: the JAX side is its plan, its definitions, its
specs and its HLO byte rule.  Budget: about 45 s on one worker; the
traces of the other ``train_4k`` records take up to a few minutes under
the suite's load and run outside it (``CHANGES.md`` lists their times).
"""
import dataclasses
import importlib
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_threads import one_cpu_thread  # noqa: F401
import repro.configs as jax_configs
from repro import nn as jax_nn
from repro.launch import mesh as jax_mesh
from repro.launch import roofline as jax_roofline
from repro.models import build_model as jax_build_model
from repro.sharding import axes as jax_axes
from repro_torch.checkpoint.io import tree_leaves_with_paths
from repro_torch.configs import ARCHS, SHAPES, full_plan, get_config, plan, smoke_config
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import LAUNCHES, cost
from repro_torch.kernels.flash_attention import FlashSpec, flash_attention_fwd, flash_dkv, \
    flash_dq
from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd
from repro_torch.kernels.lamb_update import lamb_apply, lamb_moments
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, abstract_mesh, counting_mesh, make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.sharding import ShardCtx, leaf_layout, specs_for, use_sharding
from repro_torch.sharding import collectives as C
from repro_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1pod": False, "2pod": True}
DECODERS = [a for a in ARCHS if not get_config(a).is_encoder]


def _cfg_dict(cfg):
    return None if cfg is None else dataclasses.asdict(cfg)


def test_plan_and_full_plan_equal_the_reference():
    ours, ref = full_plan(), jax_configs.full_plan()
    assert list(ours) == list(ref)
    for key, (cfg, note) in ours.items():
        assert note == ref[key][1], key
        assert _cfg_dict(cfg) == _cfg_dict(ref[key][0]), key
    for sname, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jax_configs.get_shape(sname))
        ref_bert = jax_configs.get_config("bert-large")
        assert plan(get_config("bert-large"), shape)[1] == \
            jax_configs.plan(ref_bert, jax_configs.get_shape(sname))[1]


@pytest.mark.parametrize("arch", ARCHS + ["bert-large"])
def test_input_specs_equal_the_reference(arch):
    model, ref = build_model(get_config(arch)), jax_build_model(jax_configs.get_config(arch))
    for sname, shape in SHAPES.items():
        ours = model.input_specs(shape)
        want = ref.input_specs(jax_configs.get_shape(sname))
        assert all(v.device.type == "meta" for v in ours.values())
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in ours.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, sname


@pytest.mark.parametrize("arch", DECODERS)
def test_abstract_caches_equal_the_reference(arch):
    model, ref = build_model(get_config(arch)), jax_build_model(jax_configs.get_config(arch))
    shape = SHAPES["decode_32k"]
    ours = model.make_cache(shape.global_batch, shape.seq_len, "meta")
    want = ref.make_cache(shape.global_batch, shape.seq_len, abstract=True)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    want_leaves = {"/".join(str(getattr(k, "key", k)) for k in path):
                   (tuple(v.shape), str(v.dtype)) for path, v in flat_want}
    assert {p: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for p, v in tree_leaves_with_paths(ours)} == want_leaves


@pytest.mark.parametrize("arch", ARCHS + ["bert-large"])
def test_param_counts_equal_the_reference(arch):
    model, ref = build_model(get_config(arch)), jax_build_model(jax_configs.get_config(arch))
    assert model.param_count() == ref.param_count()
    assert model.active_param_count() == ref.active_param_count()
    params = model.abstract_params()
    assert all(v.device.type == "meta" for v in params.values())


def _reference_state_bytes(arch: str, multi_pod: bool, overrides=()) -> int:
    """Σ over the reference's leaves of their shard under its resolve_spec on
    the production mesh (its default param rules with ``overrides``, the
    dry-run's ``--param-rule name=a,b``): params in param_dtype and LAMB's
    two fp32 moments."""
    cfg = jax_configs.get_config(arch)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = jax_mesh.abstract_mesh(shape, names)
    sizes = dict(zip(names, shape))
    rules = jax_axes.default_param_rules(multi_pod=multi_pod)
    for item in overrides:
        k, _, v = item.partition("=")
        rules[k] = tuple(x for x in v.split(",") if x) or None
    itemsize = np.dtype(jax.numpy.dtype(cfg.param_dtype)).itemsize
    total = 0
    for p in jax.tree.leaves(jax_build_model(cfg).defs, is_leaf=jax_nn.is_param):
        spec = tuple(jax_axes.resolve_spec(p.shape, p.axes, rules, mesh))
        n = 1
        for i, dim in enumerate(p.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            split = 1
            for a in axes:
                split *= sizes[a]
            n *= dim // split
        total += n * (itemsize + 2 * 4)
    return total


def _state_bytes(arch: str, mesh_name: str, overrides=()) -> int:
    """Rank 0's params and LAMB moments in the dry-run's train step on the
    production mesh, under the ``--param-rule`` ``overrides``."""
    mesh = counting_mesh(make_production_mesh(multi_pod=MESHES[mesh_name]), C.CollectiveTally())
    rules, param_rules = dryrun.dryrun_rules(mesh, param_rule_sets=overrides)
    _, (state, _), _ = dryrun.build_train(build_model(get_config(arch)), SHAPES["train_4k"],
                                          mesh, rules, "lamb", param_rules)
    assert all(x.device.type == "meta" for _, x in tree_leaves_with_paths(state))
    ours = sum(x.numel() * x.element_size() for p, x in tree_leaves_with_paths(state.params))
    return ours + sum(x.numel() * x.element_size()
                      for p, x in tree_leaves_with_paths(state.opt_state)
                      if "/mu/" in f"/{p}" or "/nu/" in f"/{p}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_state_bytes_equal_the_reference_shards(arch, mesh_name):
    assert _state_bytes(arch, mesh_name) == _reference_state_bytes(arch, MESHES[mesh_name])


# the dry-run's --param-rule the meta tests store the state under: embed
# over data and model together
EMBED_DATA_MODEL = ("embed=data,model",)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["bert-large", "granite-moe-1b-a400m"])
def test_per_device_state_bytes_under_a_param_rule_equal_the_reference_shards(arch,
                                                                               mesh_name):
    """Under ``--param-rule embed=data,model`` as under the default rules:
    the bytes of the reference's shards (granite-moe's experts keep
    ``model``, so its ``embed`` drops it there, as ``resolve_spec`` does)."""
    ours = _state_bytes(arch, mesh_name, EMBED_DATA_MODEL)
    assert ours == _reference_state_bytes(arch, MESHES[mesh_name], EMBED_DATA_MODEL)
    assert ours != _reference_state_bytes(arch, MESHES[mesh_name])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,sname", [("bert-large", "train_4k"),
                                        ("smollm-360m", "decode_32k")])
def test_param_rule_records_are_ok(arch, sname, mesh_name):
    """The dry-run under ``--param-rule embed=data,model``: the state is
    stored as the rule says and taken to the layers' layout to compute, so
    a train step's and a decode's records are ``ok``.  On the one-pod mesh
    BERT-large's leaves are gathered over the group of both axes (its rank
    order the rule's block order): megabytes, where the default layout
    moves only the norms' partials over that group (1,316 bytes)."""
    rec = dryrun.run_dryrun(arch, sname, multi_pod=MESHES[mesh_name],
                            param_rule_sets=list(EMBED_DATA_MODEL))
    assert rec["status"] == "ok", rec.get("note")
    assert rec["param_rules"] == list(EMBED_DATA_MODEL) and rec["roofline"]["memory_s"] > 0
    if arch == "bert-large" and mesh_name == "1pod":
        assert rec["collectives"]["data,model"]["bytes"] > 2 ** 20, rec["collectives"]


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("kind", C.KINDS)
def test_collective_byte_rule_equals_the_reference(kind, group):
    result = (group * 8, 1024)
    line = (f"  %x = f32[{result[0]},{result[1]}]{{1,0}} {kind}(f32[8,1024]{{1,0}} %p), "
            f"replica_groups=[{256 // group},{group}]<=[256]")
    want = jax_roofline.collective_bytes(line)
    assert want["count"] == 1
    assert C.operand_bytes(kind, result[0] * result[1] * 4, group) == want[kind]
    tally = C.CollectiveTally()
    C.CountingGroup(("data",), group, tally).record(kind, torch.empty(result, device="meta"))
    assert roofline.collective_bytes(tally) == {**want, "total": want[kind]}


def test_counting_group_collectives_and_host_flags():
    tally = C.CollectiveTally()
    g = C.CountingGroup(("pod", "data"), 4, tally)
    x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    assert C.gather_leaf(x, 1, g).shape == (8, 24)
    assert C.scatter_grad(torch.empty((8, 24), device="meta"), 1, g).shape == (8, 6)
    assert C.all_reduce(x, "max", g) is x
    assert tally.by_kind["all-gather"] == 8 * 6 * 2
    assert tally.by_kind["reduce-scatter"] == 8 * 24 * 4
    assert tally.by_kind["all-reduce"] == 8 * 6 * 2
    assert tally.by_axis == {"pod,data": {"bytes": 96 + 768 + 96, "count": 3}}
    for flag in (lambda: C.agree_any(1, g), lambda: C.broadcast_int(1, g),
                 lambda: C.barrier(g)):
        with pytest.raises(ValueError, match="counting group"):
            flag()


def test_roofline_terms_math_with_the_h100_figures():
    cost_ = {"flops": roofline.PEAK_FLOPS, "bytes accessed": roofline.HBM_BW / 2}
    rf = roofline.analyze(cost_, None, model_flops_per_device=roofline.PEAK_FLOPS / 2)
    assert rf.compute_s == pytest.approx(1.0)
    assert rf.memory_s == pytest.approx(0.5)
    assert rf.dominant == "compute"
    assert rf.useful_fraction == pytest.approx(0.5)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    # flops split by type: each at its own peak (fp32 outside the tensor cores)
    cost_["flops_by_rate"] = {"bfloat16": roofline.PEAK_FLOPS,
                              "float32": roofline.PEAK_OPS["float32"] / 4}
    rf = roofline.analyze(cost_, None, model_flops_per_device=0.0)
    assert rf.compute_s == pytest.approx(1.25)
    assert roofline.PEAK_OPS["float32"] == 67e12
    assert roofline.memory_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    tally = C.CollectiveTally()
    tally.add("all-reduce", int(roofline.NIC_BW), ("data",))
    tally.add("all-gather", int(roofline.NVLINK_BW), ("model",))
    assert roofline.collective_seconds(tally, {"data": 16, "model": 8}) == pytest.approx(2.0)
    assert roofline.collective_seconds(tally, {"data": 16, "model": 16}) == pytest.approx(
        1.0 + roofline.NVLINK_BW / roofline.NIC_BW)
    # no TPU v5e figure anywhere in the port
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"197e12|819e9|v5e", text), path


def test_meta_trace_flops_equal_a_real_cpu_step():
    cfg = smoke_config("bert-large").replace(use_flash_kernel=False, use_fused_ce_head=False)
    model = build_model(cfg)
    shape = InputShape("smoke", seq_len=16, global_batch=4, kind="train")
    rec = dryrun.trace(model, shape, abstract_mesh((1,), ("data",)))
    assert rec["kernels"] == {}
    init_fn, step_fn = make_train_step(model, TrainConfig(optimizer="lamb", learning_rate=1e-3))
    state = init_fn(0, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, np.random.default_rng(0), 4, 16).items()}
    with FlopCounterMode(display=False) as flops:
        step_fn(state, batch)
    assert rec["cost"]["flops"] == flops.get_total_flops() > 0
    assert sum(rec["cost"]["flops_by_rate"].values()) == rec["cost"]["flops"]
    assert rec["memory"]["argument_size_in_bytes"] == sum(
        x.numel() * x.element_size() for _, x in tree_leaves_with_paths((state, batch)))


def test_tensor_parallel_forward_collectives_equal_the_meta_trace():
    cfg = smoke_config("granite-moe-1b-a400m")
    model = build_model(cfg)
    sizes = {"data": 1, "model": 2}
    specs = specs_for(model.defs, Mesh(sizes))
    layouts = {k: leaf_layout(s, Mesh(sizes)) for k, s in specs.items()}
    params = model.init(0, torch.device("cpu"))
    tokens = torch.from_numpy(make_batch(cfg, np.random.default_rng(0), 2, 8)["tokens"])

    def rank(group):
        mesh = Mesh(sizes, rank=group.index, groups={("model",): group})
        block = {k: C.shard_block(v, layouts[k], mesh) for k, v in params.items()}
        with torch.no_grad(), use_sharding(ShardCtx(mesh, param_specs=specs)):
            return model.apply(block, {"tokens": tokens})[0]

    plain = C.CollectiveTally()
    C.run_plain_ranks(rank, 2, tally=plain)
    meta = C.CollectiveTally()
    cmesh = counting_mesh(Mesh(sizes), meta)
    block = {k: C.shard_block(v, layouts[k], cmesh) for k, v in model.abstract_params().items()}
    with torch.no_grad(), use_sharding(ShardCtx(cmesh, param_specs=specs)):
        model.apply(block, {"tokens": torch.empty(tokens.shape, dtype=torch.int32,
                                                  device="meta")})
    assert plain.count > 0 and plain.by_kind["all-gather"] > 0
    assert (plain.by_kind, plain.count, plain.by_axis) == (meta.by_kind, meta.count,
                                                          meta.by_axis)


def test_production_dryrun_decode_record(tmp_path):
    """The twin of tests/test_sharding.py's production dry-run: smollm-360m
    decode_32k on the 256-rank mesh, through the launcher's main."""
    env = dict(os.environ)
    importlib.reload(dryrun)
    assert dict(os.environ) == env   # importing the dry-run sets no variable
    out = tmp_path / "dry.jsonl"
    rec = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--out", str(out),
                       "--tag", "unit"])
    assert out.read_text().count("\n") == 1
    assert rec["status"] == "ok" and rec["devices"] == 256 and rec["cost_source"] == "meta"
    assert rec["roofline"]["memory_s"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    # the cache's bytes are rank 0's block: 8 of 128 rows, every position
    cfg = get_config("smollm-360m")
    cache = 2 * cfg.n_layers * 8 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    assert cache < rec["memory"]["argument_size_in_bytes"] < cache * 1.01


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_a_train_record_is_ok(mesh_name):
    """A train step is never ``unported``: smollm-360m train_4k at full
    width traces whole on both production meshes, and its fp32 flops (the
    chain LAMB's, the fp32 masters') meet fp32's peak."""
    rec = dryrun.run_dryrun("smollm-360m", "train_4k", multi_pod=MESHES[mesh_name])
    assert rec["status"] == "ok", rec.get("note")
    assert rec["devices"] == (512 if MESHES[mesh_name] else 256)
    by_rate = rec["cost"]["flops_by_rate"]
    assert by_rate["float32"] > 0 and by_rate["bfloat16"] > 0
    assert sum(by_rate.values()) == rec["cost"]["flops"]
    assert rec["roofline"]["compute_s"] == pytest.approx(
        by_rate["bfloat16"] / 989e12 + by_rate["float32"] / 67e12)


def test_only_item_11e_refusals_make_a_record_unported(monkeypatch):
    """An aten op with no meta kernel raises ``NotImplementedError``: such a
    record fails; no record is filed ``unported`` any more (every layer
    serves on a mesh, item 11 (e))."""
    def no_meta_kernel(*args, **kwargs):
        raise NotImplementedError("Could not run 'aten::_example' with arguments from the "
                                  "'Meta' backend.")

    monkeypatch.setattr(dryrun, "trace", no_meta_kernel)
    with pytest.raises(NotImplementedError, match="Meta"):
        dryrun.run_dryrun("smollm-360m", "decode_32k")
    assert not hasattr(dryrun, "UNPORTED")


def check_serving_record(arch: str, sname: str, multi_pod: bool) -> str:
    """The dry-run's record of (arch, shape) on a production mesh: ``ok``
    or the reference's skip with its note.  Returns the status."""
    _, note = full_plan()[(arch, sname)]
    rec = dryrun.run_dryrun(arch, sname, multi_pod=multi_pod)
    assert rec["status"] in ("ok", "skipped"), rec
    if rec["status"] == "skipped":
        assert rec["note"] == note and note.startswith("skip:")
    else:
        assert rec["devices"] == (512 if multi_pod else 256)
        assert rec["roofline"]["memory_s"] > 0
    return rec["status"]


@pytest.mark.parametrize("kind,batch", [("prefill", 32), ("train", 256)])
def test_loop_count_equals_the_unrolled_trace(kind, batch):
    """A loop over time counted from three of its steps
    (``dryrun.LoopCounter``) against the same loop unrolled, on
    xlstm-350m's widths cut to one (mLSTM, sLSTM) pair at 64 positions on
    the one-pod mesh: a prefill (no gradient; the mLSTM's roll, whose
    outputs are dropped, and the sLSTM's) and a train step (the sLSTM's
    loop with its backward).  Flops, flops by rate, bytes accessed, kernel
    tallies and collectives are equal; so is every memory figure
    (measured: the peak to the byte; the bound is 1%)."""
    model = build_model(get_config("xlstm-350m").replace(n_layers=2))
    shape = InputShape("loops", seq_len=64, global_batch=batch, kind=kind)
    mesh = make_production_mesh()
    counted, unrolled = (dryrun.trace(model, shape, mesh, loops=loops) for loops in (True, False))
    for key in ("cost", "kernels", "collectives"):
        assert counted[key] == unrolled[key], key
    assert counted["cost"]["flops"] > 0 and counted["cost"]["bytes accessed"] > 0
    assert counted["collectives"]
    peak = unrolled["memory"].pop("peak_memory_in_bytes")
    assert counted["memory"].pop("peak_memory_in_bytes") == pytest.approx(peak, rel=0.01)
    assert {k: v for k, v in counted["memory"].items() if k != "temp_size_in_bytes"} == {
        k: v for k, v in unrolled["memory"].items() if k != "temp_size_in_bytes"}


def test_xlstm_train_record_is_ok():
    """xlstm-350m's ``train_4k`` record at 4096 positions on the one-pod
    mesh: its sLSTM loops counted from three steps each (about 5 s, where
    the unrolled trace took half an hour)."""
    rec = dryrun.run_dryrun("xlstm-350m", "train_4k")
    assert rec["status"] == "ok", rec.get("note")
    assert rec["tokens"] == 256 * 4096 and rec["trace_s"] < 60
    assert rec["memory"]["peak_memory_in_bytes"] > rec["memory"]["argument_size_in_bytes"] > 0
    assert sum(rec["cost"]["flops_by_rate"].values()) == rec["cost"]["flops"] > 0


SERVING_RECORDS = [(arch, sname) for (arch, sname) in full_plan()
                   if SHAPES[sname].kind != "train"]


def test_serving_records_are_ok_skipped_or_the_roadmaps_unported():
    """Every serving record of ``full_plan()`` on both meshes is ``ok`` or
    the reference's skip; nothing is ``unported`` any more.  The 56 records
    to trace are tests of their own, a record each, in
    ``tests/test_torch_dryrun_serving_1pod.py`` and ``…_2pod.py`` (about
    140 s a mesh under the suite's load: two files, so that ``--dist
    loadfile`` runs them beside this one); here the four skips
    (hubert-xlarge's decode shapes) come back skipped with the reference's
    note on both meshes."""
    skips = [(arch, sname) for arch, sname in SERVING_RECORDS
             if full_plan()[(arch, sname)][0] is None]
    assert len(SERVING_RECORDS) == 30
    assert skips == [("hubert-xlarge", "decode_32k"), ("hubert-xlarge", "long_500k")]
    for multi_pod in MESHES.values():
        for arch, sname in skips:
            assert check_serving_record(arch, sname, multi_pod) == "skipped"


def _kernel_calls(device, dtype=torch.bfloat16):
    """K1–K8 once each on ``device``, at small shapes; their outputs."""
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dt=dtype):
        x = torch.randn(shape, generator=gen).to(dt)
        return x.to(device)

    x, g = rand(3, 40, dt=torch.float32), rand(3, 40, dt=torch.float32)
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    c = torch.tensor([1.1, 1.2], device=device)
    outs = list(lamb_moments(x, g, m, v, c, 3))
    outs.append(lamb_apply(x, m, v, c, torch.full((3,), 1e-3, device=device), 3))
    q, do = rand(2, 4, 24, 64), rand(2, 4, 24, 64)
    k, vv = rand(2, 2, 24, 64), rand(2, 2, 24, 64)
    spec = FlashSpec(0.125, True, 0, False)
    o, lse = flash_attention_fwd(q, k, vv, None, spec)
    di = torch.zeros_like(lse)
    outs += [o, lse, flash_dq(q, k, vv, None, lse, di, do, spec),
             *flash_dkv(q, k, vv, None, lse, di, do, spec)]
    h, w = rand(10, 32), rand(50, 32)
    lbl = torch.randint(0, 50, (10,), generator=gen, dtype=torch.int32).to(device)
    nll, correct, lse = fused_ce_fwd(h, w, lbl)
    gg = torch.ones(10, device=device)
    outs += [nll, correct, lse, fused_ce_dh(h, w, lbl, lse, gg), fused_ce_dw(h, w, lbl, lse, gg)]
    return outs


def test_meta_routes_allocate_as_the_kernels_and_count_their_work():
    before = dict(LAUNCHES)
    tally = {}
    with cost.counting(tally):
        cpu = _kernel_calls("cpu")
        assert tally == {}   # CPU tensors take the plain route, counted nowhere
        meta = _kernel_calls("meta")
    assert dict(LAUNCHES) == before   # nothing launched
    assert [(tuple(a.shape), a.dtype) for a in meta] == [(tuple(a.shape), a.dtype) for a in cpu]
    assert all(a.device.type == "meta" for a in meta)
    bf16 = torch.bfloat16
    want = {
        "lamb_moments": cost.lamb_moments(120, 3), "lamb_apply": cost.lamb_apply(120, 3),
        "flash_fwd": cost.flash_fwd(2, 4, 2, 24, 24, 64, bf16, True),
        "flash_dq": cost.flash_dq(2, 4, 2, 24, 24, 64, bf16, True),
        "flash_dkv": cost.flash_dkv(2, 4, 2, 24, 24, 64, bf16, True),
        "fused_ce_fwd": cost.fused_ce_fwd(10, 32, 50, bf16),
        "fused_ce_dh": cost.fused_ce_dh(10, 32, 50, bf16),
        "fused_ce_dw": cost.fused_ce_dw(10, 32, 50, bf16),
    }
    assert tally == {k: {"launches": 1, "bytes": w.bytes, "operations": w.operations}
                     for k, w in want.items()}


def _bert_lamb_work():
    model = build_model(get_config("bert-large"))
    axes = model.layer_axes()
    moments, apply = [], []
    for k, p in model.abstract_params().items():
        layers = p.shape[0] if axes[k] == 0 else 1
        moments.append(cost.lamb_moments(p.numel(), layers))
        apply.append(cost.lamb_apply(p.numel(), layers))
    return model.param_count(), cost.total(moments), cost.total(apply)


def test_cost_reproduces_perf_bound_column():
    """PERF.md's kernel table, to its printed digits."""
    def ms(work):
        return roofline.bound(work)[0] * 1e3

    n, k1, k2 = _bert_lamb_work()
    assert n == 333_344_768
    assert (f"{ms(k1):.3f}", f"{ms(k2):.3f}") == ("2.388", "1.592")
    bf16 = torch.bfloat16
    flash = [ms(getattr(cost, f)(32, 16, 16, 128, 128, 64, bf16))
             for f in ("flash_fwd", "flash_dq", "flash_dkv")]
    assert [f"{t:.4f}" for t in flash] == ["0.0101", "0.0127", "0.0152"]
    ce = [ms(getattr(cost, f)(640, 1024, 30522, bf16))
          for f in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")]
    assert [f"{t:.4f}" for t in ce] == ["0.0405", "0.0809", "0.0809"]
    assert [f"{ms(getattr(cost, f)(1024, 7168, 129280, bf16)):.3f}"
            for f in ("fused_ce_dh", "fused_ce_dw")] == ["3.838", "3.838"]
    assert roofline.bound(cost.flash_fwd(32, 16, 16, 128, 128, 64, bf16))[1] == "bytes"
    assert roofline.bound(cost.fused_ce_dh(640, 1024, 30522, bf16))[1] == "operations"
    # causal attention counts the (row, key) pairs its mask keeps
    assert cost.attention_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert cost.attention_pairs(128, 128, True) == 128 * 129 // 2
    assert cost.attention_pairs(2, 6, True) == 5 + 6   # rows offset by T − S
