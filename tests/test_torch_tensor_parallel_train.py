"""Tensor-parallel training of the port on real ranks over gloo: the dense
runs over ``--mesh data=2,model=2`` (world 4) and ``data=1,model=2``
(world 2), held to the port's single process and to the JAX package's
single-device Trainer on the same weights.

The ranks run in subprocesses (tests/_torch_sharded_harness.py, the
``tp_*`` scenarios); the module-scoped fixture runs world 4 while the JAX
package trains, then world 2, then the world-4 checkpoint restored on
``data=2,model=1`` over two ranks.

Heads, kv heads, ff and vocab split over ``model``.  Every product runs in
the activations' dtype as on one device; where the ranks split a
contraction each keeps an fp32 partial and the sum is rounded once
(models/layers/tensor_parallel.py), so only the order of fp32 sums
differs from one device.  Each run is held to the single process on the
data-parallel ranks' micro-batches (``same_blocks``) and on its own
(``same_config``, the data-only runs' bound: the JAX suite's sharded one,
``JAX_PARAM_TOL`` 2e-2 and ``JAX_LOSS_TOL`` 1e-2).  On ``same_blocks``:

* ``*_f32``, the JAX suite's TP runs with fp32 activations, at the
  data-only runs' tight bounds of tests/test_torch_sharded_train.py
  (``LOSS_TOL`` 1e-5, ``NORM_RTOL`` 1e-4 on every step's norms and every
  layer's applied trust ratio and norms, ``PARAM_TOL`` 2e-5 on the
  params; measured: at most 2.6e-6).  Two twins magnify the order of the
  sums past ``PARAM_TOL`` and hold their params to a few times what they
  show (``F32_PARAM_TOL``; measured 2.9e-5 and 1.2e-4): LANS divides the
  layer-normalised gradient by sqrt(v) + eps, so an element that cancels
  to below eps times its layer's norm moves its update by noise / eps, and
  accum2+bf16's bf16 compute copy rounds each gradient to bf16.  They are
  held to the JAX package's Trainer with fp32 activations at a few times
  what they show (``JAX_F32_*``; measured: 1.7e-5 in loss, 8.8e-6 in
  params, LANS 1.1e-4 and accum2 4.0e-4);
* the runs themselves, in bf16 activations: a bf16 rounding that the order
  of the fp32 sums moves is magnified by LAMB's later steps (an element
  near zero takes a full-size update from its sign), so the first step is
  held tightly, its loss at ``LOSS_TOL`` and its grad norm and every
  layer's applied trust ratio and norms at ``BF16_STEP1_RTOL`` (measured:
  0 in loss, 2.6e-5 in grad norm, 1.2e-4 in the records), and the whole
  run at the sharded bound, also against the JAX package.  A dropped
  input-gradient sum of the column products moves the first step's grad
  norm by 42% and more.
"""
import json
import os

import numpy as np
import pytest

from _torch_threads import one_cpu_thread  # noqa: F401
from test_torch_tensor_parallel import _flat_specs
from repro.launch.mesh import abstract_mesh as jax_abstract_mesh
from repro.models import build_model as jax_build_model
from test_torch_sharded_train import (
    JAX_LOSS_TOL,
    JAX_PARAM_TOL,
    LOSS_TOL,
    NORM_RTOL,
    PARAM_TOL,
    RUNS,
    STEPS,
    _harness,
    _jax_cfg,
    _jax_references,
    _jax_trainers,
    _report,
)

MESHES = {4: "data=2,model=2", 2: "data=1,model=2"}
BF16_STEP1_RTOL = 5e-4   # the first step's grad norm and records, bf16 activations
F32_PARAM_TOL = {"lans_fp32_f32": 1e-4, "equiv_accum2_bf16_f32": 5e-4}   # else PARAM_TOL
JAX_F32_LOSS_TOL = 5e-5
JAX_F32_PARAM_TOL = {"lans_fp32_f32": 5e-4, "equiv_accum2_bf16_f32": 2e-3}   # else 5e-5
TP_RUNS = {   # the harness's tp variant: the JAX suite's (scenario, variant)
    "equiv_fused": ("equiv", "fused"),
    "equiv_accum2_bf16": ("equiv", "accum2_bf16"),
    "lans_fp32": ("lans", "fp32"),
    "mlm_fused_ce": ("mlm_flash", "fused_ce"),
    "mlm_dense_head": ("mlm_flash", "dense_head"),
}
VARIANTS = list(TP_RUNS) + [f"{k}_f32" for k in TP_RUNS]
SCENARIOS = ("tp_collectives", "tp_equiv", "tp_planted", "nan_skip", "checkpoint")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    init = root / "init"
    init.mkdir()
    jax_runs = {k: RUNS[v] for k, v in TP_RUNS.items()}
    jax_runs.update({f"{k}_f32": (_jax_cfg(cfg).replace(activation_dtype="float32"), kw)
                     for k, (cfg, kw) in list(jax_runs.items())})
    trainers = _jax_trainers(str(init), jax_runs)
    dirs = {w: root / f"w{w}" for w in MESHES}
    proc4 = _harness(4, dirs[4], "--init", str(init), "--mesh", MESHES[4], *SCENARIOS,
                     "tp_layout")
    jax_refs = _jax_references(trainers)
    reports = {4: _report(proc4, dirs[4])}
    reports[2] = _report(_harness(2, dirs[2], "--init", str(init), "--mesh", MESHES[2],
                                  *SCENARIOS[:-1]), dirs[2])
    restore = root / "restore"
    restored = _report(_harness(2, restore, "--mesh", MESHES[2], "--restore", str(dirs[4]),
                                "--restore-mesh", "data=2,model=1", "checkpoint"), restore)
    return {"reports": reports, "dirs": dirs, "jax": jax_refs, "restored": restored}


def test_harness_ran_both_meshes(runs):
    assert {w: r["mesh"] for w, r in runs["reports"].items()} == {
        4: {"data": 2, "model": 2}, 2: {"data": 1, "model": 2}}
    assert runs["restored"]["checkpoint"]["mesh"] == {"data": 2, "model": 1}


@pytest.mark.parametrize("world", MESHES)
def test_model_axis_operators_match_their_plain_versions(runs, world):
    """copy_to_model and reduce_from_model on real ranks, forward and
    backward, against their plain versions over every rank's operands
    (fp32 sums within rounding: the plain sum may add in another order),
    and every leaf of TINY cut into blocks and gathered whole."""
    checks = runs["reports"][world]["tp_collectives"]
    assert len(checks) == 10 and checks["gather_block"] and checks["split_both"] > 0, checks
    for name, value in checks.items():
        if name.startswith(("copy_fwd", "reduce_bwd")):
            assert value is True, name
        elif name.startswith(("copy_bwd", "reduce_fwd")):
            assert value < 1e-5 if "float32" in name else value < 2e-2, (name, value)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("world", MESHES)
def test_tp_step_matches_single_process(runs, world, variant):
    """Params, losses, each step's global norms and every layer's applied
    trust ratio and norms against the single process on the same
    micro-batches: fp32 activations at the data-only runs' tight bounds,
    bf16 ones at ``LOSS_TOL`` and ``BF16_STEP1_RTOL`` on the first step
    and the sharded bound
    over the run; on the run's own micro-batches the sharded bound."""
    entry = runs["reports"][world]["tp_equiv"][variant]
    assert entry["steps"] == STEPS
    for ref in (entry["same_blocks"], entry["same_config"]):
        assert len(ref["losses"]) == STEPS and ref["records"] > 0, ref
        assert ref["loss_diff"] < JAX_LOSS_TOL and ref["param_maxdiff"] < JAX_PARAM_TOL, ref
    ref = entry["same_blocks"]
    if variant.endswith("_f32"):
        assert ref["loss_diff"] < LOSS_TOL, ref
        for key, rel in ref["norm_reldiff"].items():
            assert rel < NORM_RTOL, (key, ref)
        assert ref["record_reldiff"] < NORM_RTOL, ref
        assert ref["param_maxdiff"] < F32_PARAM_TOL.get(variant, PARAM_TOL), ref
    else:
        first = ref["step1"]
        assert first["loss"] < LOSS_TOL, ref
        assert first["grad_norm"] < BF16_STEP1_RTOL, ref
        assert first["records"] < BF16_STEP1_RTOL, ref


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("world", MESHES)
def test_tp_step_matches_jax_trainer(runs, world, variant):
    """The JAX package's single-device Trainer on the same weights and
    batches: the fp32 twins against its fp32 activations at
    ``JAX_F32_*``, the bf16 runs at the JAX suite's sharded bounds.  (The
    world-4 accum2 twin's micro-batches are not the Trainer's: its bound
    covers what the order of the accumulation moves.)"""
    ref = runs["jax"][variant]
    entry = runs["reports"][world]["tp_equiv"][variant]
    loss_tol, param_tol = ((JAX_F32_LOSS_TOL, JAX_F32_PARAM_TOL.get(variant, 5e-5))
                           if variant.endswith("_f32") else (JAX_LOSS_TOL, JAX_PARAM_TOL))
    loss_diff = max(abs(a - b) for a, b in zip(entry["losses"], ref["losses"]))
    assert loss_diff < loss_tol, (entry["losses"], ref["losses"])
    with np.load(os.path.join(runs["dirs"][world], f"tp_{variant}.npz")) as f:
        assert sorted(f.files) == sorted(ref["params"])
        diff = max(float(np.abs(f[k] - ref["params"][k]).max()) for k in f.files)
    assert diff < param_tol, diff


@pytest.mark.parametrize("world", MESHES)
def test_dropped_model_allreduce_fails_the_bound(runs, world):
    """With the norms' all-reduce over the data-parallel group alone, rank
    0's trust ratios come from its own heads, ff columns and vocab rows:
    they move past ``NORM_RTOL`` by orders of magnitude."""
    ref = runs["reports"][world]["tp_planted"]["norms"]["same_blocks"]
    assert ref["record_reldiff"] > 100 * NORM_RTOL, ref
    assert max(ref["norm_reldiff"].values()) > 100 * NORM_RTOL, ref


@pytest.mark.parametrize("variant", ["equiv_fused", "mlm_dense_head"])
@pytest.mark.parametrize("world", MESHES)
def test_dropped_column_gradient_sum_fails_the_bf16_bound(runs, world, variant):
    """A bf16 run whose column-parallel products leave their input gradient
    as this rank's partial (copy_to_model's sum dropped): the first step's
    grad norm moves past ``BF16_STEP1_RTOL`` by orders of magnitude."""
    first = runs["reports"][world]["tp_planted"]["copy"][variant]["same_blocks"]["step1"]
    assert first["grad_norm"] > 100 * BF16_STEP1_RTOL, first


@pytest.mark.parametrize("world", MESHES)
def test_tp_nan_skip_matches_clean_run_bitwise(runs, world):
    """The last rank alone gets a NaN gradient; the verdict is all-reduced
    over the world with MIN, every rank skips, and params and moments are
    bit-equal to a run whose stream omits the batch."""
    e = runs["reports"][world]["nan_skip"]
    assert e["skipped"] == 1 and e["skipped_every_rank"] == [1, 1], e
    assert e["param_maxdiff"] == 0.0 and e["moment_maxdiff"] == 0.0, e
    assert e["steps_match"] and e["final_step"] == 5, e


@pytest.mark.parametrize("where", ["mesh", "single"])
def test_tp_checkpoint_restores_bit_equal(runs, where):
    """The data=2,model=2 save (each leaf gathered over both axes into the
    single-process format) restores bit for bit on data=2,model=1 and in
    one process, and the next step, on the saving run's micro-batches,
    equals the uninterrupted run's."""
    saved = runs["reports"][4]["checkpoint"]
    assert saved["saved"].endswith("step_00000002") and len(saved["losses"]) == STEPS
    ck = runs["restored"]["checkpoint"]
    assert ck["path_step"] == 2 and ck["final_steps"] == [3, 3], ck
    assert ck[f"{where}_restore_bitequal"], ck
    assert ck[f"{where}_step3_maxdiff"] < PARAM_TOL, ck
    assert abs(ck[f"{where}_losses"][0] - saved["losses"][-1]) < LOSS_TOL, (ck, saved)
    with open(os.path.join(runs["dirs"][4], "checkpoint_dp.json")) as f:
        assert json.load(f)["mesh"] == {"data": 2, "model": 2}


# tp_layout's params after 3 steps against the default layout's: each
# leaf's largest difference over its largest value, floored at 1 (measured:
# at most 2.1e-8, the layer-norm biases, 7.1e-6 of their largest value)
LAYOUT_LEAF_TOL = 1e-6


def _gspmd_block(x, spec, sizes, coords):
    """The block of ``x`` that ``spec`` (a JAX PartitionSpec's entries)
    gives the rank at ``coords``: along each dimension split over a tuple
    of axes, the slice at the mixed-radix index of its coordinates, the
    first axis the most significant, as GSPMD lays it out."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n, index = 1, 0
        for a in axes:
            n, index = n * sizes[a], index * sizes[a] + coords[a]
        size = x.shape[dim] // n
        x = np.take(x, range(index * size, (index + 1) * size), axis=dim)
    return x


def test_param_rules_store_the_reference_shards_and_compute_as_the_default(runs):
    """``mlm_fused_ce_f32`` on data=2,model=2 with params and LAMB moments
    stored under ``--param-rule embed=data,model``: q/k/v cut along embed
    over (data, model) with their heads whole, the output projection's heads
    over model and embed over data.  The layers compute in the default
    layout, so the first step's loss is bit-equal to the default layout's
    and, after 3 steps, every leaf is within ``LAYOUT_LEAF_TOL`` of it (the
    trust ratios' norms sum their partials over other blocks, which rounds
    otherwise in fp32 from the second step).  Each rank's
    blocks of the params and moments are the shard the JAX package's
    ``resolve_spec`` gives its coordinates."""
    from repro.sharding import axes as jax_axes

    report = runs["reports"][4]["tp_layout"]
    losses = report["losses"]
    assert losses["rules"][0] == losses["default"][0], losses
    assert len(losses["rules"]) == STEPS
    for k, (diff, scale) in report["leaf_diff"].items():
        assert diff <= LAYOUT_LEAF_TOL * max(1.0, scale), (k, diff, scale)
    with np.load(os.path.join(runs["dirs"][4], "tp_layout_whole.npz")) as f:
        whole = {k: f[k] for k in f.files}
    sizes = {"data": 2, "model": 2}
    rules = dict(jax_axes.default_param_rules(), embed=("data", "model"))
    jcfg = _jax_cfg("bert").replace(activation_dtype="float32")
    specs = _flat_specs(jax_axes.specs_for(jax_build_model(jcfg).defs,
                                           jax_abstract_mesh((2, 2), ("data", "model")), rules))
    assert specs["blocks/attn/wq"] == (None, ("data", "model"))   # trailing Nones dropped
    assert specs["blocks/attn/wo"] == (None, "model", None, "data")
    for r in range(4):
        coords = {"data": r // 2, "model": r % 2}
        with np.load(os.path.join(runs["dirs"][4], f"tp_layout_rank{r}.npz")) as f:
            assert sorted(f.files) == sorted(whole)
            for path in f.files:
                leaf = path.split("/", 2)[-1] if path.startswith("opt_state/") else \
                    path.split("/", 1)[1]
                want = _gspmd_block(whole[path], specs[leaf], sizes, coords)
                np.testing.assert_array_equal(f[path], want, err_msg=f"rank {r} {path}")
