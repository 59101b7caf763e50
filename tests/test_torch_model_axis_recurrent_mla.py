"""The xLSTM/Mamba ``inner`` axis and MLA heads over ``model`` on gloo ranks,
held to the port's single process and to the JAX package's single-device
Trainer on the same weights.

The ranks run in subprocesses (tests/_torch_sharded_harness.py, scenario
``recurrent_mla``) at ``data=1,model=2`` and ``data=2,model=2``, side by
side, while the JAX package trains here; fused LAMB, accum 2.  Budget:
180 s on its xdist worker (measured 159 s in the whole suite on six
workers, 85 s alone).

* xlstm-smoke (4 heads, up-projection 256): the mLSTM on each rank's 128
  ``inner`` columns and 2 heads, the sLSTM on its 2 heads, at both meshes
  in fp32 activations and at ``data=1,model=2`` in bf16;
* jamba-smoke at ``data=1,model=2``: Mamba on each rank's 128 of d_inner
  256, GQA 4/2 heads split with their kv heads, and expert parallelism
  (E 4 over two ranks, capacity factor 0.5 so that tokens drop, the router
  z-loss on), in fp32;
* deepseek-smoke with MTP at ``data=1,model=2``, naive and absorbed: MLA
  on each rank's 2 of 4 heads, the dense prefix's tensor-parallel MLP, the
  MTP projection row-parallel, expert parallelism as jamba's, in fp32.

Bounds against the single process on the data-parallel ranks'
micro-batches (``same_blocks``), in fp32: the first step at the
tensor-parallel suite's (``LOSS_TOL`` 1e-5, ``NORM_RTOL`` 1e-4 on the grad
norm and every layer's applied trust ratio and norms; measured at most
0 and 3.5e-5).  LAMB's later steps magnify the order of the sums (an
element whose gradient is near eps takes a full-size update from its
sign), so steps 2 and 3 hold the norms and records at ``LATER_NORM_RTOL``
1e-3 (measured 3.4e-4) and the params at ``PARAM_TOL`` 2e-5 or, stated
per run, a few times what they show (``F32_PARAM_TOL``: measured 2.7e-5
xlstm, 7.8e-5 jamba, 2.0e-5 deepseek), jamba's MoE terms at 1e-4
(measured 4.6e-5 in ``loss/moe_z``).  The sLSTM's input-gate bias ``b_i``
gets a gradient at the noise of the sums (the stabiliser takes i_t
whenever it leads, and then i_t drops out), so its update norm is 1e-8
and its records differ relatively by the order of the sums alone: held at
``NOISY_RTOL`` 0.5 (measured 0.15).  The JAX Trainer's losses within
``JAX_F32_LOSS_TOL`` 5e-5 and params within ``JAX_F32_PARAM_TOL`` 5e-5 or
the run's stated bound.  bf16 (xlstm): the first step's loss, grad norm and
records at ``XLSTM_BF16_STEP1`` (measured 6.2e-6, 3.0e-4, 2.4e-4; the gate
biases, cancelling sums over the batch, 2.1e-2), the run at the sharded
bound.

Plants, each of which must move a metric or the params by more than
``PLANT_FACTOR`` (100) times its bound: the mLSTM's RMS with its sum of
squares over ``inner`` dropped; an xLSTM or a jamba rank computing on its
stored ``2·inner`` block of the up-projection as if it were its slices of x
and z; the MLA's ``c_kv`` (and ``k_rope``) gradient not summed over
``model``.
"""
import os

import numpy as np
import pytest

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import smoke_config as jax_smoke_config
from test_torch_sharded_train import (
    JAX_LOSS_TOL,
    JAX_PARAM_TOL,
    LOSS_TOL,
    NORM_RTOL,
    PARAM_TOL,
    STEPS,
    _harness,
    _jax_references,
    _jax_trainers,
    _report,
)

LATER_NORM_RTOL = 1e-3
F32_PARAM_TOL = {"xlstm_f32": 1e-4, "jamba_f32": 3e-4, "deepseek_naive_f32": 1e-4,
                 "deepseek_absorbed_f32": 1e-4}
MOE_TERM_TOL = {"jamba_f32": 1e-4}           # else LOSS_TOL
NOISY_LEAVES = ("cell.b_i",)                 # the sLSTM's input-gate bias
NOISY_RTOL = 0.5
GATE_BIASES = ("cell.b_i", "cell.b_igate", "cell.b_fgate")
XLSTM_BF16_STEP1 = dict(loss=5e-5, grad_norm=3e-3, records=3e-3, gate_biases=0.1)
JAX_F32_LOSS_TOL = JAX_F32_PARAM_TOL = 5e-5
PLANT_FACTOR = 100
MESHES = {"data=1,model=2": 2, "data=2,model=2": 4}
LAMB = dict(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True, accum_steps=2)
F32 = dict(activation_dtype="float32")


def _moe(arch, **kw):
    return jax_smoke_config(arch).replace(capacity_factor=0.5, router_z_coef=1e-3, **F32, **kw)


JAX_RUNS = {
    "xlstm_f32": (jax_smoke_config("xlstm-350m").replace(**F32), LAMB),
    "jamba_f32": (_moe("jamba-1.5-large-398b"), LAMB),
    "deepseek_naive_f32": (_moe("deepseek-v3-671b", use_mtp=True), LAMB),
    "deepseek_absorbed_f32": (_moe("deepseek-v3-671b", use_mtp=True, mla_absorb=True), LAMB),
}
RUNS = [("data=1,model=2", "xlstm_f32"), ("data=2,model=2", "xlstm_f32"),
        ("data=1,model=2", "jamba_f32"), ("data=1,model=2", "deepseek_naive_f32"),
        ("data=1,model=2", "deepseek_absorbed_f32")]
PLANTS = ["rms_local", "stored_block", "stored_block_mamba", "mla_unsummed"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("recurrent_mla")
    init = root / "init"
    init.mkdir()
    trainers = _jax_trainers(str(init), JAX_RUNS)
    dirs = {mesh: root / mesh.replace(",", "_").replace("=", "") for mesh in MESHES}
    procs = {mesh: _harness(world, dirs[mesh], "--init", str(init), "--mesh", mesh,
                            "recurrent_mla")
             for mesh, world in MESHES.items()}
    jax_refs = _jax_references(trainers)
    reports = {mesh: _report(p, dirs[mesh])["recurrent_mla"] for mesh, p in procs.items()}
    return {"reports": reports, "dirs": dirs, "jax": jax_refs}


def _noisy(leaf: str) -> bool:
    return leaf.endswith(NOISY_LEAVES)


def _ref(runs, mesh, variant):
    entry = runs["reports"][mesh][variant]
    assert entry["steps"] == STEPS
    return entry["same_blocks"]


@pytest.mark.parametrize("mesh,variant", RUNS)
def test_model_axis_matches_single_process(runs, mesh, variant):
    ref = _ref(runs, mesh, variant)
    assert len(ref["losses"]) == STEPS and ref["records"] > 0, ref
    assert ref["loss_diff"] < LOSS_TOL, ref
    assert ref["step1"]["loss"] < LOSS_TOL and ref["step1"]["grad_norm"] < NORM_RTOL, ref
    for leaf, rel in ref["step1_by_leaf"].items():
        assert rel < (NOISY_RTOL if _noisy(leaf) else NORM_RTOL), (leaf, ref)
    for leaf, rel in ref["record_reldiff_by_leaf"].items():
        assert rel < (NOISY_RTOL if _noisy(leaf) else LATER_NORM_RTOL), (leaf, ref)
    for key, rel in ref["norm_reldiff"].items():
        assert rel < LATER_NORM_RTOL, (key, ref)
    for key, diff in ref["metric_diff"].items():
        assert diff < MOE_TERM_TOL.get(variant, LOSS_TOL), (key, ref)
    if variant.startswith(("jamba", "deepseek")):
        assert min(ref["metrics"]["moe/drop_fraction"]) > 0, ref   # tokens drop
    if variant.startswith("deepseek"):
        assert "loss/mtp" in ref["metric_diff"], ref
    assert ref["param_maxdiff"] < F32_PARAM_TOL.get(variant, PARAM_TOL), ref


def test_xlstm_bf16_first_step(runs):
    """bf16 activations: the first step at ``XLSTM_BF16_STEP1``, the run at
    the sharded bound."""
    ref = _ref(runs, "data=1,model=2", "xlstm_bf16")
    first, bound = ref["step1"], XLSTM_BF16_STEP1
    assert first["loss"] < bound["loss"] and first["grad_norm"] < bound["grad_norm"], ref
    for leaf, rel in ref["step1_by_leaf"].items():
        gate = leaf.endswith(GATE_BIASES)
        assert rel < (bound["gate_biases"] if gate else bound["records"]), (leaf, ref)
    assert ref["loss_diff"] < JAX_LOSS_TOL and ref["param_maxdiff"] < JAX_PARAM_TOL, ref


@pytest.mark.parametrize("mesh,variant", RUNS)
def test_model_axis_matches_jax_trainer(runs, mesh, variant):
    ref = runs["jax"][variant]
    entry = runs["reports"][mesh][variant]
    loss_diff = max(abs(a - b) for a, b in zip(entry["losses"], ref["losses"]))
    assert loss_diff < JAX_F32_LOSS_TOL, (entry["losses"], ref["losses"])
    path = os.path.join(runs["dirs"][mesh], f"recurrent_mla_{variant}.npz")
    with np.load(path) as f:
        assert sorted(f.files) == sorted(ref["params"])
        diff = max(float(np.abs(f[k] - ref["params"][k]).max()) for k in f.files)
    assert diff < max(JAX_F32_PARAM_TOL, F32_PARAM_TOL.get(variant, 0.0)), diff


def _worst(ref, variant) -> float:
    """The largest of the run's distances from the single process, each in
    units of its bound."""
    steps = [rel / (NOISY_RTOL if _noisy(leaf) else NORM_RTOL)
             for leaf, rel in ref["step1_by_leaf"].items()]
    later = [rel / (NOISY_RTOL if _noisy(leaf) else LATER_NORM_RTOL)
             for leaf, rel in ref["record_reldiff_by_leaf"].items()]
    return max(ref["loss_diff"] / LOSS_TOL,
               ref["param_maxdiff"] / F32_PARAM_TOL.get(variant, PARAM_TOL),
               ref["step1"]["grad_norm"] / NORM_RTOL, *steps, *later,
               *(v / LATER_NORM_RTOL for v in ref["norm_reldiff"].values()),
               *(v / MOE_TERM_TOL.get(variant, LOSS_TOL) for v in ref["metric_diff"].values()))


@pytest.mark.parametrize("plant,variant", [
    ("rms_local", "xlstm_f32"), ("stored_block", "xlstm_f32"),
    ("stored_block_mamba", "jamba_f32"), ("mla_unsummed", "deepseek_naive_f32")])
def test_planted_model_axis_faults_fail_the_bound(runs, plant, variant):
    ref = runs["reports"]["data=1,model=2"]["planted"][plant]["same_blocks"]
    assert _worst(ref, variant) > PLANT_FACTOR, ref
