"""Expert parallelism over ``model`` on gloo ranks, held to the port's single
process and to the JAX package's single-device Trainer on the same weights.

granite-moe-smoke (E 4, top-2, capacity factor 0.5 so that tokens drop,
the router z-loss on; fused LAMB) splits its experts over ``model``: each
rank holds two experts, forms its columns of the router logits, gathers
them whole, routes as one device does and runs its own experts; the ranks'
outputs are summed in fp32 (models/layers/moe.py).  The ranks run in
subprocesses (tests/_torch_sharded_harness.py, scenario ``ep``) at
``data=1,model=2`` (accum 1 and 2 in fp32 activations, accum 2 in bf16)
and at ``data=2,model=2`` (accum 2, fp32; with jamba-smoke and
deepseek-smoke with MTP under the same config changes, expert parallelism
beside Mamba's ``inner`` axis and MLA heads over two data ranks, from the
port's seed init: tests/test_torch_model_axis_recurrent_mla.py holds them
to the JAX Trainer at one data rank), side by side, while the JAX package
trains here.  Budget: 180 s on its xdist worker (measured 61 s in the
whole suite on six workers, 36 s alone).

The reference is the single process on the run's own micro-batches
(``same_config``): a micro-batch routes as a whole, so the ranks' blocks
alone would route otherwise.  In fp32 activations, the tensor-parallel
suite's bounds: ``LOSS_TOL`` 1e-5 on the loss and on ``loss/moe_lb``,
``moe/drop_fraction`` and ``loss/moe_z``, ``NORM_RTOL`` 1e-4 on the first
step's grad norm and every layer's applied trust ratio and norms, and
``PARAM_TOL`` 2e-5 on the final params.  LAMB's later steps magnify the
order of the sums, so steps 2 and 3 hold the norms and records at
``LATER_NORM_RTOL`` 1e-3 (measured at most 4.8e-7 in loss, 4.3e-6 in the
first step's grad norm and 3.2e-4 in a later one, 1.2e-5 in params).
jamba and deepseek take the per-run bounds of
tests/test_torch_model_axis_recurrent_mla.py (``F32_PARAM_TOL``,
``MOE_TERM_TOL``, which LAMB's magnification needs from the JAX init
there; measured here 1.4e-5 and 1.6e-6 in params, 3.3e-6 in jamba's
``loss/moe_z``).  granite's runs: the JAX Trainer's losses and params
within ``JAX_F32_LOSS_TOL`` and ``JAX_F32_PARAM_TOL`` 5e-5.  In bf16 the
first step at the dense tensor-parallel suite's bounds
(tests/test_torch_tensor_parallel_train.py: ``LOSS_TOL``,
``BF16_STEP1_RTOL`` 5e-4 on the grad norm and the records; measured
2.9e-6, 8.5e-5, 1.1e-4) and the run at the sharded bound.

Plants, each of which must move a metric or the params by more than
``PLANT_FACTOR`` (100) times its bound: the gates' and the tokens'
gradients left as each rank's partial (the sum over ``model`` dropped),
and the logits gather's backward summing the ranks' whole gradients, so
the router's terms count once a rank.
"""
import os

import numpy as np
import pytest

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import smoke_config as jax_smoke_config
from test_torch_model_axis_recurrent_mla import F32_PARAM_TOL, MOE_TERM_TOL
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

BF16_STEP1_RTOL = 5e-4
LATER_NORM_RTOL = 1e-3   # steps 2 and 3's norms and records: see the module docstring
JAX_F32_LOSS_TOL = JAX_F32_PARAM_TOL = 5e-5
PLANT_FACTOR = 100
MESHES = {"data=1,model=2": 2, "data=2,model=2": 4}
LAMB = dict(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True)
MOE = jax_smoke_config("granite-moe-1b-a400m").replace(
    capacity_factor=0.5, router_z_coef=1e-3, activation_dtype="float32")
FAMILIES = ("jamba_f32", "deepseek_naive_f32")
JAX_RUNS = {f"accum{a}_f32": (MOE, dict(LAMB, accum_steps=a)) for a in (1, 2)}
MOE_KEYS = ("loss/moe_lb", "moe/drop_fraction", "loss/moe_z")
RUNS = [("data=1,model=2", "accum1_f32"), ("data=1,model=2", "accum2_f32"),
        ("data=2,model=2", "accum2_f32"),
        *(("data=2,model=2", v) for v in FAMILIES)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep")
    init = root / "init"
    init.mkdir()
    trainers = _jax_trainers(str(init), JAX_RUNS)
    dirs = {mesh: root / mesh.replace(",", "_").replace("=", "") for mesh in MESHES}
    procs = {mesh: _harness(world, dirs[mesh], "--init", str(init), "--mesh", mesh, "ep")
             for mesh, world in MESHES.items()}
    jax_refs = _jax_references(trainers)
    reports = {mesh: _report(p, dirs[mesh])["ep"] for mesh, p in procs.items()}
    return {"reports": reports, "dirs": dirs, "jax": jax_refs}


def _ref(runs, mesh, variant):
    entry = runs["reports"][mesh][variant]
    assert entry["steps"] == STEPS
    return entry["same_config"]


@pytest.mark.parametrize("mesh,variant", RUNS)
def test_expert_parallel_matches_single_process(runs, mesh, variant):
    ref = _ref(runs, mesh, variant)
    assert len(ref["losses"]) == STEPS and ref["records"] > 0, ref
    assert min(ref["metrics"]["moe/drop_fraction"]) > 0, ref   # tokens drop
    assert ref["loss_diff"] < LOSS_TOL, ref
    for key in MOE_KEYS:
        assert ref["metric_diff"][key] < MOE_TERM_TOL.get(variant, LOSS_TOL), (key, ref)
    assert ref["step1"]["grad_norm"] < NORM_RTOL and ref["step1"]["records"] < NORM_RTOL, ref
    for key, rel in ref["norm_reldiff"].items():
        assert rel < LATER_NORM_RTOL, (key, ref)
    assert ref["record_reldiff"] < LATER_NORM_RTOL, ref
    assert ref["param_maxdiff"] < F32_PARAM_TOL.get(variant, PARAM_TOL), ref


def test_expert_parallel_bf16_first_step(runs):
    """bf16 activations: the first step at the dense tensor-parallel
    suite's bounds, the run at the sharded bound."""
    ref = _ref(runs, "data=1,model=2", "accum2_bf16")
    first = ref["step1"]
    assert first["loss"] < LOSS_TOL, ref
    assert first["grad_norm"] < BF16_STEP1_RTOL and first["records"] < BF16_STEP1_RTOL, ref
    assert min(ref["metrics"]["moe/drop_fraction"]) > 0, ref
    assert ref["loss_diff"] < JAX_LOSS_TOL and ref["param_maxdiff"] < JAX_PARAM_TOL, ref


@pytest.mark.parametrize("mesh,variant", RUNS[:3])
def test_expert_parallel_matches_jax_trainer(runs, mesh, variant):
    ref = runs["jax"][variant]
    entry = runs["reports"][mesh][variant]
    loss_diff = max(abs(a - b) for a, b in zip(entry["losses"], ref["losses"]))
    assert loss_diff < JAX_F32_LOSS_TOL, (entry["losses"], ref["losses"])
    path = os.path.join(runs["dirs"][mesh], f"ep_{variant}.npz")
    with np.load(path) as f:
        assert sorted(f.files) == sorted(ref["params"])
        diff = max(float(np.abs(f[k] - ref["params"][k]).max()) for k in f.files)
    assert diff < JAX_F32_PARAM_TOL, diff


def _worst(ref) -> float:
    """The largest of the run's distances from the single process, each in
    units of its bound."""
    return max(ref["loss_diff"] / LOSS_TOL, ref["param_maxdiff"] / PARAM_TOL,
               ref["step1"]["grad_norm"] / NORM_RTOL, ref["step1"]["records"] / NORM_RTOL,
               ref["record_reldiff"] / LATER_NORM_RTOL,
               *(v / LATER_NORM_RTOL for v in ref["norm_reldiff"].values()),
               *(v / LOSS_TOL for v in ref["metric_diff"].values()))


@pytest.mark.parametrize("plant", ["unsummed_grads", "summing_gather"])
def test_planted_expert_parallel_faults_fail_the_bound(runs, plant):
    """The gates' and tokens' gradients left partial, or the logits
    gather's backward summing: each moves the run past its bounds."""
    ref = runs["reports"]["data=1,model=2"]["planted"][plant]["same_config"]
    assert _worst(ref) > PLANT_FACTOR, ref
