"""Data-parallel FSDP training of the port on real ranks over gloo, held to
the port's single-process run and to the JAX package's single-device
Trainer on the same weights.

The ranks run in subprocesses (tests/_torch_sharded_harness.py), once at
world 4 and once at world 2; the module-scoped fixture runs both, and the
JAX package's Trainer here meanwhile, and the tests assert on slices of
their reports.  The world-2 run restores the checkpoint the world-4 run
saved.

Two single-process references, both from the sharded run's initial state:

* ``same_blocks`` takes ``accum_steps × world`` micro-batches, so its
  micro-batches are the ranks' rows and only the order of the fp32 batch
  reductions differs.  Held to a largest parameter difference below
  ``PARAM_TOL`` 2e-5 and a loss difference below ``LOSS_TOL`` 1e-5
  (measured: at most 1.2e-7 and 4.8e-7), and each step's global norms,
  trust-ratio summary and every layer's applied trust ratio, param norm and
  update norm within ``NORM_RTOL`` 1e-4 relative (measured: at most 1.5e-5,
  the grad norm of bert-smoke's MLM step, whose embedding gradient sums
  terms that cancel).  A reduction left partial on one rank moves these by
  percents: a trust ratio from one rank's slice, a grad norm from its
  shard.  LAMB hardly moves the params in 3 steps at lr 1e-3 (about 2e-5 a
  step), so the norms and ratios, not the params, are what shows such a
  fault;
* ``same_config`` takes the run's own ``accum_steps``: bf16 activations
  round each micro-batch's gradients once, so rows split over the ranks are
  rounded over other sums, LAMB magnifies the difference through the trust
  ratio (measured: up to 2.9e-3 in params and 2.6e-3 in loss), and the run
  is held to the JAX suite's own sharded bounds
  (``tests/test_sharded_train.py``: ``PARAM_TOL`` 2e-2, ``LOSS_TOL`` 1e-2),
  as is the comparison with the JAX package (measured: up to 4.5e-3 and
  3.0e-3).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import DataPipeline as JaxDataPipeline
from repro.models import build_model as jax_build_model
from repro.train import Trainer as JaxTrainer
from repro_torch.nn import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, "tests", "_torch_sharded_harness.py")
WORLDS = (4, 2)
BATCH, SEQ, STEPS = 16, 32, 3

PARAM_TOL, LOSS_TOL = 2e-5, 1e-5            # against the same blocks
NORM_RTOL = 1e-4                            # relative, norms and trust ratios
PRINT_TOL = 1.5e-4   # printed losses have 4 decimals: one unit in the last place
JAX_PARAM_TOL, JAX_LOSS_TOL = 2e-2, 1e-2    # the JAX suite's sharded bounds

TINY = JaxModelConfig(
    name="tiny-sharded", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, tie_embeddings=True,
)
LAMB = dict(optimizer="lamb", learning_rate=1e-3)
RUNS = {   # (scenario, variant): (JAX config, TrainConfig keywords), as the harness's
    ("equiv", "unfused"): (TINY, LAMB),
    ("equiv", "fused"): (TINY, dict(LAMB, use_fused_lamb=True)),
    ("equiv", "accum2_bf16"): (TINY, dict(LAMB, accum_steps=2, precision="bf16")),
    ("lans", "fp32"): (TINY, dict(optimizer="lans", learning_rate=1e-3)),
    ("lans", "accum2_bf16"): (TINY, dict(optimizer="lans", learning_rate=1e-3,
                                         accum_steps=2, precision="bf16")),
    ("mlm_flash", "fused_ce"): ("bert", dict(LAMB, use_fused_lamb=True)),
    ("mlm_flash", "dense_head"): ("bert-dense", dict(LAMB, use_fused_lamb=True)),
}


def _jax_cfg(cfg):
    if cfg == "bert":
        return jax_smoke_config("bert-large")
    if cfg == "bert-dense":
        return jax_smoke_config("bert-large").replace(use_fused_ce_head=False)
    return cfg


def _jax_trainers(init_dir, runs=RUNS):
    """The JAX package's single-device Trainer for each of ``runs``,
    initialised: each config's initial parameters are written to
    ``init_dir/<config name>.npz``, where the harness starts every port run
    from, and every run of that config starts from them too."""
    trainers, first = {}, {}
    for key, (cfg, kw) in runs.items():
        cfg = _jax_cfg(cfg)
        tr = JaxTrainer(jax_build_model(cfg), JaxTrainConfig(**kw), log_every=1,
                        log_fn=lambda s: None)
        tr.init()
        if cfg.name not in first:   # host copies: the step donates its state
            first[cfg.name] = jax.tree.map(np.asarray, tr.state.params)
            np.savez(os.path.join(init_dir, f"{cfg.name}.npz"),
                     **{k: v.astype(np.float32) for k, v in flatten(first[cfg.name]).items()})
        tr.state = tr.state._replace(params=jax.tree.map(jnp.asarray, first[cfg.name]))
        trainers[key] = (tr, cfg)
    return trainers


def _jax_references(trainers):
    """Each JAX Trainer's per-step losses and final parameters."""
    out = {}
    for key, (tr, cfg) in trainers.items():
        tr.fit(JaxDataPipeline(cfg, BATCH, SEQ, seed=0), STEPS)
        out[key] = {"losses": [h["loss/total"] for h in tr.history],
                    "params": {k: np.asarray(jnp.asarray(v, jnp.float32))
                               for k, v in flatten(tr.state.params).items()}}
    return out


def _harness(world, out, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, HARNESS, "--world", str(world),
                             "--out", str(out), *extra], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _report(proc, out):
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(os.path.join(out, "report.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    init = root / "init"
    init.mkdir()
    # the initial weights come from the JAX package: written first, then
    # the world-4 ranks run while the JAX package trains
    trainers = _jax_trainers(str(init))
    w4 = root / "w4"
    proc4 = _harness(4, w4, "--init", str(init))
    jax_refs = _jax_references(trainers)
    report4 = _report(proc4, w4)
    w2 = root / "w2"
    report2 = _report(_harness(2, w2, "--init", str(init), "--restore", str(w4)), w2)
    return {"reports": {4: report4, 2: report2}, "dirs": {4: w4, 2: w2},
            "jax": jax_refs}


def test_harness_ran_both_worlds(runs):
    assert {w: r["world"] for w, r in runs["reports"].items()} == {4: 4, 2: 2}


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_match_their_plain_versions(runs, world):
    """Gathers move bits and max/min pick one: exact.  A float sum over
    the ranks may add in another order than the plain version's: within
    fp32 rounding of its operands (standard normals, |sum| < 16)."""
    checks = runs["reports"][world]["collectives"]
    assert len(checks) == 14
    for name, value in checks.items():
        if name.startswith("gather"):
            assert value is True, name
        elif "sum_torch.float32" in name or name.startswith("scatter"):
            assert value < 1e-5, (name, value)
        else:
            assert value == 0.0, (name, value)


@pytest.mark.parametrize("key", list(RUNS), ids=lambda k: "-".join(k))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_single_process(runs, world, key):
    """Same micro-batches, so only the order of the fp32 batch reductions
    (the reduce-scatter, the all-reduced norms and trust-ratio sums)
    differs from the single process: params, losses, each step's
    ``grad_norm``, ``update_norm`` and trust-ratio summary, and every
    layer's applied trust ratio and norms."""
    entry = runs["reports"][world][key[0]][key[1]]
    ref = entry["same_blocks"]
    assert entry["steps"] == STEPS and len(ref["losses"]) == STEPS
    assert ref["param_maxdiff"] < PARAM_TOL, entry
    assert ref["loss_diff"] < LOSS_TOL, entry
    assert ref["norm_reldiff"].keys() == {"grad_norm", "update_norm", "trust_ratio/min",
                                          "trust_ratio/max", "trust_ratio/mean"}, ref
    for name, rel in ref["norm_reldiff"].items():
        assert rel < NORM_RTOL, (name, ref)
    assert ref["records"] > 0 and ref["record_reldiff"] < NORM_RTOL, ref


@pytest.mark.parametrize("key", list(RUNS), ids=lambda k: "-".join(k))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_single_process_same_config(runs, world, key):
    entry = runs["reports"][world][key[0]][key[1]]["same_config"]
    assert entry["param_maxdiff"] < JAX_PARAM_TOL, entry
    assert entry["loss_diff"] < JAX_LOSS_TOL, entry


@pytest.mark.parametrize("key", list(RUNS), ids=lambda k: "-".join(k))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax_trainer(runs, world, key):
    """The JAX package's single-device Trainer on the same weights and
    batches, at the JAX suite's sharded bounds."""
    ref = runs["jax"][key]
    entry = runs["reports"][world][key[0]][key[1]]
    loss_diff = max(abs(a - b) for a, b in zip(entry["losses"], ref["losses"]))
    assert loss_diff < JAX_LOSS_TOL, (entry["losses"], ref["losses"])
    with np.load(os.path.join(runs["dirs"][world], f"{key[0]}_{key[1]}.npz")) as f:
        assert sorted(f.files) == sorted(ref["params"])
        diff = max(float(np.abs(f[k] - ref["params"][k]).max()) for k in f.files)
    assert diff < JAX_PARAM_TOL, diff


@pytest.mark.parametrize("world", WORLDS)
def test_mixed_batch_stages_run_sharded(runs, world):
    st = runs["reports"][world]["stages"]
    assert st["final_step"] == 4 and st["stages"] == [0, 0, 1, 1] and st["finite"], st
    assert st["param_maxdiff"] < JAX_PARAM_TOL and st["loss_diff"] < JAX_LOSS_TOL, st


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_shrinks_per_rank_state(runs, world):
    """Params + LAMB moments per rank shrink at least N/2-fold (the JAX
    suite asks 4× of data=8)."""
    mem = runs["reports"][world]["memory"]
    assert mem["state_ratio"] >= world / 2, mem
    assert mem["single_state_bytes"] > mem["fsdp_per_rank_state_bytes"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_only_rank0_writes_telemetry_with_the_mesh(runs, world):
    mem = runs["reports"][world]["memory"]
    assert mem["events_all_ranks"] == mem["events_rank0"] > 0, mem
    assert mem["run_start_mesh"] == {"data": world, "model": 1}, mem


@pytest.mark.parametrize("world", WORLDS)
def test_non_divisible_batches_raise(runs, world):
    g = runs["reports"][world]["guards"]
    assert g["pipeline_raises"] and "divisible" in g["pipeline_msg"], g
    assert g["trainer_raises"] and "divisible" in g["trainer_msg"], g
    assert g["rows_ok"] and g["every_rank"], g


@pytest.mark.parametrize("world", WORLDS)
def test_nan_skip_matches_clean_run_bitwise(runs, world):
    """One rank's gradient is poisoned; the guard's verdict is all-reduced
    with MIN, so every rank skips the step, and params and moments are
    bit-equal to a run whose stream omits it."""
    e = runs["reports"][world]["nan_skip"]
    assert e["skipped"] == 1 and e["skipped_every_rank"] == [1, 1], e
    assert e["param_maxdiff"] == 0.0 and e["moment_maxdiff"] == 0.0, e
    assert e["steps_match"] and e["final_step"] == 5, e


def test_checkpoint_saved_at_data4(runs):
    ck = runs["reports"][4]["checkpoint"]
    assert ck["saved"].endswith("step_00000002") and len(ck["losses"]) == STEPS


@pytest.mark.parametrize("where", ["mesh", "single"])
def test_data4_checkpoint_restores_bit_equal(runs, where):
    """The data=4 save restores onto data=2 and into one process bit for
    bit, and the next step, on the data=4 run's micro-batches, equals the
    uninterrupted run's."""
    ck = runs["reports"][2]["checkpoint"]
    assert ck["path_step"] == 2 and ck["final_steps"] == [3, 3], ck
    assert ck[f"{where}_restore_bitequal"], ck
    assert ck[f"{where}_step3_maxdiff"] < PARAM_TOL, ck
    want = runs["reports"][4]["checkpoint"]["losses"][-1]
    assert abs(ck[f"{where}_losses"][0] - want) < LOSS_TOL, (ck, want)


def _losses(out: str):
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step ")]


@pytest.mark.parametrize("mesh", ["data=2,model=1", "data=1,model=2"])
def test_launcher_under_torchrun_matches_single_process(tmp_path, mesh):
    """``--mesh`` under ``torch.distributed.run`` trains bert-smoke through
    fused LAMB, flash and the fused CE head; its printed losses equal a
    single process's on the same micro-batches (rank 0 alone prints).
    Over ``model=2`` the heads, ff and vocab split: the first step's loss
    within a printed unit, the later ones within the JAX suite's sharded
    bound, as bert-smoke's bf16 activations round the products whose
    contraction the ranks split in other places
    (tests/test_torch_tensor_parallel_train.py)."""
    sizes = dict(item.split("=") for item in mesh.split(","))
    dp = int(sizes["data"])
    common = ["-m", "repro_torch.launch.train", "--arch", "bert-large", "--smoke",
              "--fused-lamb", "--steps", "3", "--batch", "8", "--seq", "16",
              "--device", "cpu", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", *common, "--mesh", mesh]
    single = [sys.executable, *common, "--accum-steps", str(dp)]
    procs = [subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cmd in (run, single)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        finally:
            p.kill()
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    sharded, one = outs
    assert f"mesh={{'data': {dp}, 'model': {2 // dp}}} devices=2" in sharded
    assert "flash=True fused_ce=True" in sharded and sharded.count("done: step=3 ") == 1
    assert len(_losses(sharded)) == 3
    np.testing.assert_allclose(_losses(sharded)[:1], _losses(one)[:1], atol=PRINT_TOL)
    np.testing.assert_allclose(_losses(sharded), _losses(one),
                               atol=PRINT_TOL if dp == 2 else JAX_LOSS_TOL)
