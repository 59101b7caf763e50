"""FSDP and tensor-parallel training of the port over gloo (run as a
subprocess).

    PYTHONPATH=src python tests/_torch_sharded_harness.py --world 4 --out DIR \
        [--mesh data=2,model=2] [--init DIR] [--restore DIR] [scenario ...]

Starts ``--world`` processes of this file, ranks of one gloo group on
``localhost``, each on one CPU thread; each builds the mesh ``--mesh``
(default ``data=<world>,model=1``) with ``init_distributed`` and runs the
scenarios.
Rank 0 also runs each scenario's single-process reference (the port's
Trainer without a mesh) and writes ``DIR/report.json``, plus the sharded
runs' final parameters as ``DIR/<scenario>_<variant>.npz`` for the test to
hold against the JAX package.  ``--init DIR`` reads each config's initial
parameters from ``DIR/<config name>.npz`` (the test writes the JAX
package's there; without it the port's seed init).  Scenarios:

  collectives  every collective against its plain version, on real ranks
  equiv        sharded ≡ single process (unfused / fused / accum2+bf16 LAMB
               on TINY): params, losses, global norms and every layer's
               applied trust ratio
  lans         LANS sharded ≡ single process (fp32 and accum2+bf16)
  mlm_flash    bert-smoke MLM through flash attention, fused LAMB and the
               fused CE head (and the dense head)
  stages       the two-stage recipe on the mesh ≡ single process
  memory       per-rank param + moment bytes, FSDP against whole
  guards       non-divisible batches raise with "divisible"
  nan_skip     a grad-NaN batch on one rank is skipped on every rank;
               params and moments bit-equal to a clean run that omits it
  checkpoint   without ``--restore``: save at step 2 on this mesh and run on
               to step 3 (written under ``DIR/ckpt``); with ``--restore
               DIR``: restore that save on this mesh (``--restore-mesh``:
               on that one instead) and in one process, bit-equal, and
               take step 3 on each

Tensor parallelism (a ``model`` axis of more than one rank):

  tp_collectives  copy_to_model / reduce_from_model (forward and backward)
               and the two-axis block gather against their plain versions
  tp_equiv     the dense runs over the mesh ≡ single process: equiv fused
               and accum2+bf16, LANS fp32, bert-smoke's MLM with the fused
               CE head and the dense head; each also with fp32 activations
               (``*_f32``), where only the order of fp32 sums differs
  tp_planted   ``equiv_fused_f32`` with the norms' all-reduce cut to the
               data-parallel group (the model axis dropped), and two bf16
               runs with the column products' input-gradient sum dropped: the trust
               ratios, and the first step's grad norm, must move past the
               bound
  tp_layout    ``mlm_fused_ce_f32`` with params and moments stored under
               ``--param-rule embed=data,model`` against the default layout,
               and each rank's blocks written for the test to check

Robustness over the mesh (one verdict, one flag, one writer):

  host_collectives  agree_any, broadcast_int, barrier and sum_across on
               real ranks against their plain versions
  spike_rollback  an injected loss spike trips the supervisor on every
               rank; the rollback's events, final step and params against
               the single process (rank 0 runs it)

``--victim`` runs one training world instead (TINY, fused LAMB, async
checkpoints unless ``--sync-checkpoint``; each rank writes
``--json PATH.rank<r>``, rank 0 with the history): ``--kill-after-batches
N`` / ``--kill-at-save SAVE:LEAF`` SIGKILL rank 0 (the parent then kills
the other ranks: no rank waits for gloo's timeout), ``--term-at R:N,...``
sends rank R SIGTERM when it pulls batch N, ``--timeout`` kills a world
that does not finish (exit 124).

The model axis's GQA and MoE over data ranks:

  gqa          smollm-smoke (3 heads, 1 kv head) and a straddling GQA
               config (6 heads, 2 kv heads) at data=1,model=3: fp32 and
               bf16 runs against the single process, and fp32 with the kv
               gradient's sum over ``model`` dropped (planted)
  moe_data     granite-moe-smoke with a capacity that drops tokens, at
               data=2 with accum 1 and 2, deepseek-smoke and jamba-smoke
               at accum 2, and granite at accum 2 with half of one rank's
               labels IGNORE (unequal supervised counts), against the
               single process; and with a rank-local capacity, rank-local
               offsets, a rank-local load-balance loss, or the backward
               scaled by each rank's count after it rather than seeded
               with it (planted)

The rest of the model axis (each run against the single process; the
plants must fail the bounds):

  ep           granite-moe-smoke's experts split over model (a capacity that
               drops tokens, the z-loss): fp32 at accum 1 and 2 and bf16 at
               accum 2 (over two data ranks fp32 accum 2 alone, with
               jamba-smoke and deepseek-smoke with MTP); planted:
               the gates' and tokens' gradients left partial, the logits
               gather's backward summing
  recurrent_mla  xlstm-smoke (fp32 and bf16), and at one data rank
               jamba-smoke and deepseek-smoke with MTP (naive and absorbed)
               in fp32; planted: the mLSTM's RMS without its sum over
               model, a rank computing on its stored up-projection block
               (xlstm, jamba), the MLA latents' gradients left partial

Serving on the mesh (each rank's engine checks its outcome against rank
0's and its cache or pool against its block; rank 0 runs the single
process beside it, for ``continuous`` over two data ranks alone):

  serve        the static ``Engine(shard_ctx=)`` for :data:`SERVE_ARCHS`
  continuous   ``ContinuousEngine(shard_ctx=)``: greedy for
               :data:`SERVE_ARCHS`, over two data ranks a pool the ranks do
               not divide and one slot under ``cache_seq``, then faults, a
               stall on rank 1 alone and rank 1's drain flag alone, with
               rank 0 the one writer; and ``agree_clock`` against its plain
               version
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.checkpoint.io import tree_leaves_with_paths, tree_map_with_paths
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import make_stage
from repro_torch.data import DataPipeline
from repro_torch.data.synthetic import IGNORE
from repro_torch.launch.mesh import init_distributed, shutdown_distributed
from repro_torch.models import build_model
from repro_torch.sharding import ShardCtx, dp_size, leaf_dims, per_device_state_bytes, specs_for
from repro_torch.sharding import collectives as C
from repro_torch.telemetry import EventLog, read_events
from repro_torch.train import FaultInjector, FaultSpec, SupervisorConfig, Trainer, TrainState
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import TERM_KEYS

TINY = ModelConfig(
    name="tiny-sharded", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, tie_embeddings=True,
)
BATCH, SEQ, STEPS = 16, 32, 3


def variants():
    """``{scenario: {variant: (config, TrainConfig)}}`` of the equivalence runs."""
    lamb = dict(optimizer="lamb", learning_rate=1e-3)
    bert = smoke_config("bert-large")
    return {
        "equiv": {
            "unfused": (TINY, TrainConfig(**lamb)),
            "fused": (TINY, TrainConfig(**lamb, use_fused_lamb=True)),
            "accum2_bf16": (TINY, TrainConfig(**lamb, accum_steps=2, precision="bf16")),
        },
        "lans": {
            "fp32": (TINY, TrainConfig(optimizer="lans", learning_rate=1e-3)),
            "accum2_bf16": (TINY, TrainConfig(optimizer="lans", learning_rate=1e-3,
                                              accum_steps=2, precision="bf16")),
        },
        "mlm_flash": {
            "fused_ce": (bert, TrainConfig(**lamb, use_fused_lamb=True)),
            "dense_head": (bert.replace(use_fused_ce_head=False),
                           TrainConfig(**lamb, use_fused_lamb=True)),
        },
    }


def tp_variants():
    """``{variant: (config, TrainConfig)}`` of the tensor-parallel runs: the
    JAX suite's TP runs, and each again with fp32 activations (``_f32``)."""
    v = variants()
    runs = {"equiv_fused": v["equiv"]["fused"], "equiv_accum2_bf16": v["equiv"]["accum2_bf16"],
            "lans_fp32": v["lans"]["fp32"], "mlm_fused_ce": v["mlm_flash"]["fused_ce"],
            "mlm_dense_head": v["mlm_flash"]["dense_head"]}
    runs.update({f"{k}_f32": (cfg.replace(activation_dtype="float32"), tc)
                 for k, (cfg, tc) in list(runs.items())})
    return runs


CKPT_TC = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True)


class Ctx:
    def __init__(self, mesh, out: str, init: str):
        self.mesh, self.out, self.init = mesh, out, init
        self.rank0 = mesh.rank == 0
        self.dp = dp_size(mesh)
        self.world = mesh.group(mesh.axis_names)
        # rank 0's single-process references by (config, TrainConfig,
        # blocks): a planted run takes its clean twin's (no plant reaches
        # a single process, which has no model axis)
        self.refs: dict = {}


def _quiet(model, tc, mesh=None, **kw):
    return Trainer(model, tc, device="cpu", mesh=mesh, log_every=1,
                   log_fn=lambda s: None, **kw)


def initial_state(cfg, tc, init: str) -> TrainState:
    """The whole initial state: the port's seed init, with the parameters
    replaced by ``init/<cfg.name>.npz`` where the test wrote one."""
    model = build_model(cfg)
    init_fn, _ = make_train_step(model, tc)
    state = init_fn(tc.seed, torch.device("cpu"))
    path = os.path.join(init, f"{cfg.name}.npz") if init else ""
    if path and os.path.exists(path):
        with np.load(path) as f:
            for k, v in state.params.items():
                v.copy_(torch.from_numpy(f[k]).to(v.dtype))
    return state


def _clone(state: TrainState) -> TrainState:
    return tree_map_with_paths(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def maxdiff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _losses(tr):
    return [h["loss/total"] for h in tr.history]


NORM_KEYS = ("grad_norm", "update_norm", "trust_ratio/min", "trust_ratio/max",
             "trust_ratio/mean")


def _single(model, tc, state, cfg) -> Trainer:
    tr = _quiet(model, tc, telemetry=EventLog.memory())
    tr.state = _clone(state)
    tr.fit(DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0), STEPS)
    return tr


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def _records(tr) -> list:
    """Every logged step's per-layer records, flattened: the applied trust
    ratio, the param norm and the update norm of each layer of each leaf."""
    out = []
    for e in tr.telemetry.events:
        if e["event"] == "trust_ratios":
            for name in sorted(e["layers"]):
                entry = e["layers"][name]
                for key in ("per_layer", "param_norm", "update_norm"):
                    out += [(e["step"], name, key, i, x) for i, x in enumerate(entry[key])]
    return out


def _by_leaf(mine, theirs) -> dict:
    """The largest relative difference of each leaf's records."""
    out: dict = {}
    for a, b in zip(mine, theirs):
        out[a[1]] = max(out.get(a[1], 0.0), _rel(a[4], b[4]))
    return out


def _diffs(tr, whole, ref) -> dict:
    """The run against a reference: params, losses, each step's global
    norms and trust-ratio summary (``NORM_KEYS``), and every layer's
    applied trust ratio and norms, the last two as relative differences;
    ``step1``: the first step's loss, grad norm and per-layer records alone,
    before LAMB's later steps magnify a rounding."""
    rows = list(zip(tr.history, ref.history))
    mine, theirs = _records(tr), _records(ref)
    assert [r[:4] for r in mine] == [r[:4] for r in theirs] and mine, (len(mine), len(theirs))
    worst = max(whole.params, key=lambda k: maxdiff({k: whole.params[k]}, {k: ref.state.params[k]}))
    first = mine[0][0]
    terms = [k for k in TERM_KEYS if k in rows[0][1]]
    return {"metric_diff": {k: max(abs(a[k] - b[k]) for a, b in rows) for k in terms},
            "metrics": {k: [a[k] for a, _ in rows] for k in terms},
            "step1": {"loss": abs(rows[0][0]["loss/total"] - rows[0][1]["loss/total"]),
                      "grad_norm": _rel(rows[0][0]["grad_norm"], rows[0][1]["grad_norm"]),
                      "records": max(_rel(a[4], b[4]) for a, b in zip(mine, theirs)
                                     if a[0] == first)},
            "param_maxdiff": maxdiff(whole.params, ref.state.params),
            "param_worst": worst,
            "loss_diff": max(abs(a - b) for a, b in zip(_losses(tr), _losses(ref))),
            "norm_reldiff": {k: max(_rel(a[k], b[k]) for a, b in rows) for k in NORM_KEYS},
            "record_reldiff": max(_rel(a[4], b[4]) for a, b in zip(mine, theirs)),
            "record_reldiff_by_leaf": _by_leaf(mine, theirs),
            "step1_by_leaf": _by_leaf(*zip(*[(a, b) for a, b in zip(mine, theirs)
                                             if a[0] == first])),
            "record_worst": max(zip(mine, theirs), key=lambda ab: _rel(ab[0][4], ab[1][4]))[0],
            "records": len(mine),
            "losses": _losses(ref)}


def _equiv(c: Ctx, scenario: str, variant: str, cfg, tc, blocks: bool = True) -> dict:
    """The sharded run against two single-process runs from the same state:
    ``same_blocks`` takes ``accum_steps × world`` micro-batches, so its
    micro-batches are the ranks' (the same rows, hence the same bf16
    gradients) and only the order of the fp32 batch reductions differs;
    ``same_config`` takes the run's own ``accum_steps``, whose micro-batches
    span the ranks' rows and round their bf16 gradients over other sums.
    Both record the global norms, the trust-ratio summary and the per-layer
    records (rank 0 alone writes the sharded run's).  The ``model`` ranks of
    one data coordinate take the same rows, so the micro-batches are the
    data-parallel ranks'; with one such rank the two references are one.
    Without ``blocks`` only ``same_config`` runs: an MoE's capacity and
    routing are the micro-batch's, so other micro-batches route otherwise."""
    # every step's norms and every layer's applied trust ratio are compared
    tc = dataclasses.replace(tc, log_trust_ratios=True, record_trust_ratios=True)
    model = build_model(cfg)
    state = initial_state(cfg, tc, c.init)
    refs = c.refs.get((cfg, tc, blocks), {})
    if c.rank0 and not refs:
        if blocks:
            refs["same_blocks"] = _single(
                model, dataclasses.replace(tc, accum_steps=tc.accum_steps * c.dp), state, cfg)
        refs["same_config"] = (refs["same_blocks"] if blocks and c.dp == 1
                               else _single(model, tc, state, cfg))
        c.refs[(cfg, tc, blocks)] = refs
    tr = _quiet(model, tc, c.mesh, telemetry=EventLog.memory())
    tr.place_state(state)
    tr.fit(DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows), STEPS)
    whole = tr.gather_state()
    if not c.rank0:
        return {}
    np.savez(os.path.join(c.out, f"{scenario}_{variant}.npz"),
             **{k: v.float().numpy() for k, v in whole.params.items()})
    out = {name: _diffs(tr, whole, ref) for name, ref in refs.items()}
    out.update(losses=_losses(tr), steps=int(tr.state.step))
    return out


def scenario_equiv(c: Ctx, name: str = "equiv") -> dict:
    return {v: _equiv(c, name, v, cfg, tc) for v, (cfg, tc) in variants()[name].items()}


def scenario_lans(c: Ctx) -> dict:
    return scenario_equiv(c, "lans")


def scenario_mlm_flash(c: Ctx) -> dict:
    return scenario_equiv(c, "mlm_flash")


def scenario_collectives(c: Ctx) -> dict:
    """Each collective on this rank's operand against its plain version over
    every rank's (all ranks draw every rank's operands from one seed)."""
    mesh = c.mesh
    n, r = mesh.size, mesh.rank
    group = mesh.group(("data",))
    gen = torch.Generator().manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        whole = torch.randn(4 * n, 2 * n, 3, generator=gen).to(dtype)
        for dim in (0, 1):
            shards = [C.shard_leaf(whole, dim, n, i) for i in range(n)]
            got = C.gather_leaf(shards[r], dim, group)
            out[f"gather_{dtype}_{dim}"] = bool(
                torch.equal(got, C.gather_leaf_plain(shards, dim)) and torch.equal(got, whole))
    for dim in (None, 0, 1, 2):
        grads = [torch.randn(2 * n, 3 * n, n, generator=gen) for _ in range(n)]
        got = C.scatter_grad(grads[r].clone(), dim, group)
        want = (C.scatter_grad_plain(grads, dim)[r] if dim is not None
                else torch.stack(grads).sum(0))
        out[f"scatter_{dim}"] = float((got - want).abs().max())
    for op in C.OPS:
        for dtype in (torch.float32, torch.int32):
            scale = 100 if dtype == torch.int32 else 1
            xs = [(torch.randn(5, generator=gen) * scale).to(dtype) for _ in range(n)]
            got = C.all_reduce(xs[r].clone(), op, group)
            out[f"all_reduce_{op}_{dtype}"] = float(
                (got.double() - C.all_reduce_plain(xs, op).double()).abs().max())
    return out if c.rank0 else {}


def scenario_stages(c: Ctx) -> dict:
    tc = CKPT_TC
    stages = [
        make_stage("s1", SEQ, 16, 2, base_lr=1e-3, base_batch=16, base_warmup_ratio=0.25),
        make_stage("s2", SEQ * 2, 8, 2, base_lr=1e-3, base_batch=16, base_warmup_ratio=0.25),
    ]
    model = build_model(TINY)
    tr = _quiet(model, tc, c.mesh)
    tr.fit_stages(stages)
    whole = tr.gather_state()
    if not c.rank0:
        return {}
    single = _quiet(model, tc)
    single.fit_stages(stages)
    return {
        "final_step": int(tr.state.step),
        "stages": [h["stage"] for h in tr.history],
        "finite": bool(np.isfinite(tr.history[-1]["loss/total"])),
        "param_maxdiff": maxdiff(whole.params, single.state.params),
        "loss_diff": max(abs(a - b) for a, b in zip(_losses(tr), _losses(single))),
    }


def scenario_memory(c: Ctx) -> dict:
    """Per-rank state bytes after a step; the run's telemetry, given to
    every rank, is written by rank 0 alone and records the mesh."""
    cfg = smoke_config("bert-large")
    tc = CKPT_TC
    model = build_model(cfg)
    log = EventLog.memory()
    tr = _quiet(model, tc, c.mesh, telemetry=log)
    tr.fit(DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows), 1)
    events = C.all_reduce(torch.tensor([len(log.events)]), "sum", c.mesh.group(("data",)))
    fsdp = (per_device_state_bytes(tr.state.params, c.mesh)
            + per_device_state_bytes(tr.state.opt_state, c.mesh))
    whole = tr.gather_state()
    base = per_device_state_bytes(whole.params) + per_device_state_bytes(whole.opt_state)
    if not c.rank0:
        return {}
    start = next(e for e in log.events if e["event"] == "run_start")
    return {"fsdp_per_rank_state_bytes": fsdp, "single_state_bytes": base,
            "state_ratio": base / max(fsdp, 1), "events_all_ranks": int(events),
            "events_rank0": len(log.events), "run_start_mesh": start["provenance"]["mesh"]}


def scenario_guards(c: Ctx) -> dict:
    n = c.mesh.size + 1   # rows that do not split over the ranks
    out = {}
    tr = _quiet(build_model(TINY), TrainConfig(optimizer="lamb"), c.mesh)
    tr.init()
    try:
        DataPipeline(TINY, n, SEQ, device="cpu", rows=tr.batch_rows)
        out["pipeline_raises"] = False
    except ValueError as e:
        out["pipeline_raises"], out["pipeline_msg"] = True, str(e)
    try:
        tr._place_batch({"tokens": np.zeros((n, SEQ), np.int32)})
        out["trainer_raises"] = False
    except ValueError as e:
        out["trainer_raises"], out["trainer_msg"] = True, str(e)
    rows = tr._place_batch({"tokens": np.arange(c.mesh.size * 2)[:, None]})["tokens"]
    out["rows_ok"] = rows[:, 0].tolist() == [2 * c.mesh.rank, 2 * c.mesh.rank + 1]
    flags = C.all_reduce(torch.tensor([int(all(v for k, v in out.items()
                                               if not k.endswith("_msg")))]),
                         "min", c.mesh.group(("data",)))
    out["every_rank"] = bool(flags.item())
    return out if c.rank0 else {}


def _drop_ordinal(data, drop: int):
    for i, batch in enumerate(data):
        if i != drop:
            yield batch


def scenario_nan_skip(c: Ctx, steps: int = 6, poison_at: int = 2) -> dict:
    """The last rank alone gets a NaN gradient at batch ``poison_at``: only
    the all-reduced verdict makes the other ranks skip it too."""
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True,
                     skip_nonfinite=True)
    model = build_model(TINY)
    tr = _quiet(model, tc, c.mesh)
    data = DataPipeline(TINY, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows)
    if c.mesh.rank == c.mesh.size - 1:
        data = FaultInjector([FaultSpec("grad_nan", at=poison_at)]).wrap(data)
    tr.fit(data, steps)
    clean = _quiet(model, tc, c.mesh)
    clean.fit(_drop_ordinal(DataPipeline(TINY, BATCH, SEQ, device="cpu", seed=0,
                                         rows=clean.batch_rows), poison_at), steps - 1)
    skipped = [C.all_reduce(tr.state.skipped.clone(), op, c.world) for op in ("min", "max")]
    a, b = tr.gather_state(), clean.gather_state()
    if not c.rank0:
        return {}
    return {
        "skipped": int(tr.state.skipped),
        "skipped_every_rank": [int(x) for x in skipped],
        "final_step": int(tr.state.step),
        "param_maxdiff": maxdiff(a.params, b.params),
        "moment_maxdiff": max(maxdiff(a.opt_state.mu, b.opt_state.mu),
                              maxdiff(a.opt_state.nu, b.opt_state.nu)),
        "steps_match": int(tr.state.step) == int(clean.state.step),
    }


def _ckpt_run(mesh, ckpt: str, *, accum: int = 1, **kw) -> Trainer:
    tc = dataclasses.replace(CKPT_TC, accum_steps=accum)
    tr = _quiet(build_model(TINY), tc, mesh, checkpoint_dir=ckpt,
                checkpoint_every=2, **kw)
    tr.fit(DataPipeline(TINY, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows), STEPS)
    return tr


def scenario_checkpoint(c: Ctx, restore: str = "", restore_mesh: str = "") -> dict:
    if not restore:   # the uninterrupted run on this mesh, saving at step 2
        ckpt = os.path.join(c.out, "ckpt")
        tr = _ckpt_run(c.mesh, ckpt)
        whole = tr.gather_state()
        if not c.rank0:
            return {}
        np.savez(os.path.join(c.out, "checkpoint_step3.npz"),
                 **{k: v.numpy() for k, v in whole.params.items()})
        with open(os.path.join(c.out, "checkpoint_dp.json"), "w") as f:
            json.dump({"dp": c.dp, "mesh": c.mesh.shape}, f)
        return {"saved": latest_checkpoint(ckpt), "losses": _losses(tr),
                "mesh": c.mesh.shape}
    if restore_mesh:   # the same ranks as another mesh
        c = Ctx(init_distributed("cpu", restore_mesh)[0], c.out, c.init)
    ckpt = os.path.join(restore, "ckpt")
    path = latest_checkpoint(ckpt)
    model = build_model(TINY)
    # what the save holds, read whole in this process
    init_fn, _ = make_train_step(model, CKPT_TC)
    saved = restore_checkpoint(path, init_fn(0, torch.device("cpu")))
    tr = _quiet(model, CKPT_TC, c.mesh)
    tr.restore(path)
    restored = tr.gather_state()
    # the resumed runs take the saving run's micro-batches (its
    # data-parallel ranks' rows), so only the order of the fp32 batch
    # reductions differs
    with open(os.path.join(restore, "checkpoint_dp.json")) as f:
        saved_world = json.load(f)["dp"]
    resumed = _ckpt_run(c.mesh, ckpt, accum=saved_world // c.dp, resume=True)
    after = resumed.gather_state()
    if not c.rank0:
        return {}
    with np.load(os.path.join(restore, "checkpoint_step3.npz")) as f:
        ref = {k: torch.from_numpy(f[k]) for k in f.files}
    one = _quiet(model, CKPT_TC)
    one.restore(path)
    one_resumed = _ckpt_run(None, ckpt, accum=saved_world, resume=True)

    def bit_equal(a: TrainState, b: TrainState) -> bool:
        return all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(tree_leaves_with_paths(a), tree_leaves_with_paths(b)))

    return {
        "path_step": int(path.rsplit("_", 1)[-1]),
        "mesh_restore_bitequal": bit_equal(restored, saved),
        "single_restore_bitequal": bit_equal(one.state, saved),
        "mesh_step3_maxdiff": maxdiff(after.params, ref),
        "single_step3_maxdiff": maxdiff(one_resumed.state.params, ref),
        "mesh_losses": _losses(resumed),
        "single_losses": _losses(one_resumed),
        "final_steps": [int(resumed.state.step), int(one_resumed.state.step)],
        "mesh": c.mesh.shape,
    }


def scenario_tp_collectives(c: Ctx) -> dict:
    """The ``model`` axis's operators on real ranks against their plain
    versions over every rank's operands (all ranks draw them from one
    seed): copy_to_model and reduce_from_model forward and backward in fp32
    and bf16, and a block of a leaf split over both axes gathered whole."""
    mesh = c.mesh
    m, r = mesh.shape["model"], mesh.coords()["model"]
    group = mesh.group(("model",))
    gen = torch.Generator().manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 8, generator=gen).to(dtype)
        scales = [torch.randn(3, 8, generator=gen).to(dtype) for _ in range(m)]
        mine = x.clone().requires_grad_()
        (C.copy_to_model(mine, group) * scales[r]).sum().backward()
        plain = x.clone().requires_grad_()
        sum((y * s).sum() for y, s in zip(C.copy_to_model_plain(plain, m), scales)).backward()
        out[f"copy_fwd_{dtype}"] = bool(torch.equal(C.copy_to_model(x, group), x))
        out[f"copy_bwd_{dtype}"] = float((mine.grad.float() - plain.grad.float()).abs().max())
        parts = [torch.randn(3, 8, generator=gen).to(dtype) for _ in range(m)]
        dy = torch.randn(3, 8, generator=gen).to(dtype)
        mine = parts[r].clone().requires_grad_()
        got = C.reduce_from_model(mine, group)
        got.backward(dy)
        plain = [p.clone().requires_grad_() for p in parts]
        want = C.reduce_from_model_plain(plain)
        want.backward(dy)
        out[f"reduce_fwd_{dtype}"] = float((got - want).detach().float().abs().max())
        out[f"reduce_bwd_{dtype}"] = bool(torch.equal(mine.grad, plain[r].grad))
    model = build_model(TINY)
    layouts = leaf_dims(specs_for(model.defs, mesh), mesh)
    whole = model.init(0, torch.device("cpu"))
    out["gather_block"] = all(
        torch.equal(C.gather_block(C.shard_block(v, layouts[k], mesh), layouts[k], mesh), v)
        for k, v in whole.items())
    out["split_both"] = sum(lay.data is not None and lay.model is not None
                            for lay in layouts.values())
    return out if c.rank0 else {}


def scenario_tp_equiv(c: Ctx) -> dict:
    return {v: _equiv(c, "tp", v, cfg, tc) for v, (cfg, tc) in tp_variants().items()}


# the parameter rules of ``tp_layout``: ``embed`` split over data and model
# together, so that q/k/v are stored cut along embed with their heads whole
# and the output projection along heads over model and embed over data
LAYOUT_RULES = ("embed=data,model",)


def scenario_tp_layout(c: Ctx) -> dict:
    """``mlm_fused_ce_f32`` (bert-smoke, fp32 activations, fused LAMB) stored
    under ``LAYOUT_RULES`` against the same run under the default rules:
    each run's losses and each leaf's largest difference and value; each
    rank's blocks of the params and moments under ``LAYOUT_RULES``
    (``tp_layout_rank<r>.npz``) and the whole state they gather to
    (``tp_layout_whole.npz``), for the test to cut by the reference's
    ``resolve_spec``."""
    from repro_torch.sharding import default_param_rules, override_rules

    cfg, tc = tp_variants()["mlm_fused_ce_f32"]
    model = build_model(cfg)
    state = initial_state(cfg, tc, c.init)
    rules = override_rules(default_param_rules(multi_pod="pod" in c.mesh.shape), LAYOUT_RULES)
    runs = {}
    for name, param_rules in (("default", None), ("rules", rules)):
        tr = _quiet(model, tc, c.mesh, param_rules=param_rules)
        tr.place_state(_clone(state))
        tr.fit(DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows), STEPS)
        runs[name] = tr
    tr = runs["rules"]
    blocks = {p: x.float().numpy() for p, x in tree_leaves_with_paths(tr.state)
              if isinstance(x, torch.Tensor) and x.is_floating_point()}
    np.savez(os.path.join(c.out, f"tp_layout_rank{c.mesh.rank}.npz"), **blocks)
    whole = {name: r.gather_state() for name, r in runs.items()}
    if not c.rank0:
        return {}
    np.savez(os.path.join(c.out, "tp_layout_whole.npz"),
             **{p: x.float().numpy() for p, x in tree_leaves_with_paths(whole["rules"])
                if p in blocks})
    a, b = whole["rules"].params, whole["default"].params
    return {"losses": {name: _losses(r) for name, r in runs.items()},
            "leaf_diff": {k: [float((a[k] - b[k]).abs().max()), float(b[k].abs().max())]
                          for k in b},
            "stored": {k: list(x.shape) for k, x in tr.state.params.items()}}


def scenario_tp_planted(c: Ctx) -> dict:
    """Two dropped model-axis reductions.  ``norms``: ``equiv_fused_f32``
    with every norm's all-reduce over the data-parallel group alone, so the
    model ranks' partials never meet.  ``copy``: the bf16 runs
    ``equiv_fused`` and ``mlm_dense_head`` with the column-parallel
    products' input-gradient sum dropped, so each rank keeps its partial."""
    from unittest import mock

    from repro_torch.models.layers import tensor_parallel as tp

    runs = tp_variants()
    with mock.patch.object(ShardCtx, "world_group", ShardCtx.dp_group):
        out = {"norms": _equiv(c, "tp_planted", "equiv_fused_f32", *runs["equiv_fused_f32"])}
    column = tp._Column.backward

    def partial_only(ctx, g):
        with mock.patch.object(tp, "all_reduce", lambda x, op, group: x):
            return column(ctx, g)

    with mock.patch.object(tp._Column, "backward", staticmethod(partial_only)):
        out["copy"] = {v: _equiv(c, "tp_planted", v, *runs[v])
                       for v in ("equiv_fused", "mlm_dense_head")}
    return out


def scenario_host_collectives(c: Ctx) -> dict:
    """The host group's helpers and ``sum_across`` on real ranks against
    their plain versions over every rank's operands (one seed on all)."""
    mesh, host = c.mesh, c.mesh.host_group
    n, r = mesh.size, mesh.rank
    flags = [0] * n
    flags[n - 1] = 15
    out = {"agree_any_one": C.agree_any(flags[r], host) == C.agree_any_plain(flags)[r],
           "agree_any_none": C.agree_any(0, host) == C.agree_any_plain([0] * n)[r]}
    xs = [7 * i + 3 for i in range(n)]
    out["broadcast_int"] = C.broadcast_int(xs[r], host) == C.broadcast_int_plain(xs)[r]
    C.barrier(host)
    out["barrier"] = C.barrier_plain([True] * n)
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(6, generator=gen) for _ in range(n)]
    dy = torch.randn(6, generator=gen)
    mine = parts[r].clone().requires_grad_()
    got = C.sum_across(mine, c.world)
    (got * dy).sum().backward()
    plain = [p.clone().requires_grad_() for p in parts]
    # every rank's share of the loss: each rank's copy of the sum, weighted
    sum((C.sum_across_plain(plain) * dy).sum() for _ in range(n)).backward()
    out["sum_across_fwd"] = float((got - C.sum_across_plain(parts)).detach().abs().max())
    out["sum_across_bwd"] = float((mine.grad - plain[r].grad).abs().max())
    ok = C.agree_any(0 if all(v is True or (not isinstance(v, bool) and v < 1e-5)
                              for v in out.values()) else 1, host)
    out["every_rank"] = ok == 0
    return out if c.rank0 else {}


SPIKE_TC = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True)


def spike_run(mesh, ckpt: str, steps: int = 10, every: int = 2, spike_at: int = 5,
              accum: int = 1, init: str = "") -> Trainer:
    """The reference's ``spike_rollback`` on the port: TINY with a x100 loss
    spike injected at batch ``spike_at``, checkpoints every ``every``
    batches, the supervisor on (window 8, 3 losses of history)."""
    tc = dataclasses.replace(SPIKE_TC, accum_steps=accum)
    model = build_model(TINY)
    inj = FaultInjector([FaultSpec("loss_spike", at=spike_at, scale=100.0)])

    def make_data():
        return inj.wrap(DataPipeline(TINY, BATCH, SEQ, device="cpu", seed=0,
                                     rows=tr.batch_rows))

    tr = _quiet(model, tc, mesh, checkpoint_dir=ckpt, checkpoint_every=every,
                supervisor=SupervisorConfig(spike_window=8, min_history=3),
                telemetry=EventLog.memory())
    tr.place_state(initial_state(TINY, tc, init))
    tr.fit(make_data(), steps, data_factory=make_data)
    return tr


def _events(tr, kind: str, keys) -> list:
    return [{k: e.get(k) for k in keys} for e in tr.telemetry.events if e["event"] == kind]


ROLLBACK_KEYS = ("reason", "step", "from_step", "batches_dropped", "rollbacks")
RUN_END_KEYS = ("status", "final_step", "rollbacks")


def scenario_spike_rollback(c: Ctx) -> dict:
    """The rollback on the mesh and in one process (rank 0; ``accum_steps``
    = the data-parallel size, so its micro-batches are the ranks'): the
    trip on every rank (the final steps all-reduced), only rank 0 writing
    (its directory, and the other ranks' events), the events, the final
    step and status, and the params."""
    from unittest import mock

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.train import trainer as trainer_mod

    ckpt = os.path.join(c.out, "spike_ckpt")
    calls = {"latest": 0, "discard": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    with mock.patch.object(ckpt_io, "_write_latest", counted("latest", ckpt_io._write_latest)), \
            mock.patch.object(trainer_mod, "discard_checkpoints_after",
                              counted("discard", trainer_mod.discard_checkpoints_after)):
        tr = spike_run(c.mesh, ckpt, init=c.init)
    # every rank's counts: which ranks wrote LATEST and discarded
    mine = torch.zeros(2, c.mesh.size, dtype=torch.int64)
    mine[:, c.mesh.rank] = torch.tensor([calls["latest"], calls["discard"]])
    by_rank = C.all_reduce(mine, "sum", c.world).tolist()
    whole = tr.gather_state()
    steps = [int(C.all_reduce(tr.state.step.clone(), op, c.world)) for op in ("min", "max")]
    others = int(C.all_reduce(torch.tensor([0 if c.rank0 else len(tr.telemetry.events)]),
                              "sum", c.world))
    if not c.rank0:
        return {}
    one = spike_run(None, os.path.join(c.out, "spike_ckpt_single"), accum=c.dp, init=c.init)
    np.savez(os.path.join(c.out, "spike_rollback.npz"),
             **{k: v.numpy() for k, v in whole.params.items()})
    return {
        "rollback": _events(tr, "rollback", ROLLBACK_KEYS),
        "run_end": _events(tr, "run_end", RUN_END_KEYS),
        "single_rollback": _events(one, "rollback", ROLLBACK_KEYS),
        "single_run_end": _events(one, "run_end", RUN_END_KEYS),
        "final_steps": steps,
        "losses": _losses(tr),
        "single_losses": _losses(one),
        "param_maxdiff": maxdiff(whole.params, one.state.params),
        "events_other_ranks": others,
        "latest_writes_by_rank": by_rank[0],
        "discards_by_rank": by_rank[1],
        "checkpoints": sorted(n for n in os.listdir(ckpt) if n.startswith("step_")),
        "latest": open(os.path.join(ckpt, "LATEST")).read().strip(),
    }


# ---------------------------------------------------------------------------
# the model axis's GQA, MoE over data ranks
# ---------------------------------------------------------------------------

GQA_STRADDLE = ModelConfig(
    name="gqa-straddle", family="dense", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=384, tie_embeddings=True,
    use_flash_kernel=True,
)


def gqa_variants():
    """``{variant: (config, TrainConfig)}``: smollm-smoke (MQA: 3 heads, one
    kv head, dense attention) and the straddling config (flash), fused
    LAMB, in fp32 activations and in bf16."""
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True)
    bf16 = dataclasses.replace(tc, precision="bf16")
    out = {}
    for name, cfg in (("smollm", smoke_config("smollm-360m")), ("straddle", GQA_STRADDLE)):
        out[f"{name}_f32"] = (cfg.replace(activation_dtype="float32"), tc)
        out[f"{name}_bf16"] = (cfg, bf16)
    return out


def scenario_gqa(c: Ctx) -> dict:
    """Each run against the single process; the fp32 runs again with the
    kv heads' gradient left as each rank's partial (the sum over ``model``
    dropped), which must fail the bound."""
    from unittest import mock

    from repro_torch.models.layers import tensor_parallel as tp

    out = {v: _equiv(c, "gqa", v, cfg, tc) for v, (cfg, tc) in gqa_variants().items()}

    def partial_only(ctx, g):
        with mock.patch.object(tp, "all_reduce", lambda x, op, group: x):
            return kv_backward(ctx, g)

    kv_backward = tp._KvHeads.backward
    with mock.patch.object(tp._KvHeads, "backward", staticmethod(partial_only)):
        out["planted"] = {v: _equiv(c, "gqa_planted", v, *gqa_variants()[v])
                          for v in ("smollm_f32", "straddle_f32")}
    return out


def moe_config(arch: str = "granite-moe-1b-a400m"):
    """``arch``'s smoke config in fp32 activations with a capacity that
    drops tokens, and the router z-loss on."""
    return smoke_config(arch).replace(
        activation_dtype="float32", capacity_factor=0.5, router_z_coef=1e-3)


MOE_KEYS = ("loss/total", "loss/moe_lb", "moe/drop_fraction", "loss/moe_z")
# the other MoE families over data ranks: deepseek (MLA, a dense prefix,
# MTP) and jamba (Mamba and attention layers, MoE every other layer)
MOE_FAMILIES = {"deepseek": "deepseek-v3-671b", "jamba": "jamba-1.5-large-398b"}


def masked_batches(batches, blocks: int, accum: int):
    """Each global batch with half the labels of the last of the
    ``blocks`` data blocks of each of its ``accum`` micro-batches set
    IGNORE: that rank's supervised count is half each other rank's."""
    micro = BATCH // accum
    last = [j for j in range(BATCH) if (j % micro) // (micro // blocks) == blocks - 1]
    for b in batches:
        labels = b["labels"].clone()
        labels[last, SEQ // 2:] = IGNORE
        yield dict(b, labels=labels)


def _moe_run(c: Ctx, accum: int, mesh, arch: str, masked: bool) -> Trainer:
    cfg = moe_config(arch)
    tc = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True,
                     accum_steps=accum)
    model = build_model(cfg)
    tr = _quiet(model, tc, mesh)
    tr.place_state(initial_state(cfg, tc, c.init))
    if masked:   # the same global batches in both runs, then this rank's rows
        data = map(tr._place_batch, masked_batches(
            DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0), c.dp, accum))
    else:
        data = DataPipeline(cfg, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows)
    tr.fit(data, STEPS)
    return tr


def _moe_entry(c: Ctx, accum: int, tag: str, arch: str = "granite-moe-1b-a400m",
               masked: bool = False) -> dict:
    tr = _moe_run(c, accum, c.mesh, arch, masked)
    whole = tr.gather_state()
    if not c.rank0:
        return {}
    np.savez(os.path.join(c.out, f"moe_{tag}.npz"),
             **{k: v.numpy() for k, v in whole.params.items()})
    one = _moe_run(c, accum, None, arch, masked)
    rows = list(zip(tr.history, one.history))
    return {"metrics": {k: [h[k] for h in tr.history] for k in MOE_KEYS},
            "single": {k: [h[k] for h in one.history] for k in MOE_KEYS},
            "supervised": [h["tokens/supervised"] for h in tr.history],
            "metric_diff": {k: max(abs(a[k] - b[k]) for a, b in rows) for k in MOE_KEYS},
            "param_maxdiff": maxdiff(whole.params, one.state.params)}


def _post_scaled(grad):
    """``torch.autograd.grad`` that scales the gradients by a scalar seed
    after the backward pass instead of starting it there."""
    def call(outputs, inputs, grad_outputs=None, **kw):
        if grad_outputs is None or grad_outputs.dim():
            return grad(outputs, inputs, grad_outputs=grad_outputs, **kw)
        return tuple(grad_outputs * g for g in grad(outputs, inputs, **kw))
    return call


def scenario_moe_data(c: Ctx) -> dict:
    """granite-moe at accum 1 and 2, deepseek and jamba at accum 2, and
    granite at accum 2 with unequal supervised counts over the ranks; then
    accum 2 under each plant."""
    from unittest import mock

    from repro_torch.models.layers import moe

    out = {f"accum{a}": _moe_entry(c, a, f"accum{a}") for a in (1, 2)}
    out.update({name: _moe_entry(c, 2, name, arch) for name, arch in MOE_FAMILIES.items()})
    out["masked"] = _moe_entry(c, 2, "masked", masked=True)
    plants = {
        "local_capacity": (moe, "global_tokens", lambda t, dp: t),
        "local_offsets": (moe, "rank_offsets", lambda counts, dp: torch.zeros_like(counts)),
        "local_lb": (moe, "global_sum", lambda x, dp: x * (1 if dp is None else dp.size)),
    }
    out["planted"] = {}
    for name, (mod, attr, fn) in plants.items():
        with mock.patch.object(mod, attr, fn):
            out["planted"][name] = _moe_entry(c, 2, f"planted_{name}")
    # each rank's backward at weight 1, scaled by its own count after: the
    # router's global terms then reach the ranks at 2·w_r, not Σ_r w_r
    with mock.patch.object(torch.autograd, "grad", _post_scaled(torch.autograd.grad)):
        out["planted"]["post_scaled"] = _moe_entry(c, 2, "planted_post_scaled", masked=True)
    return out if c.rank0 else {}


# ---------------------------------------------------------------------------
# the rest of the model axis: expert parallelism, the inner axis, MLA heads
# ---------------------------------------------------------------------------

FUSED_LAMB = TrainConfig(optimizer="lamb", learning_rate=1e-3, use_fused_lamb=True)


def ep_variants(dp: int):
    """``{variant: (config, TrainConfig)}``: granite-moe-smoke with a capacity
    that drops tokens and the z-loss (:func:`moe_config`), fused LAMB, in
    fp32 activations at accum 1 and 2, and in bf16 at accum 2; over more
    than one data rank accum 2 in fp32 alone (bf16 rows that the ranks
    split round over other sums, and the micro-batch routes as a whole),
    with jamba-smoke (Mamba's ``inner``, GQA heads) and deepseek-smoke with
    MTP (MLA heads) under the same config changes beside it."""
    tc = FUSED_LAMB
    if dp > 1:   # and the MoE archs of the recurrent and MLA families
        accum2 = dataclasses.replace(tc, accum_steps=2)
        return {"accum2_f32": (moe_config(), accum2),
                "jamba_f32": (moe_config("jamba-1.5-large-398b"), accum2),
                "deepseek_naive_f32": (moe_config("deepseek-v3-671b").replace(use_mtp=True),
                                       accum2)}
    out = {f"accum{a}_f32": (moe_config(), dataclasses.replace(tc, accum_steps=a))
           for a in (1, 2)}
    out["accum2_bf16"] = (moe_config().replace(activation_dtype="bfloat16"),
                          dataclasses.replace(tc, accum_steps=2, precision="bf16"))
    return out


class _SummingGather(torch.autograd.Function):
    """``gather_from_model`` with a backward that sums the ranks' whole
    gradients before taking the rank's slice (a plant)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return C.gather_leaf(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return C.scatter_grad(g.contiguous(), ctx.dim, ctx.group), None, None


def _planted(c: Ctx, scenario: str, variant, cfg, tc, patches, blocks=True) -> dict:
    from unittest import mock

    with contextlib.ExitStack() as stack:
        for mod, attr, fn in patches:
            stack.enter_context(mock.patch.object(mod, attr, fn))
        return _equiv(c, scenario, variant, cfg, tc, blocks)


def scenario_ep(c: Ctx) -> dict:
    """Expert parallelism: each variant against the single process on its
    own micro-batches; then ``accum2_f32`` with the gates' and the tokens'
    gradients left partial (``copy_to_model`` dropped) and with the logits
    gather's backward summing the ranks' whole gradients (the router's
    terms counted once a rank)."""
    from repro_torch.models.layers import moe

    runs = ep_variants(c.dp)
    out = {v: _equiv(c, "ep", v, cfg, tc, blocks=False) for v, (cfg, tc) in runs.items()}
    plants = {
        "unsummed_grads": [(moe, "copy_to_model", lambda x, group: x)],
        "summing_gather": [(moe, "gather_from_model",
                            lambda x, dim, group: _SummingGather.apply(x, dim % x.dim(), group))],
    }
    if c.dp == 1:
        out["planted"] = {name: _planted(c, f"ep_planted_{name}", "accum2_f32",
                                         *runs["accum2_f32"], patches, blocks=False)
                          for name, patches in plants.items()}
    return out if c.rank0 else {}


def recurrent_mla_variants(dp: int):
    """``{variant: (config, TrainConfig)}``: xlstm-smoke (fp32 and bf16
    activations), and at one data rank jamba-smoke (Mamba's ``inner``, GQA
    4/2 heads and expert parallelism together) and deepseek-smoke with MTP,
    naive and absorbed, in fp32 activations (the MoE ones with a capacity
    that drops tokens and the z-loss), fused LAMB at accum 2."""
    tc = dataclasses.replace(FUSED_LAMB, accum_steps=2)
    f32 = dict(activation_dtype="float32")
    out = {"xlstm_f32": (smoke_config("xlstm-350m").replace(**f32), tc),
           "xlstm_bf16": (smoke_config("xlstm-350m"), dataclasses.replace(tc, precision="bf16"))}
    if dp == 1:
        out["jamba_f32"] = (moe_config("jamba-1.5-large-398b"), tc)
        for name, absorb in (("naive", False), ("absorbed", True)):
            out[f"deepseek_{name}_f32"] = (moe_config("deepseek-v3-671b").replace(
                use_mtp=True, mla_absorb=absorb), tc)
    return out


def scenario_recurrent_mla(c: Ctx) -> dict:
    """The xLSTM/Mamba ``inner`` axis and MLA heads: each variant against
    the single process; then, at one data rank, the mLSTM's RMS with its
    sum of squares over ``model`` dropped, the xLSTM and jamba ranks
    computing on their stored up-projection block as if it were their
    slices of x and z, and deepseek's MLA with the latents' gradients left
    partial (planted)."""
    from repro_torch.models.layers import mamba, mla, xlstm

    runs = recurrent_mla_variants(c.dp)
    out = {v: _equiv(c, "recurrent_mla", v, cfg, tc) for v, (cfg, tc) in runs.items()}
    if c.dp == 1:
        stored = lambda w, half, tp: w   # noqa: E731
        plants = {
            "rms_local": ("xlstm_f32", [(xlstm, "sum_across", lambda x, group: x)]),
            "stored_block": ("xlstm_f32", [(xlstm, "paired_columns", stored)]),
            "stored_block_mamba": ("jamba_f32", [(mamba, "paired_columns", stored)]),
            "mla_unsummed": ("deepseek_naive_f32", [(mla, "copy_to_model", lambda x, group: x)]),
        }
        out["planted"] = {name: _planted(c, f"recurrent_mla_planted_{name}", v, *runs[v],
                                         patches)
                          for name, (v, patches) in plants.items()}
    return out if c.rank0 else {}


SERVE_ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "xlstm-350m")
SERVE_SEQ_SPLIT = ("smollm-360m", "jamba-1.5-large-398b")   # batch 1, cache_seq over data
SERVE_LENS, SERVE_NEW, SERVE_MAX_LEN = (8, 5, 8, 6), 6, 16
SERVE_B1_LEN = 7   # at max_len 16 over data=2: the decode crosses into rank 1's block


def serve_config(arch: str) -> ModelConfig:
    return smoke_config(arch).replace(activation_dtype="float32")


def serve_prompts(cfg, lens=SERVE_LENS, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lens]


def _serve_params(model, init: str):
    """The port's seed-0 parameters, replaced by ``init/<name>.npz`` (the
    JAX package's) where the test wrote one."""
    params = model.init(0, torch.device("cpu"))
    path = os.path.join(init, f"{model.cfg.name}.npz") if init else ""
    if path and os.path.exists(path):
        with np.load(path) as f:
            for k, v in params.items():
                v.copy_(torch.from_numpy(f[k]).to(v.dtype))
    return params


def _tokens(engine, prompts, temperature: float = 0.0) -> list:
    from repro_torch.serve import Request

    out = engine.generate_batch([Request(p, max_new_tokens=SERVE_NEW, temperature=temperature)
                                 for p in prompts])
    return [r.out_tokens.tolist() for r in out]


def scenario_serve(c: Ctx) -> dict:
    """The static ``Engine(shard_ctx=)`` over this mesh for each of
    :data:`SERVE_ARCHS` (fp32 activations): greedy tokens of four ragged
    prompts, the prefill's and first decode step's gathered logits (the
    greedy tokens teacher-forced), a seeded temperature run, and, over two
    data ranks, :data:`SERVE_SEQ_SPLIT` at batch 1 under the dry-run's rules
    (the cache's sequence over data, Mamba's state over ``inner``).  Every
    rank checks that its cache is its block's bytes and its tokens are rank
    0's; rank 0 runs the single-process Engine beside it and reports
    both."""
    from repro_torch.launch.dryrun import dryrun_rules
    from repro_torch.serve import Engine
    from repro_torch.sharding import cache_block

    out = {}
    for arch in SERVE_ARCHS:
        cfg = serve_config(arch)
        model = build_model(cfg)
        params = _serve_params(model, c.init)
        prompts = serve_prompts(cfg)
        runs = {"greedy": (ShardCtx(c.mesh), prompts, 0.0),
                "temperature": (ShardCtx(c.mesh), prompts, 0.8)}
        if arch in SERVE_SEQ_SPLIT and c.dp == 2:
            rules, _ = dryrun_rules(c.mesh)
            runs["batch1_seq_split"] = (ShardCtx(c.mesh, rules),
                                        serve_prompts(cfg, (SERVE_B1_LEN,), seed=1), 0.0)
        entry = {}
        for name, (ctx, ps, temp) in runs.items():
            eng = Engine(model, params, max_len=SERVE_MAX_LEN, shard_ctx=ctx, seed=3)
            mesh_tokens = _tokens(eng, ps, temp)
            meta = model.make_cache(len(ps), SERVE_MAX_LEN, "meta")
            block = sum(x.numel() * x.element_size() for _, x in tree_leaves_with_paths(
                cache_block(meta, c.mesh, ctx.act_rules, "meta")))
            if eng.cache_bytes != block:
                raise AssertionError(f"{arch} {name}: rank {c.mesh.rank} holds "
                                     f"{eng.cache_bytes} cache bytes, its block {block}")
            every = [None] * c.mesh.size
            torch.distributed.all_gather_object(every, mesh_tokens)
            if any(t != mesh_tokens for t in every):
                raise AssertionError(f"{arch} {name}: the ranks' tokens differ: {every}")
            row = {"mesh": mesh_tokens, "cache_bytes": block,
                   "whole_cache_bytes": sum(x.numel() * x.element_size()
                                            for _, x in tree_leaves_with_paths(meta))}
            if name == "greedy":
                forced = np.asarray([t[:1] for t in mesh_tokens], np.int32)
                width = max(len(p) for p in ps)
                padded = np.stack([np.pad(p, (0, width - len(p))) for p in ps])
                logits = eng.replay(padded, forced)
            if c.rank0:
                single = Engine(model, params, max_len=SERVE_MAX_LEN, seed=3)
                row["single"] = _tokens(single, ps, temp)
                if name == "greedy":
                    want = single.replay(padded, forced)
                    row["logits_rel"] = float((logits - want).abs().max()
                                              / max(1.0, float(want.abs().max())))
            entry[name] = row
        out[arch] = entry
    return out if c.rank0 else {}


# ContinuousEngine(shard_ctx=): six requests through four slots (admissions
# mid-decode, so the slots' positions differ), every arrival at 0 so that
# the slots alone decide the batch's make-up; three slots, which two data
# ranks do not divide (every rank holds every slot); one slot under
# cache_seq over data, two requests in turn.  One prompt length a case: the
# JAX engine compiles its prefill once for each
CONT_LENS, CONT_NEW = (8,) * 6, (6, 3, 5, 6, 2, 4)
CONT_SLOTS, CONT_ROWS_WHOLE = 4, 3
CONT_ROWS_WHOLE_ARCHS = ("granite-moe-1b-a400m",)   # the MoE: rows couple
# both requests cross into rank 1's block
CONT_B1_LENS, CONT_B1_NEW = (SERVE_B1_LEN,) * 2, (6, 3)
# faults on smollm-smoke: a NaN sample (rid 1), a corrupted slot (rid 2,
# quarantined 2 steps) and a stall at step 2 past the watchdog's SLO, whose
# degraded mode caps later admissions at 2 new tokens and never recovers;
# the SLO stands far past a step of a loaded host (a few ms here)
CONT_FAULTS = (("sample_nan", 1, 0.0), ("slot_corrupt", 2, 0.0), ("decode_stall", 2, 1.5))
CONT_SLO = 1.0
# a stall on rank 1's injector alone at step 1, inside which request 0's
# latency budget ends (the steps before it take far less); and rank 1's
# drain flag alone, up from its 3rd poll
SKEW_STALL, SKEW_TIMEOUT, DRAIN_POLL = 1.5, 1.0, 3
# the fields of a lifecycle event that read the wall clock
WALL_FIELDS = ("seq", "t", "ttft_s", "latency_s", "step_s")
STATS_KEYS = ("submitted", "completed", "shed", "timed_out", "failed", "retries",
              "quarantines", "drained", "degraded", "decode_steps")


def continuous_specs(cfg, lens=CONT_LENS, news=CONT_NEW, seed: int = 2) -> list:
    """``[(prompt, max_new_tokens)]`` of a continuous run, rid its index."""
    return list(zip(serve_prompts(cfg, lens, seed), news))


def lifecycle(events) -> list:
    """A log's events without their wall-clock fields; ``serve_stats`` its
    counts alone."""
    out = []
    for ev in events:
        keep = {k: v for k, v in ev.items() if k not in WALL_FIELDS}
        if ev["event"] == "serve_stats":
            keep = {"event": "serve_stats", **{k: ev[k] for k in STATS_KEYS}}
        out.append(keep)
    return out


def _cont_run(model, params, specs, mesh=None, rules=None, slots=CONT_SLOTS, faults=(),
              timeouts=None, drain_at=None, log=None, **kw):
    """``(engine, outcome)``: ``ContinuousEngine`` over ``mesh`` (None: one
    process) on ``specs``, each request's tokens, status, attempts and
    reason in the outcome."""
    import itertools

    from repro_torch.serve import ContinuousEngine, ServeFaultInjector, ServeFaultSpec, \
        ServeRequest

    ctx = None if mesh is None else ShardCtx(mesh).with_rules(**(rules or {}))
    inj = ServeFaultInjector([ServeFaultSpec(k, at, stall_s=st) for k, at, st in faults])
    eng = ContinuousEngine(model, params, n_slots=slots, max_len=SERVE_MAX_LEN, shard_ctx=ctx,
                           seed=3, faults=inj if faults else None, telemetry=log, **kw)
    reqs = [ServeRequest(p, max_new_tokens=n, rid=i, timeout_s=(timeouts or {}).get(i))
            for i, (p, n) in enumerate(specs)]
    polls = itertools.count(1)
    drain = None if drain_at is None else (lambda: next(polls) >= drain_at)
    out = eng.generate(reqs, should_drain=drain, drain_grace_s=0.0)
    return eng, [dict(tokens=[int(t) for t in r.out_tokens], status=r.status.value,
                      attempts=r.attempts, reason=r.shed_reason or r.fail_reason)
                 for r in out]


def _every_rank_alike(label: str, value) -> None:
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, value)
    if any(v != every[0] for v in every):
        raise AssertionError(f"{label}: the ranks differ: {every}")


def _pool_block_bytes(model, mesh, rules, slots: int) -> tuple:
    """(this rank's block of a pool of ``slots`` under ``rules``, the whole
    pool): every leaf's bytes, the widened index whole on every rank."""
    from repro_torch.sharding import cache_block

    meta = model.make_cache(slots, SERVE_MAX_LEN, "meta")

    def size(tree):
        return sum(x.numel() * x.element_size() * (slots if p.endswith("/index") else 1)
                   for p, x in tree_leaves_with_paths(tree))

    return size(cache_block(meta, mesh, rules, "meta")), size(meta)


def scenario_continuous(c: Ctx) -> dict:
    """``ContinuousEngine(shard_ctx=)`` over this mesh (fp32 activations):
    each of :data:`SERVE_ARCHS` greedy through :data:`CONT_SLOTS` slots,
    and over two data ranks :data:`CONT_ROWS_WHOLE_ARCHS` through three
    slots (rows whole on every rank) and :data:`SERVE_SEQ_SPLIT` through one
    slot under ``cache_seq`` over data; then on smollm-smoke the faults, the
    skewed stall and the one-rank drain flag.  Every rank checks that its
    outcome equals rank 0's and its pool is its block's bytes (the rows of
    slots each holds are reported); over two data ranks, where every case
    runs, rank 0 runs the single-process engine beside each and reports
    both."""
    from repro_torch.telemetry import EventLog

    mesh, r = c.mesh, c.mesh.rank
    readings = (0.25 * (r + 1), r == 1, 0.5 * (r + 1))
    every = [None] * mesh.size
    torch.distributed.all_gather_object(every, readings)
    out = {"agree_clock": list(C.agree_clock(*readings, mesh.host_group))
           == list(C.agree_clock_plain(every)[r])}
    _every_rank_alike("agree_clock", out["agree_clock"])

    built = {}

    def case(label, arch, specs, rules=None, slots=CONT_SLOTS, single=None, rank=None,
             single_first=False, **kw):
        """One run on every rank (``kw`` its engine's arguments, ``rank``
        a rank's own on top) and over two data ranks rank 0's single
        process (``single``'s, default ``kw``; with ``single_first`` before
        the mesh's run)."""
        if arch not in built:
            model = build_model(serve_config(arch))
            built[arch] = model, _serve_params(model, c.init)
        model, params = built[arch]
        alone = c.rank0 and c.dp == 2

        def one_process():
            return _cont_run(model, params, specs, slots=slots,
                             **(kw if single is None else single))[1]

        first = one_process() if alone and single_first else None
        eng, got = _cont_run(model, params, specs, mesh, rules, slots,
                             **dict(kw, **(rank or {}).get(r, {})))
        _every_rank_alike(f"{arch} {label} outcome", got)
        rows = [None] * mesh.size
        torch.distributed.all_gather_object(rows, eng.pool.rows)
        block, whole = _pool_block_bytes(model, mesh, eng.pool.ctx.act_rules, slots)
        if eng.pool.nbytes != block:
            raise AssertionError(f"{arch} {label}: rank {r}'s pool holds {eng.pool.nbytes} "
                                 f"bytes, its block {block}")
        row = {"mesh": got, "rows": rows, "pool_bytes": block,
               "whole_pool_bytes": whole, "agreements": eng.agreements}
        if alone:
            row["single"] = first if single_first else one_process()
        return eng, row

    for arch in SERVE_ARCHS:
        cfg = serve_config(arch)
        entry = {"greedy": case("greedy", arch, continuous_specs(cfg))[1]}
        if c.dp == 2 and arch in CONT_ROWS_WHOLE_ARCHS:
            entry["rows_whole"] = case("rows_whole", arch, continuous_specs(cfg),
                                       slots=CONT_ROWS_WHOLE)[1]
        if c.dp == 2 and arch in SERVE_SEQ_SPLIT:
            entry["seq_split"] = case("seq_split", arch,
                                      continuous_specs(cfg, CONT_B1_LENS, CONT_B1_NEW, seed=1),
                                      rules={"cache_seq": ("data",)}, slots=1)[1]
        out[arch] = entry
    if c.dp != 2:
        return out if c.rank0 else {}

    arch = "smollm-360m"
    specs = continuous_specs(serve_config(arch))
    path = os.path.join(c.out, f"continuous_events_rank{r}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    single_log = EventLog.memory()
    eng, row = case("faults", arch, specs, faults=CONT_FAULTS, stall_slo_s=CONT_SLO,
                    degrade_max_new_tokens=2, degrade_recovery_steps=100, quarantine_steps=2,
                    log=EventLog(path), single=dict(faults=CONT_FAULTS, stall_slo_s=CONT_SLO,
                                                    degrade_max_new_tokens=2,
                                                    degrade_recovery_steps=100,
                                                    quarantine_steps=2, log=single_log))
    eng.telemetry.close()
    events = (read_events(path) if r == 0 else eng.telemetry.events)
    _every_rank_alike("faults: event kinds and rids", [(e["event"], e.get("rid")) for e in events])
    wrote = [None] * mesh.size
    torch.distributed.all_gather_object(wrote, os.path.exists(path))
    row["wrote"] = wrote
    if c.rank0:
        row["events"], row["single_events"] = lifecycle(events), lifecycle(single_log.events)
    out["faults"] = row
    skew = (("decode_stall", 1, SKEW_STALL),)
    out["skewed"] = case("skewed", arch, specs[:4], single_first=True,
                         timeouts={0: SKEW_TIMEOUT}, rank={1: {"faults": skew}},
                         single=dict(faults=skew, timeouts={0: SKEW_TIMEOUT}))[1]
    out["drain"] = case("drain", arch, specs, rank={1: {"drain_at": DRAIN_POLL}},
                        single=dict(drain_at=DRAIN_POLL))[1]
    return out if c.rank0 else {}


SCENARIOS = {
    "collectives": scenario_collectives,
    "equiv": scenario_equiv,
    "lans": scenario_lans,
    "mlm_flash": scenario_mlm_flash,
    "stages": scenario_stages,
    "memory": scenario_memory,
    "guards": scenario_guards,
    "nan_skip": scenario_nan_skip,
    "checkpoint": scenario_checkpoint,
    "tp_collectives": scenario_tp_collectives,
    "tp_equiv": scenario_tp_equiv,
    "tp_planted": scenario_tp_planted,
    "tp_layout": scenario_tp_layout,
    "host_collectives": scenario_host_collectives,
    "spike_rollback": scenario_spike_rollback,
    "gqa": scenario_gqa,
    "moe_data": scenario_moe_data,
    "ep": scenario_ep,
    "recurrent_mla": scenario_recurrent_mla,
    "serve": scenario_serve,
    "continuous": scenario_continuous,
}
# run only when named
NAMED_ONLY = ("tp_", "host_collectives", "spike_rollback", "gqa", "moe_data", "ep",
              "recurrent_mla", "serve", "continuous")


# ---------------------------------------------------------------------------
# victim worlds: a training run killed, preempted or resumed
# ---------------------------------------------------------------------------

def _kill_after_batches(data, n: int):
    """Serve ``n`` batches, then SIGKILL this process on the next request."""
    served = 0
    while True:
        if served >= n:
            os.kill(os.getpid(), signal.SIGKILL)
        served += 1
        yield next(data)


def _term_after_batches(data, n: int):
    """Send this process SIGTERM once, when batch ``n`` is requested, and
    keep serving: the graceful preemption."""
    served = 0
    while True:
        if served == n:
            os.kill(os.getpid(), signal.SIGTERM)
        served += 1
        yield next(data)


def _arm_mid_save_kill(save_idx: int, leaf_idx: int) -> None:
    """SIGKILL during this process's ``save_idx``-th checkpoint write, once
    ``leaf_idx`` leaves are on disk (before the rename publishes it)."""
    from repro_torch.checkpoint import io as ckpt_io

    seen = {"saves": 0}

    def hook(i, _tmp):
        if i == 0:
            seen["saves"] += 1
        if seen["saves"] == save_idx and i == leaf_idx:
            os.kill(os.getpid(), signal.SIGKILL)

    ckpt_io.after_leaf_write = hook


def victim_main(args) -> None:
    torch.set_num_threads(1)
    mesh, _ = init_distributed("cpu", args.mesh)
    try:
        r = mesh.rank
        if r == 0 and args.kill_at_save:
            _arm_mid_save_kill(*(int(x) for x in args.kill_at_save.split(":")))
        tr = Trainer(build_model(TINY), CKPT_TC, device="cpu", mesh=mesh,
                     checkpoint_dir=args.ckpt_dir or None, checkpoint_every=args.every,
                     async_checkpoint=not args.sync_checkpoint, resume=args.resume,
                     preempt_grace=args.preempt_grace, log_every=1, log_fn=lambda s: None)
        data = DataPipeline(TINY, BATCH, SEQ, device="cpu", seed=0, rows=tr.batch_rows)
        if r == 0 and args.kill_after_batches is not None:
            data = _kill_after_batches(data, args.kill_after_batches)
        term = dict(tuple(int(x) for x in item.split(":"))
                    for item in args.term_at.split(",") if item)
        if r in term:
            data = _term_after_batches(data, term[r])
        tr.fit(data, args.steps)
        blob = {"rank": r, "final_step": int(tr.state.step), "status": tr._status,
                "skipped": int(tr.state.skipped), "examples_seen": tr.examples_seen}
        if r == 0:
            blob["history"] = tr.history
        if args.json:
            with open(f"{args.json}.rank{r}", "w") as f:
                json.dump(blob, f)
    finally:
        shutdown_distributed()


def _wait_world(procs, timeout: float, expect_kill: bool) -> int:
    """Wait for a victim world: every rank (exit code the worst one's), or
    with ``expect_kill`` rank 0's SIGKILL, after which the other ranks are
    killed (0 when rank 0 died of SIGKILL).  Past ``timeout`` every rank is
    killed and the world exits 124."""
    deadline = time.monotonic() + timeout
    watch = procs[:1] if expect_kill else procs
    while any(p.poll() is None for p in watch):
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.wait()
            return 124
        time.sleep(0.05)
    if expect_kill:
        for p in procs[1:]:
            p.kill()
            p.wait()
        return 0 if procs[0].returncode == -signal.SIGKILL else 1
    return max(abs(p.returncode) for p in procs)


def rank_main(args) -> None:
    torch.set_num_threads(1)
    mesh, _ = init_distributed("cpu", args.mesh or f"data={args.world},model=1")
    c = Ctx(mesh, args.out, args.init)
    report = {"world": mesh.size, "mesh": mesh.shape}
    try:
        for name in args.scenarios or [s for s in SCENARIOS if not s.startswith(NAMED_ONLY)]:
            kw = ({"restore": args.restore, "restore_mesh": args.restore_mesh}
                  if name == "checkpoint" else {})
            report[name] = SCENARIOS[name](c, **kw)
        if c.rank0:
            with open(os.path.join(args.out, "report.json"), "w") as f:
                json.dump(report, f)
    finally:
        shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--init", default="")
    ap.add_argument("--restore", default="")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--restore-mesh", default="")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--victim", action="store_true")
    ap.add_argument("--json", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--sync-checkpoint", action="store_true")
    ap.add_argument("--kill-after-batches", type=int, default=None)
    ap.add_argument("--kill-at-save", default="", metavar="SAVE:LEAF")
    ap.add_argument("--term-at", default="", metavar="RANK:BATCH,...")
    ap.add_argument("--preempt-grace", type=float, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("scenarios", nargs="*")
    args = ap.parse_args(argv)
    if args.rank is not None:
        victim_main(args) if args.victim else rank_main(args)
        return 0
    expect_kill = args.victim and bool(args.kill_after_batches is not None
                                       or args.kill_at_save)
    own = list(sys.argv[1:] if argv is None else argv)
    return run_world(own, args.world, args.out, args.timeout, expect_kill)


def run_world(argv, world: int, out: str, timeout: float = 600.0,
              expect_kill: bool = False, rank0_log: bool = False) -> int:
    """Start ``world`` ranks of this file with ``argv`` (the harness's
    flags, ``--world`` and ``--out`` included) on one gloo group and wait
    for them (:func:`_wait_world`); returns the world's exit code.  Each
    rank but 0 writes its errors to ``out/rank<r>.err``, rank 0 to the
    caller's stderr or, with ``rank0_log``, to ``out/rank0.err``."""
    os.makedirs(out, exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                                          if p))
    procs, logs = [], []
    for r in range(world):
        # rank 0's errors reach the caller; the others' go to a file each
        log = (open(os.path.join(out, f"rank{r}.err"), "w") if r or rank0_log else None)
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *map(str, argv), "--rank", str(r)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stderr=log))
    rc = _wait_world(procs, timeout, expect_kill)
    rcs = [p.returncode for p in procs]
    for r, log in enumerate(logs):
        if log is not None:
            log.close()
            if rcs[r] and not expect_kill and not rank0_log:
                with open(log.name) as f:
                    print(f"rank {r} failed:\n{f.read()[-3000:]}", file=sys.stderr)
    return rc

if __name__ == "__main__":
    sys.exit(main())
