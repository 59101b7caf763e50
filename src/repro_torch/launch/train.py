"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \
        --batch 64 --seq 128 --accum-steps 2 --precision bf16 \
        --fused-lamb --steps 6 [--device cpu] [--smoke] \
        [--optimizer {lamb,lans,lars,nlamb,nnlamb,adam,adamw,adagrad,momentum}] \
        [--log-trust-ratios] [--mixed-batch] [--skip-nonfinite] \
        [--checkpoint-dir DIR --checkpoint-every N [--async-checkpoint] [--resume]] \
        [--telemetry-dir DIR] [--rollback-on-spike --spike-window 32 \
         --max-rollbacks 3] [--preempt-grace 30]

LAMB pretraining of BERT-large (masked LM on synthetic data), the fused
LAMB update, flash attention and the fused CE head running as CUDA kernels
(``--no-flash`` takes the dense attention instead, ``--no-fused-ce`` the
dense MLM head).  ``--optimizer`` picks the update rule (default ``lamb``):
``--fused-lamb`` runs LAMB on the fused kernels, else every optimizer runs
as a transform chain (``train/step.make_optimizer``).
``--log-trust-ratios`` adds the trust ratios' min, max and mean over the
layers to each step's history row.  ``--mixed-batch`` runs the §4.1
two-stage recipe: 80% of the steps at ``--seq`` and ``--batch``, the rest
at 4 × seq and batch / 4 with a re-warmed learning rate on the same
optimizer state.
``--skip-nonfinite`` skips (and counts) a step whose gradients or loss are
not finite.  ``--telemetry-dir`` writes the structured event log
(``events.jsonl``) and, from a ``finally``, ``RUN_REPORT.json``; with
``--log-trust-ratios`` it also records every layer's trust ratio and norms
at each logged step.  ``--rollback-on-spike`` arms the loss-spike watchdog:
a trip restores the last validated checkpoint, and past
``--max-rollbacks`` the run aborts with exit code 3.  ``--preempt-grace N``
turns SIGTERM/SIGINT into a final checkpoint (drained within N seconds)
and a clean ``status=preempted`` stop, resumable with ``--resume``.  It
runs on ``cuda`` unless ``--device`` names another device, and raises when
there is no card.

``--mesh data=N,model=M`` trains over N·M ranks, one process per device,
started by ``torch.distributed.run``: FSDP over the N data-parallel ranks
and Megatron-style tensor parallelism over the M ``model`` ranks (heads,
kv heads, ff and vocab split; the dense transformers):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch bert-large --smoke --fused-lamb \
        --steps 3 --device cpu --mesh data=2,model=2

(NCCL on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu``).  Params and
optimizer moments are split into blocks over the ranks, each data-parallel
rank trains on its block of each micro-batch of the global batch (the
``model`` ranks of one data coordinate on the same rows), and only rank 0
prints and writes.  Under ``torch.distributed.run`` without ``--mesh``, the
ranks form ``data=WORLD/--model-parallel, model=--model-parallel``, as the
reference's host mesh.  An MoE arch runs over data-parallel ranks with the
reference's global capacity and load-balance loss; heads split over
``model`` while the kv heads stay whole attend against the whole kv heads.
``--rollback-on-spike`` and ``--preempt-grace`` run over the mesh with one
verdict, one flag and one writer, and every rank exits with the same code
(0 when preempted, 3 when diverged):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch bert-large --smoke --fused-lamb \
        --steps 10 --device cpu --mesh data=2,model=1 --rollback-on-spike \
        --checkpoint-dir /tmp/ck --checkpoint-every 2 --preempt-grace 30

Every arch trains over ``data × model``: over ``model`` an MoE arch splits
its experts (expert parallelism, tokens replicated over ``model``), the
xLSTM and Mamba layers their ``inner`` width and heads, and MLA its heads,
each held to the single process:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch jamba-1.5-large-398b --smoke \
        --steps 3 --device cpu --mesh data=1,model=2

Any mesh axis runs: a rank on an axis besides ``pod``, ``data`` and
``model`` (``--mesh data=1,model=1,pipe=2``) holds the same rows as its
peers on that axis.  ``--param-rule name=a,b`` (as the reference's dry-run
takes it) changes the layout that stores params and moments: a dimension
split over ``data`` and ``model`` together (``embed=data,model``), over
part of the data-parallel axes (``embed=data`` on ``pod × data``), any
layout the rules give; the step gathers each leaf into the default
rules' layout to compute and sends its gradient back to its block.

The flags mirror ``repro.launch.train``; ``--param-rule`` is the
reference dry-run's.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch import core
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import make_stage
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    Mesh,
    init_distributed,
    make_host_mesh,
    parse_mesh_spec,
    shutdown_distributed,
)
from repro_torch.models import build_model
from repro_torch.sharding import default_param_rules, dp_size, override_rules
from repro_torch.telemetry import EventLog, RunReport
from repro_torch.train import DivergenceError, SupervisorConfig, Trainer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="lamb",
                    help="lamb | lans | lars | nlamb | nnlamb | adam | adamw | "
                         "adagrad | momentum")
    ap.add_argument("--base-lr", type=float, default=2.5e-3)
    ap.add_argument("--base-batch", type=int, default=16)
    ap.add_argument("--warmup-ratio", type=float, default=1 / 40)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="compute dtype (bf16 keeps fp32 master params)")
    ap.add_argument("--fused-lamb", action="store_true",
                    help="fused LAMB update (CUDA kernels on the card); LAMB only")
    ap.add_argument("--flash", dest="flash", action="store_true", default=None)
    ap.add_argument("--no-flash", dest="flash", action="store_false")
    ap.add_argument("--fused-ce", dest="fused_ce", action="store_true", default=None)
    ap.add_argument("--no-fused-ce", dest="fused_ce", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixed-batch", action="store_true",
                    help="§4.1 two-stage recipe: 80%% of the steps at --seq, the "
                         "rest at 4x seq with batch/4, re-warmed, one optimizer state")
    ap.add_argument("--skip-nonfinite", action="store_true",
                    help="skip (and count) a step whose gradients or loss are "
                         "not finite; the state is left bit-identical")
    ap.add_argument("--checkpoint-dir", default="",
                    help="write the full train state here every --checkpoint-every "
                         "batches (the JAX package's format)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="double-buffered background saves: the step loop only "
                         "queues the device-to-host copy")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest complete checkpoint in "
                         "--checkpoint-dir and continue from its step")
    ap.add_argument("--mesh", default="",
                    help="mesh axes, e.g. data=4,model=2 (one rank per device, under "
                         "torch.distributed.run); params + LAMB moments are "
                         "FSDP-sharded over data, heads/ff/vocab split over model")
    ap.add_argument("--param-rule", action="append", default=[],
                    help="parameter sharding rule override name=axis1,axis2 "
                         "(repeatable; an empty value replicates that logical axis): "
                         "the layout that stores params and moments, e.g. "
                         "embed=data,model; the layers compute in the default one")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="legacy spelling: model-axis size of the host mesh "
                         "(ignored when --mesh is given)")
    ap.add_argument("--telemetry-dir", default="",
                    help="write the event log (events.jsonl) and RUN_REPORT.json here; "
                         "off: a null sink, the step loop unchanged")
    ap.add_argument("--log-trust-ratios", action="store_true",
                    help="the trust ratios' min, max and mean in each history row; with "
                         "--telemetry-dir also every layer's ratio and norms")
    ap.add_argument("--rollback-on-spike", action="store_true",
                    help="loss-spike watchdog: a trip restores the last validated "
                         "checkpoint and skips the suspect batches (requires "
                         "--checkpoint-dir and --checkpoint-every)")
    ap.add_argument("--spike-window", type=int, default=32,
                    help="trailing-loss window of the spike detector")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="rollbacks before the run aborts with exit code 3")
    ap.add_argument("--preempt-grace", type=float, default=None,
                    help="seconds: SIGTERM/SIGINT finishes the step, writes a final "
                         "checkpoint within this window and stops with status=preempted")
    return ap.parse_args(argv)


def lr_schedule(args: argparse.Namespace):
    """``(lr, schedule)``: the base learning rate scaled by the square root
    of ``--batch / --base-batch``, warmed up linearly over the warmup ratio
    scaled the same way, then decayed linearly to 0 at ``--steps``."""
    lr = core.sqrt_scaled_lr(args.base_lr, args.base_batch, args.batch)
    warmup_ratio = core.linear_epoch_warmup_ratio(
        args.warmup_ratio, args.base_batch, args.batch)
    return lr, core.warmup_poly_decay(lr, args.steps, int(args.steps * warmup_ratio))


def _mesh_plan(args: argparse.Namespace) -> Optional[Mesh]:
    """The mesh ``args`` ask for, names and sizes only (None: one process)."""
    if args.mesh:
        return Mesh(parse_mesh_spec(args.mesh))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.model_parallel > 1 or world > 1:
        return make_host_mesh(args.model_parallel, world_size=world)
    return None


def build(args: argparse.Namespace, *, remat: Optional[str] = None, **trainer_kw):
    """(trainer, data, cfg) for parsed ``args``; raises for unported options.
    ``remat`` replaces the model config's, and ``trainer_kw`` replace the
    Trainer keywords taken from ``args``.  With a mesh this joins the run's
    process group (:func:`~repro_torch.launch.mesh.init_distributed`)."""
    if args.accum_steps < 1:
        raise SystemExit(f"--accum-steps must be >= 1, got {args.accum_steps}")
    if args.batch % args.accum_steps:
        raise SystemExit(f"--batch {args.batch} must be divisible by "
                         f"--accum-steps {args.accum_steps}")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.rollback_on_spike and not (args.checkpoint_dir and args.checkpoint_every):
        raise SystemExit("--rollback-on-spike requires --checkpoint-dir and "
                         "--checkpoint-every (rollback needs a checkpoint to restore)")
    if args.rollback_on_spike and args.mixed_batch:
        raise SystemExit("--rollback-on-spike is not supported with --mixed-batch")
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.flash is not None:
        cfg = cfg.replace(use_flash_kernel=args.flash)
    if args.fused_ce is not None:
        cfg = cfg.replace(use_fused_ce_head=args.fused_ce)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    mesh = _mesh_plan(args)
    param_rules = None
    if mesh is not None:
        mesh, device = init_distributed(device, args.mesh,
                                        model_parallel=args.model_parallel)
        if args.param_rule:
            param_rules = override_rules(
                default_param_rules(multi_pod="pod" in mesh.shape), args.param_rule)
    model = build_model(cfg)
    lr, schedule = lr_schedule(args)
    writer = mesh is None or mesh.rank == 0
    telemetry = (EventLog.to_dir(args.telemetry_dir) if args.telemetry_dir and writer
                 else EventLog())
    tc = TrainConfig(
        optimizer=args.optimizer, learning_rate=lr,
        weight_decay=args.weight_decay, total_steps=args.steps, seed=args.seed,
        accum_steps=args.accum_steps, precision=args.precision,
        use_fused_lamb=args.fused_lamb, skip_nonfinite=args.skip_nonfinite,
        log_trust_ratios=args.log_trust_ratios,
        # the per-layer records cost a transfer a logged step: only worth it
        # with an event log to receive them
        record_trust_ratios=args.log_trust_ratios and telemetry.enabled,
    )
    kw = dict(
        schedule=schedule,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        async_checkpoint=args.async_checkpoint,
        resume=args.resume,
        log_every=args.log_every,
        telemetry=telemetry,
        supervisor=(SupervisorConfig(spike_window=args.spike_window,
                                     max_rollbacks=args.max_rollbacks)
                    if args.rollback_on_spike else None),
        preempt_grace=args.preempt_grace,
        mesh=mesh,
        param_rules=param_rules,
    )
    trainer = Trainer(model, tc, device=device, **{**kw, **trainer_kw})
    data = DataPipeline(cfg, args.batch, args.seq, device=device, seed=args.seed,
                        rows=trainer.batch_rows)
    return trainer, data, cfg


def mixed_batch_stages(args: argparse.Namespace, dp: int = 1) -> list:
    """The reference launcher's two stages: ``--seq`` and ``--batch`` for
    ``int(0.8 · steps)`` steps, then 4 × seq at batch / 4, re-warmed, for
    the rest.  Every stage batch must divide into ``--accum-steps``
    microbatches and over the ``dp`` data-parallel ranks, else stage 2
    would fail after stage 1 trained."""
    n1 = int(args.steps * 0.8)
    kw = dict(base_lr=args.base_lr, base_batch=args.base_batch,
              base_warmup_ratio=args.warmup_ratio)
    stages = [
        make_stage("stage1", args.seq, args.batch, n1, **kw),
        make_stage("stage2_rewarmup", args.seq * 4, max(args.batch // 4, 1),
                   args.steps - n1, **kw),
    ]
    for st in stages:
        if st.batch_size % args.accum_steps:
            raise SystemExit(f"stage {st.name!r} batch {st.batch_size} is not "
                             f"divisible by --accum-steps {args.accum_steps}")
        if st.batch_size % dp:
            raise SystemExit(f"stage {st.name!r} batch {st.batch_size} is not "
                             f"divisible by the mesh's data-parallel size {dp}")
    return stages


def main(argv: Optional[List[str]] = None) -> Trainer:
    args = parse_args(argv)
    trainer, data, cfg = build(args)
    mesh = trainer.mesh
    say = print if trainer.is_writer else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={trainer.model.param_count()/1e6:.1f}M "
        f"device={trainer.device}")
    say(f"global_batch={args.batch} microbatch={args.batch // args.accum_steps} "
        f"accum={args.accum_steps} precision={args.precision} "
        f"optimizer={args.optimizer} "
        f"fused_lamb={args.fused_lamb} flash={cfg.use_flash_kernel} "
        f"fused_ce={cfg.use_fused_ce_head}")
    if mesh is not None:
        say(f"mesh={mesh.shape} devices={mesh.size}")
    stages = (mixed_batch_stages(args, 1 if mesh is None else dp_size(mesh))
              if args.mixed_batch else None)
    # the Trainer emits run_end (with its status) from a finally, so the
    # report is written even when the run aborts: a diverged run's report is
    # the diagnostic to read
    exit_code = 0
    try:
        if stages:
            trainer.fit_stages(stages, data_seed=args.seed)
        else:
            def make_data():
                return DataPipeline(cfg, args.batch, args.seq, device=trainer.device,
                                    seed=args.seed, rows=trainer.batch_rows)

            trainer.fit(data, args.steps, data_factory=make_data)
    except DivergenceError as e:
        print(f"DIVERGED: {e}", file=sys.stderr)
        for k, v in e.diagnostics.items():
            print(f"  {k}: {v}", file=sys.stderr)
        exit_code = 3
    finally:
        telemetry = trainer.telemetry
        if telemetry.enabled:
            telemetry.close()
            report_path = Path(args.telemetry_dir) / "RUN_REPORT.json"
            RunReport.from_events(telemetry.path).write(report_path)
            print(f"telemetry: {telemetry.path} report: {report_path}")
    final = trainer.history[-1] if trainer.history else {}
    loss = final.get("loss/total")
    say(f"done: step={final.get('step')} "
        f"loss={'n/a' if loss is None else f'{loss:.4f}'} "
        f"acc={final.get('accuracy', 0.0):.4f} status={trainer._status}")
    if exit_code:
        sys.exit(exit_code)
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown_distributed()
