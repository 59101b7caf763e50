"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \
        --batch 64 --seq 128 --accum-steps 2 --precision bf16 \
        --fused-lamb --steps 6 [--device cpu] [--smoke]

LAMB pretraining of BERT-large (masked LM on synthetic data), the fused
LAMB update, flash attention and the fused CE head running as CUDA kernels
(``--no-flash`` takes the dense attention instead, ``--no-fused-ce`` the
dense MLM head).  It runs on ``cuda`` unless ``--device`` names another
device, and raises when there is no card.

The flags mirror ``repro.launch.train``.  Those whose code is not ported
yet raise ``NotImplementedError`` naming their ROADMAP.md item: optimizers
other than fused LAMB, meshes, checkpoints, mixed-batch stages, telemetry,
trust-ratio logging and the non-finite guard.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch import core
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import Trainer

# flag → ROADMAP.md item of the code it would need
_UNPORTED = {
    "mesh": "queue 1, item 11",
    "checkpoint_dir": "queue 1, item 7",
    "resume": "queue 1, item 7",
    "mixed_batch": "queue 1, item 7",
    "telemetry_dir": "queue 1, item 8",
    "log_trust_ratios": "queue 1, item 8",
    "skip_nonfinite": "queue 1, item 6",
    "rollback_on_spike": "queue 1, item 8",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="lamb")
    ap.add_argument("--base-lr", type=float, default=2.5e-3)
    ap.add_argument("--base-batch", type=int, default=16)
    ap.add_argument("--warmup-ratio", type=float, default=1 / 40)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="compute dtype (bf16 keeps fp32 master params)")
    ap.add_argument("--fused-lamb", action="store_true",
                    help="fused LAMB update (CUDA kernels on the card)")
    ap.add_argument("--flash", dest="flash", action="store_true", default=None)
    ap.add_argument("--no-flash", dest="flash", action="store_false")
    ap.add_argument("--fused-ce", dest="fused_ce", action="store_true", default=None)
    ap.add_argument("--no-fused-ce", dest="fused_ce", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    for flag in ("--mesh", "--checkpoint-dir", "--telemetry-dir"):
        ap.add_argument(flag, default="")
    for flag in ("--resume", "--mixed-batch", "--log-trust-ratios",
                 "--skip-nonfinite", "--rollback-on-spike"):
        ap.add_argument(flag, action="store_true")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(trainer, data, cfg) for parsed ``args``; raises for unported options."""
    for name, item in _UNPORTED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported to PyTorch yet "
                f"(ROADMAP.md {item})"
            )
    if args.accum_steps < 1:
        raise SystemExit(f"--accum-steps must be >= 1, got {args.accum_steps}")
    if args.batch % args.accum_steps:
        raise SystemExit(f"--batch {args.batch} must be divisible by "
                         f"--accum-steps {args.accum_steps}")
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.flash is not None:
        cfg = cfg.replace(use_flash_kernel=args.flash)
    if args.fused_ce is not None:
        cfg = cfg.replace(use_fused_ce_head=args.fused_ce)
    model = build_model(cfg)
    lr = core.sqrt_scaled_lr(args.base_lr, args.base_batch, args.batch)
    warmup_ratio = core.linear_epoch_warmup_ratio(
        args.warmup_ratio, args.base_batch, args.batch)
    tc = TrainConfig(
        optimizer=args.optimizer, learning_rate=lr,
        weight_decay=args.weight_decay, total_steps=args.steps, seed=args.seed,
        accum_steps=args.accum_steps, precision=args.precision,
        use_fused_lamb=args.fused_lamb,
    )
    trainer = Trainer(
        model, tc, device=device,
        schedule=core.warmup_poly_decay(lr, args.steps, int(args.steps * warmup_ratio)),
        log_every=args.log_every,
    )
    data = DataPipeline(cfg, args.batch, args.seq, device=device, seed=args.seed)
    return trainer, data, cfg


def main(argv: Optional[List[str]] = None) -> Trainer:
    args = parse_args(argv)
    trainer, data, cfg = build(args)
    print(f"arch={cfg.name} params={trainer.model.param_count()/1e6:.1f}M "
          f"device={trainer.device}")
    print(f"global_batch={args.batch} microbatch={args.batch // args.accum_steps} "
          f"accum={args.accum_steps} precision={args.precision} "
          f"fused_lamb={args.fused_lamb} flash={cfg.use_flash_kernel} "
          f"fused_ce={cfg.use_fused_ce_head}")
    trainer.fit(data, args.steps)
    final = trainer.history[-1] if trainer.history else {}
    loss = final.get("loss/total")
    print(f"done: step={final.get('step')} "
          f"loss={'n/a' if loss is None else f'{loss:.4f}'} "
          f"acc={final.get('accuracy', 0.0):.4f} status=ok")
    return trainer


if __name__ == "__main__":
    main()
