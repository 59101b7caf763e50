"""Serving launcher of the PyTorch port: static-batch or continuous-batching
generation.

    # static batch (pad everything to one shape, block until done)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 8 --prompt-len 128 --max-new 32

    # continuous batching over a slot pool with Poisson arrivals
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --continuous --slots 8 --arrival-rate 20 --requests 32 \
        --prompt-len 128 --max-new 64

    # on the CPU, at smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu [--continuous]

The flags mirror ``repro.launch.serve``, plus ``--device``: it runs on
``cuda`` unless ``--device`` names another device, and raises when there is
no card.  Weights are random, from ``--seed``; the whole run is under
``torch.inference_mode()``.

``--telemetry-dir`` (continuous mode) writes a structured event log — one
``serve_request`` event per request lifecycle (TTFT, latency, terminal
status) plus the reliability lifecycle events (shed/timeout/retry/
quarantine/degrade/drain) and a ``serve_stats`` aggregate — and a
``RUN_REPORT.json`` rollup at exit.

Reliability flags (continuous mode): ``--max-queue``/``--max-queue-tokens``
bound the arrived backlog (admission control), ``--timeout`` caps each
request's total latency, ``--stall-slo`` arms the stall watchdog,
``--retries`` bounds transient-failure retries, ``--inject-faults`` takes a
deterministic fault list (``kind@ordinal[:persist][:stall=S]``, see
``serve/faults.py``), and SIGTERM/SIGINT trigger a graceful drain: no new
admissions, in-flight work finishes within ``--drain-grace`` seconds, the
rest is shed, and the process exits with a clean terminal-state summary.

No flag serves on a mesh, as the reference's launcher has none: serving
on a mesh is the library call, one engine a rank over the mesh of
``launch.mesh.init_distributed`` (or ``run_plain_mesh``'s thread ranks),
``Engine(model, params, shard_ctx=ShardCtx(mesh))`` or
``ContinuousEngine(model, params, shard_ctx=ShardCtx(mesh))``, every rank
given the same requests.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (
    ContinuousEngine,
    Engine,
    FCFSScheduler,
    Request,
    ServeFaultInjector,
    ServeRequest,
    assign_arrivals,
    parse_fault_specs,
    poisson_arrivals,
    serving_stats,
)
from repro_torch.telemetry import EventLog, RunReport, run_provenance
from repro_torch.train.preempt import PreemptionHandler


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a KV slot pool")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous mode)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson request rate in req/s (0 = all at once)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="admission deadline in seconds (continuous mode)")
    ap.add_argument("--max-prefills-per-step", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request total latency budget in seconds")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the arrived backlog (requests); overload "
                         "beyond this is shed, not queued")
    ap.add_argument("--max-queue-tokens", type=int, default=None,
                    help="bound the arrived backlog by estimated "
                         "prompt+generation tokens")
    ap.add_argument("--stall-slo", type=float, default=None,
                    help="per-decode-step SLO in seconds; a step past it "
                         "degrades admissions until recovery")
    ap.add_argument("--retries", type=int, default=2,
                    help="transient-failure retry budget per request")
    ap.add_argument("--inject-faults", default="",
                    help="deterministic fault list, e.g. "
                         "'sample_nan@1,slot_corrupt@2:persist,"
                         "decode_stall@3:stall=0.2'")
    ap.add_argument("--drain-grace", type=float, default=5.0,
                    help="seconds in-flight requests get to finish after "
                         "SIGTERM/SIGINT before being shed")
    ap.add_argument("--telemetry-dir", default="",
                    help="write events.jsonl + RUN_REPORT.json here "
                         "(continuous mode; off = null sink)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for a CPU run)")
    return ap.parse_args(argv)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None):
    """Serve ``--requests`` random prompts; returns the finished requests."""
    args = parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode/serve path")
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(args.seed, device)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M device={device}")

    rng = np.random.default_rng(args.seed)
    max_len = args.prompt_len + args.max_new + 8
    prompts = [
        rng.integers(0, min(cfg.vocab_size, 1024),
                     size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests)
    ]

    if args.continuous:
        telemetry = (EventLog.to_dir(args.telemetry_dir)
                     if args.telemetry_dir else EventLog())
        if telemetry.enabled:
            telemetry.emit("run_start", mode="serve", arch=cfg.name,
                           n_slots=args.slots,
                           arrival_rate=args.arrival_rate,
                           provenance=run_provenance(device=device, configs=(cfg,)))
        faults = (ServeFaultInjector(parse_fault_specs(args.inject_faults))
                  if args.inject_faults else None)
        eng = ContinuousEngine(
            model, params, n_slots=args.slots, max_len=max_len,
            seed=args.seed,
            scheduler=FCFSScheduler(args.max_prefills_per_step,
                                    max_queue=args.max_queue,
                                    max_queue_tokens=args.max_queue_tokens),
            telemetry=telemetry,
            faults=faults,
            max_retries=args.retries,
            stall_slo_s=args.stall_slo,
        )
        reqs = [
            ServeRequest(p, max_new_tokens=args.max_new,
                         temperature=args.temperature,
                         deadline_s=args.deadline,
                         timeout_s=args.timeout)
            for p in prompts
        ]
        assign_arrivals(
            reqs, poisson_arrivals(len(reqs), args.arrival_rate,
                                   seed=args.seed))
        # graceful drain: SIGTERM/SIGINT flips a flag the generate loop
        # polls — admissions stop, in-flight work gets --drain-grace
        with PreemptionHandler() as preempt:
            out = eng.generate(
                reqs,
                should_drain=lambda: preempt.triggered,
                drain_grace_s=args.drain_grace,
            )
        for i, r in enumerate(out[:4]):
            print(f"req[{i}] (+{r.arrival_s:.3f}s) [{r.status.value}] -> "
                  f"{np.asarray(r.out_tokens[:16])}...")
        stats = serving_stats(out)
        print(f"stats: {stats}")
        summary = " ".join(
            f"{k}={stats.get(k, 0)}"
            for k in ("submitted", "completed", "shed", "timed_out", "failed"))
        if preempt.triggered:
            print(f"drained ({preempt.signal_name}): {summary}")
        else:
            print(f"done: {summary}")
        if faults is not None:
            print(f"faults fired: {faults.fire_counts()}")
        if telemetry.enabled:
            telemetry.emit(
                "run_end",
                status="drained" if preempt.triggered else "ok")
            report_path = Path(args.telemetry_dir) / "RUN_REPORT.json"
            RunReport.from_events(telemetry.path).write(report_path)
            print(f"telemetry: {telemetry.path} report: {report_path}")
        return out

    eng = Engine(model, params, max_len=max_len, seed=args.seed)
    reqs = [
        Request(prompt=p, max_new_tokens=args.max_new,
                temperature=args.temperature)
        for p in prompts
    ]
    out = eng.generate_batch(reqs)
    stats = eng.throughput_stats(out)
    for i, r in enumerate(out[:4]):
        print(f"req[{i}] -> {r.out_tokens[:16]}...")
    print(f"stats: {stats}")
    print(f"done: submitted={len(out)} completed={len(out)}")
    return out


if __name__ == "__main__":
    main()
