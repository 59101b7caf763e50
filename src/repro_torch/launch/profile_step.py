"""Where the time of a training step goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step [train flags]

Takes the flags of :mod:`repro_torch.launch.train` (default: the BERT-large
bf16 fused-LAMB path with batch 64 × seq 128, accum 2), runs two warm-up
steps, then one step under ``torch.profiler`` and five timed with CUDA
events, all on batches made beforehand (the host's batch generation is
timed on its own).  Prints the step time, the device's idle share, and the
device time by kernel, grouped: the LAMB kernels, matrix products, and
everything else.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.train import build, parse_args

DEFAULT_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--no-flash", "--no-fused-ce",
    "--log-every", "1000",
]
TIMED = 5


def _group(name: str) -> str:
    if "lamb_moments_kernel" in name or "lamb_apply_kernel" in name:
        return "lamb kernels"
    if any(s in name for s in ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet")):
        return "matrix products"
    return "other"


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(DEFAULT_ARGV + list(sys.argv[1:] if argv is None else argv))
    trainer, data, cfg = build(args)
    trainer.log = lambda msg: None
    trainer.init()  # weights and the CUDA context before anything is timed
    next(data)
    t0 = time.perf_counter()
    batches = [next(data) for _ in range(2 + 1 + TIMED)]
    data_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    trainer.fit(iter(batches[:2]), 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit(iter(batches[2:3]), 1)
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    trainer.fit(iter(batches[3:]), TIMED)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED
    span_ms = start.elapsed_time(end) / TIMED
    # kernel-level events only: an operator's device time is its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    groups: dict = {}
    for key, ms, _ in rows:
        groups[_group(key)] = groups.get(_group(key), 0.0) + ms
    print(f"host batch generation: {data_ms:.2f} ms per batch (outside the steps below)")
    print(f"{TIMED} steps, batches already on the card: wall {wall_ms:.2f} ms/step, "
          f"device span {span_ms:.2f} ms/step (CUDA events)")
    print(f"profiled step: kernels busy {busy:.2f} ms in {sum(n for *_, n in rows)} "
          f"launches; device idle share of a timed step {1 - busy / span_ms:.2f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:16s} {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f}%")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"  {ms:9.2f} ms {n:6d}x  {key[:120]}")


if __name__ == "__main__":
    main()
