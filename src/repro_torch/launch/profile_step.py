"""Where the time of a training step goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step [train flags]

Takes the flags of :mod:`repro_torch.launch.train` (default: the BERT-large
bf16 fused-LAMB, flash-attention, fused-CE path with batch 64 × seq 128,
accum 2; ``--no-flash`` profiles the dense attention instead,
``--no-fused-ce`` the dense MLM head; ``--optimizer NAME`` the step with
that optimizer's transform chain, and ``--optimizer lamb --fused-lamb``
the fused path again), runs two warm-up steps, then one step
under ``torch.profiler`` and five timed with CUDA events, all on batches
made beforehand (the host's batch generation is timed on its own).  Prints
the step time, the device's idle share, the peak device memory over the
steps, and the device time by kernel, grouped: the LAMB kernels, the
flash-attention kernels, the fused CE kernels, matrix products, and
everything else; then each kernel of the port's three groups, and the 20
costliest kernels.
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
    "--precision", "bf16", "--fused-lamb",
    "--log-every", "1000",
]
TIMED = 5
# the caching allocator's calls into the driver (each cudaFree waits for the
# device) and its retries after freeing cached blocks
ALLOCATOR_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _group(name: str) -> str:
    if "lamb_moments_kernel" in name or "lamb_apply_kernel" in name:
        return "lamb kernels"
    if any(f"flash_{k}_" in name for k in ("fwd", "dq", "dkv")):
        return "flash kernels"
    if "fused_ce_" in name:
        return "fused CE kernels"
    if any(s in name for s in ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet")):
        return "matrix products"
    return "other"


def measure(trainer, data) -> dict:
    """Two warm-up steps, one under ``torch.profiler``, then ``TIMED``
    steps between CUDA events, all on batches of ``data`` made beforehand.
    Returns the host's ms per batch, the timed steps' wall and device-span
    ms per step, the profiled step's kernel rows ``(name, ms, count)``,
    busy ms, launches and idle share, the peak device memory in GiB and the
    caching allocator's calls per timed step."""
    trainer.log = lambda msg: None
    if trainer.state is None:
        trainer.init()  # weights and the CUDA context before anything is timed
    torch.cuda.reset_peak_memory_stats()
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
    alloc0 = {k: torch.cuda.memory_stats().get(k, 0) for k in ALLOCATOR_STATS}
    t0 = time.perf_counter()
    start.record()
    trainer.fit(iter(batches[3:]), TIMED)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED
    alloc = {k: (torch.cuda.memory_stats().get(k, 0) - alloc0[k]) / TIMED
             for k in ALLOCATOR_STATS}
    span_ms = start.elapsed_time(end) / TIMED
    # kernel-level events only: an operator's device time is its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    return dict(data_ms=data_ms, wall_ms=wall_ms, span_ms=span_ms, rows=rows, busy_ms=busy,
                launches=sum(n for *_, n in rows), idle=1 - busy / span_ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, alloc=alloc)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    default = [a for a in DEFAULT_ARGV if a != "--fused-lamb" or "--optimizer" not in argv]
    trainer, data, _ = build(parse_args(default + argv))
    r = measure(trainer, data)
    rows, busy = r["rows"], r["busy_ms"]
    groups: dict = {}
    for key, ms, _ in rows:
        groups[_group(key)] = groups.get(_group(key), 0.0) + ms
    print(f"host batch generation: {r['data_ms']:.2f} ms per batch (outside the steps below)")
    print(f"{TIMED} steps, batches already on the card: wall {r['wall_ms']:.2f} ms/step, "
          f"device span {r['span_ms']:.2f} ms/step (CUDA events)")
    print(f"profiled step: kernels busy {busy:.2f} ms in {r['launches']} "
          f"launches; device idle share of a timed step {r['idle']:.2f}")
    print(f"peak device memory over the steps: {r['peak_gib']:.2f} GiB; caching allocator "
          f"per timed step: " + ", ".join(f"{k} {v:g}" for k, v in r["alloc"].items()))
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:16s} {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f}%")
    for g in ("flash kernels", "fused CE kernels", "lamb kernels"):
        for key, ms, n in sorted(rows, key=lambda r: -r[1]):
            if _group(key) == g:
                print(f"  {g}: {ms:9.2f} ms {n:6d}x  {key[:120]}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"  {ms:9.2f} ms {n:6d}x  {key[:120]}")


if __name__ == "__main__":
    main()
