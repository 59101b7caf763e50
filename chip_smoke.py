#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card: its name and power limit from ``nvidia-smi``;
2. build: the CUDA kernels, from ``src/repro_torch/kernels/csrc``, with
   ``nvcc`` for ``sm_90a`` into ``build/`` (one ``nvcc`` per source, in
   parallel);
3. kernels vs plain: the fused LAMB kernels K1 (``lamb_moments``) and K2
   (``lamb_apply``) against their plain PyTorch version on the same inputs,
   at BERT-large leaf shapes;
4. reference: two bert-smoke fp32 train steps on the card against the same
   steps on the CPU (the CPU path is the one the test suite holds to the JAX
   package);
5. main path: ``repro_torch.launch.train`` on full-width BERT-large
   (24 layers, d 1024, vocab 30522), batch 64 × seq 128, accum 2, bf16,
   fused LAMB, 6 steps; finite losses, moved weights, and every LAMB kernel
   launched 13 leaves × 6 steps times;
6. timing: K1 and K2 over one full BERT-large update with CUDA events,
   beside their plain version and the memory-bandwidth bound.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_STEPS = 6
MAIN_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--no-flash", "--no-fused-ce",
    "--steps", str(MAIN_STEPS), "--log-every", "1",
]

# Device-memory rate of the card by name (NVIDIA data sheets), for the bound.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}

KERNELS = {
    "lamb_moments": dict(route="cuda",
                         source="src/repro_torch/kernels/csrc/lamb_update.cu",
                         replaces="src/repro/kernels/lamb_update.py:31"),
    "lamb_apply": dict(route="cuda",
                       source="src/repro_torch/kernels/csrc/lamb_update.cu",
                       replaces="src/repro/kernels/lamb_update.py:50"),
}

# BERT-large leaf shapes for the kernel check: (name, shape, layer_axis, x
# dtype, g dtype, weight decay and trust ratio on)
CHECK_CASES = [
    ("blocks/mlp/wi", (24, 1024, 4096), 0, "float32", "float32", True),
    ("embed", (30522, 1024), None, "float32", "float32", True),
    ("blocks/ln1/scale", (24, 1024), 0, "float32", "float32", False),
    ("ragged", (3, 1_000_003), 0, "float32", "float32", True),
    ("blocks/attn/wq bf16", (24, 1024, 16, 64), 0, "bfloat16", "float32", True),
    ("blocks/attn/wo bf16 grads", (24, 16, 64, 1024), 0, "bfloat16", "bfloat16", True),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0]


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def bf16_ulp(t):
    import torch

    mag = t.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# phase 3: kernels against the plain version
# ---------------------------------------------------------------------------

def check_kernels(device) -> dict:
    """Max abs errors per kernel over the cases; raises on a mismatch.

    Tolerances: m', v' are the same fp32 formula (the kernel's multiply-adds
    may fuse), so a few ulps; the trust ratio's norms sum in another order,
    so 1e-5 relative; x' then differs by that share of its update plus an
    ulp of x (one bf16 ulp for bf16 weights).
    """
    import torch

    from repro_torch.kernels import lamb_update

    errs = {"lamb_moments": 0.0, "lamb_apply": 0.0}
    gen = torch.Generator(device=device).manual_seed(0)
    for name, shape, axis, xdt, gdt, on in CHECK_CASES:
        x = (0.05 * torch.randn(shape, generator=gen, device=device)).to(getattr(torch, xdt))
        g = (1e-3 * torch.randn(shape, generator=gen, device=device)).to(getattr(torch, gdt))
        m = 1e-4 * torch.randn(shape, generator=gen, device=device)
        v = 1e-8 * torch.rand(shape, generator=gen, device=device)
        kw = dict(weight_decay=0.01 if on else 0.0, apply_trust=on, layer_axis=axis)
        count = torch.tensor(5, dtype=torch.int32, device=device)
        lr = torch.tensor(1e-3, device=device)
        ref = lamb_update(x.clone(), g, m.clone(), v.clone(), count, lr, plain=True, **kw)
        x0 = x.clone()
        out = lamb_update(x, g, m, v, count, lr, **kw)
        torch.cuda.synchronize()
        em = float((out.m - ref.m).abs().max())
        ev = float((out.v - ref.v).abs().max())
        ex = float((out.x.float() - ref.x.float()).abs().max())
        er = float(((out.ratio - ref.ratio).abs() / ref.ratio.abs()).max())
        ed = abs(float(out.delta_sq) - float(ref.delta_sq)) / max(float(ref.delta_sq), 1e-30)
        step = (ref.x.float() - x0.float()).abs()
        if xdt == "bfloat16":
            x_ok = bool(((out.x.float() - ref.x.float()).abs() <= bf16_ulp(ref.x.float())).all())
        else:
            x_ok = bool(((out.x - ref.x).abs() <= 1e-4 * step + 1.2e-7 * ref.x.abs()
                         + 1e-12).all())
        ok = (torch.allclose(out.m, ref.m, rtol=1e-5, atol=1e-9)
              and torch.allclose(out.v, ref.v, rtol=1e-5, atol=1e-14)
              and er < 1e-5 and ed < 1e-4 and x_ok)
        log(f"check {name:26s} {str(shape):22s} x {xdt:8s} g {gdt:8s} "
            f"|dm| {em:.2e} |dv| {ev:.2e} |dx| {ex:.2e} ratio rel {er:.2e} "
            f"dsq rel {ed:.2e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version on {name}")
        errs["lamb_moments"] = max(errs["lamb_moments"], em, ev)
        errs["lamb_apply"] = max(errs["lamb_apply"], ex)
        del x, g, m, v, ref, out, x0, step
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU on a small input
# ---------------------------------------------------------------------------

def check_against_cpu(device) -> None:
    import torch

    from repro_torch.configs import bert_large
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import warmup_poly_decay
    from repro_torch.data import batch_iterator
    from repro_torch.kernels import FusedLambState
    from repro_torch.models import build_model
    from repro_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bert_large.smoke().replace(activation_dtype="float32",
                                     use_flash_kernel=False, use_fused_ce_head=False)
    tc = TrainConfig(optimizer="lamb", use_fused_lamb=True, accum_steps=2,
                     learning_rate=0.01)
    init, step = make_train_step(build_model(cfg), tc, warmup_poly_decay(0.01, 10, 0))
    cpu = init(0, "cpu")

    def to(state, dev):
        o = state.opt_state
        c = lambda d: {k: v.to(dev, copy=True) for k, v in d.items()}  # noqa: E731
        return TrainState(c(state.params), FusedLambState(
            o.count.to(dev, copy=True), o.sched_count.to(dev, copy=True), c(o.mu), c(o.nu)))

    gpu = to(cpu, device)
    data = batch_iterator(cfg, 8, 32, seed=3)
    for i in range(2):
        b = next(data)
        cpu, mc = step(cpu, {k: torch.from_numpy(v) for k, v in b.items()})
        gpu, mg = step(gpu, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        lc, lg = float(mc["loss/total"]), float(mg["loss/total"])
        uc, ug = float(mc["update_norm"]), float(mg["update_norm"])
        log(f"reference step {i + 1}: loss cuda {lg:.7f} cpu {lc:.7f}; "
            f"update norm cuda {ug:.7f} cpu {uc:.7f}")
        if not (math.isclose(lg, lc, rel_tol=1e-4) and math.isclose(ug, uc, rel_tol=1e-4)):
            raise AssertionError("bert-smoke steps on the card disagree with the CPU")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def run_main_path(device) -> dict:
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    trainer = launch_train.main(MAIN_ARGV)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)

    hist = trainer.history
    n_leaves = len(trainer.state.params)
    if len(hist) != MAIN_STEPS or n_leaves != 13:
        raise AssertionError(f"{len(hist)} logged steps, {n_leaves} leaves")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("loss/total", "grad_norm", "update_norm")):
            raise AssertionError(f"non-finite metrics at step {h['step']}: {h}")
    want = n_leaves * MAIN_STEPS
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name} launched {n} times on the main path, want {want}")
    # the same seed gives the same initial weights.  Every leaf under the
    # trust ratio must have moved (its step is lr·‖x‖-sized whatever the
    # gradient's scale); a leaf without it (norm scales and biases) moves by
    # lr·m̂/(√v̂+eps), which after clipping can be below half an ulp of 1.0.
    # The distance travelled must also fit the per-step update norms the
    # kernels reported: 0 < ‖x6 − x0‖ <= Σ_t ‖x_t − x_{t−1}‖.
    init = trainer.model.init(trainer.tc.seed, device)
    trust = trainer.model.trust_mask()
    moved_sq = 0.0
    still = []
    for k, p in trainer.state.params.items():
        d = float((p - init[k]).float().square().sum())
        moved_sq += d
        if d == 0.0:
            still.append(k)
    del init
    travelled = sum(h["update_norm"] for h in hist)
    log(f"main path: grad norms {[round(h['grad_norm'], 3) for h in hist]}, update norms "
        f"{[round(h['update_norm'], 4) for h in hist]}, |x6 - x0| {math.sqrt(moved_sq):.4f}, "
        f"leaves that did not move: {still}")
    if [k for k in still if trust[k]] or not 0.0 < math.sqrt(moved_sq) <= travelled * 1.0001:
        raise AssertionError("the parameters did not move as the kernels reported")
    walls = [h["wall_s"] for h in hist]
    steady = [b - a for a, b in zip(walls[1:], walls[2:])]  # steps 3..6
    step_s = sum(steady) / len(steady)
    tokens = 64 * 128
    log(f"main path: losses {[round(h['loss/total'], 4) for h in hist]}")
    log(f"main path: first step {walls[0]:.3f} s, steps 3-{MAIN_STEPS} "
        f"{[round(s, 4) for s in steady]} s, mean {step_s * 1e3:.1f} ms/step, "
        f"{tokens / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    log(f"main path: launches {launches}")
    del trainer
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: timing over one full BERT-large update
# ---------------------------------------------------------------------------

def time_kernels(device, rate: float) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import lamb_apply, lamb_moments
    from repro_torch.kernels.lamb_update import bias_corrections
    from repro_torch.models import build_model
    from repro_torch.nn import flatten

    model = build_model(get_config("bert-large").replace(
        use_flash_kernel=False, use_fused_ce_head=False))
    axes = model.layer_axes()
    gen = torch.Generator(device=device).manual_seed(1)
    leaves = []
    for k, p in flatten(model.defs).items():
        layers = p.shape[0] if axes[k] == 0 else 1
        x = 0.05 * torch.randn(p.shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(p.shape, generator=gen, device=device)
        m = torch.zeros_like(x)
        v = torch.zeros_like(x)
        ratio = torch.full((layers,), 1e-3, device=device)
        leaves.append((x, g, m, v, ratio, layers))
    c = bias_corrections(torch.tensor(5, device=device), 0.9, 0.999, device)
    n = sum(x.numel() for x, *_ in leaves)

    def moments(plain):
        for x, g, m, v, _, layers in leaves:
            lamb_moments(x, g, m, v, c, layers, plain=plain)

    def apply(plain):
        for x, _, m, v, ratio, layers in leaves:
            lamb_apply(x, m, v, c, ratio, layers, plain=plain)

    def ms(fn, plain, reps=10):
        fn(plain)
        fn(plain)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(plain)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # bytes each function must move: inputs read once, outputs written once
    fp32 = 4
    bytes_ = {"lamb_moments": n * fp32 * (4 + 2), "lamb_apply": n * fp32 * (3 + 1)}
    flops = {"lamb_moments": n * 16, "lamb_apply": n * 9}
    fns = {"lamb_moments": moments, "lamb_apply": apply}
    # plain, kernel, kernel, plain: the two versions compared within one call
    times = {name: {"plain": [], "cuda": []} for name in fns}
    for name, fn in fns.items():
        for plain in (True, False, False, True):
            times[name]["plain" if plain else "cuda"].append(ms(fn, plain))
    out = {}
    for name in fns:
        t_k = min(times[name]["cuda"])
        t_p = min(times[name]["plain"])
        bound = max(bytes_[name] / rate, flops[name] / 67e12) * 1e3
        out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by="bytes"
                         if bytes_[name] / rate >= flops[name] / 67e12 else "operations")
        log(f"time {name}: kernel {times[name]['cuda']} ms, plain {times[name]['plain']} ms "
            f"over {n} elements in 13 leaves; bound {bound:.3f} ms "
            f"({bytes_[name] / 1e9:.2f} GB at {rate / 1e12:.2f} TB/s); "
            f"{bytes_[name] / (t_k * 1e-3) / 1e12:.2f} TB/s achieved")
    log("time library: none; no single PyTorch call computes a LAMB update")
    log(f"time full update (K1 + K2): kernel {out['lamb_moments']['ms'] + out['lamb_apply']['ms']:.3f}"
        f" ms, plain {out['lamb_moments']['plain_ms'] + out['lamb_apply']['plain_ms']:.3f} ms")
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(src/repro_torch not found)")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    log(card)
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s wall)")
    for src in build.SOURCES:
        for line in (build.BUILD_DIR / f"{src}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    errs = check_kernels(device)
    check_against_cpu(device)
    launches = run_main_path(device)
    timing = time_kernels(device, rate)

    kernels = [dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errs[k],
                    **timing[k], library_ms=None) for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
