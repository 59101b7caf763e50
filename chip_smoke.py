#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card: its name and power limit from ``nvidia-smi``;
2. build: the CUDA kernels, from ``src/repro_torch/kernels/csrc``, with
   ``nvcc`` for ``sm_90a`` into ``build/`` (one ``nvcc`` per source, in
   parallel); ptxas's registers and spills per kernel;
3. kernels vs plain: the fused LAMB kernels K1 (``lamb_moments``) and K2
   (``lamb_apply``) against their plain PyTorch version on the same inputs,
   at BERT-large leaf shapes, and with the non-finite guard's flag ``ok``:
   0 (x, m and v bit-identical, Σ(x'−x)² 0, as in the plain version) and 1
   (the bits of the call without a flag); the flash-attention kernels K3 (``flash_fwd``),
   K4 (``flash_dq``) and K5 (``flash_dkv``), forward and backward through
   the autograd boundary, against the plain version at the main path's
   shape, at seq 512 and under causal, window, ragged-length, GQA,
   cross-length, model-layout and head-dim 16, 32 and 128 cases (bf16 K3,
   K4 and K5 on the tensor cores, fp32 on the FMA kernels), and K4 and K5
   run twice for equal bits; the fused CE kernels K6
   (``fused_ce_fwd``), K7 (``fused_ce_dh``) and K8 (``fused_ce_dw``), forward
   and backward through the autograd boundary, against the plain version at
   the main path's shape, at seq 512, with ragged rows, vocab and D, in the
   model's layout, in fp32, with zero cotangents and with all-zero rows
   (ties) (bf16 K6, K7 and K8 on the tensor cores, fp32 and bf16 rows off
   a 16-byte boundary on the FMA kernels), and K7 and K8 run twice for equal
   bits;
4. reference: two bert-smoke fp32 train steps with flash attention and the
   fused CE head on the card against the same steps on the CPU (the CPU path
   is the plain version the test suite holds to the JAX package);
5. main path: ``repro_torch.launch.train`` on full-width BERT-large
   (24 layers, d 1024, vocab 30522), batch 64 × seq 128, accum 2, bf16,
   fused LAMB, flash attention, fused CE head, 6 steps; finite losses, moved
   weights, every LAMB kernel launched 13 leaves × 6 steps times, every flash
   kernel 24 layers × 2 micro-batches × 6 steps times and every fused CE
   kernel 2 micro-batches × 6 steps times, every K3–K8 launch on the
   tensor-core kernel and no copy of ``do``; then 3 steps at seq 512
   (batch 32, accum 2) with their own counts;
6. timing with CUDA events: K1 and K2 over one full BERT-large update
   (also with the guard's flag), and K3–K8 at the main path's shape and at seq 512, each beside its plain
   version and its bound; ``scaled_dot_product_attention`` (beside K3–K5)
   and the dense head's ``matmul`` + ``cross_entropy`` pair (beside K6–K8)
   are timed as yardsticks only (the port never calls them); bf16 K6, K7
   and K8 also in their FMA design;
7. this slice's path at full width: the §4.1 two-stage run
   (``--mixed-batch``: 4 steps at seq 128 and batch 64, then 2 at seq 512
   and batch 16 on the same optimizer state) with the non-finite guard on,
   its counters and launch counts; the guard on the card (a ``grad_nan``
   step leaves params, moments and counters bit-identical, K1/K2 still
   launched); and a 4.0 GB checkpoint: written async after 2 steps,
   restored bit for bit by a fresh trainer with ``--resume``, continued to
   4 steps bit-equal to an uninterrupted run, with the sync and async save
   times.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_STEPS = 6
MAIN_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb",
    "--steps", str(MAIN_STEPS), "--log-every", "1",
]
SEQ512_STEPS = 3
SEQ512_ARGV = [
    "--arch", "bert-large", "--batch", "32", "--seq", "512", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb",
    "--steps", str(SEQ512_STEPS), "--log-every", "1",
]
# phase 7: the §4.1 two-stage run (4 steps at seq 128, batch 64, then 2 at
# seq 512, batch 16, re-warmed) with the guard on, and the 4-step runs of the
# checkpoint check (a save after 2 steps, a resume to 4)
STAGES_STEPS = 6
STAGES_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--mixed-batch", "--skip-nonfinite",
    "--steps", str(STAGES_STEPS), "--log-every", "1",
]
RESUME_ARGV = [
    "--arch", "bert-large", "--batch", "64", "--seq", "128", "--accum-steps", "2",
    "--precision", "bf16", "--fused-lamb", "--steps", "4", "--log-every", "1",
]
LAYERS, LEAVES, ACCUM = 24, 13, 2
# a full-width train state: 333,344,768 fp32 parameters × 3 (params, mu, nu)
STATE_BYTES = 333_344_768 * 4 * 3

# Device-memory rate of the card by name (NVIDIA data sheets), for the bound.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}
# Peak operation rates of an H100 SXM (data sheet, dense): bf16 on the tensor
# cores, fp32 outside them.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

KERNELS = {
    "lamb_moments": dict(route="cuda",
                         source="src/repro_torch/kernels/csrc/lamb_update.cu",
                         replaces="src/repro/kernels/lamb_update.py:31"),
    "lamb_apply": dict(route="cuda",
                       source="src/repro_torch/kernels/csrc/lamb_update.cu",
                       replaces="src/repro/kernels/lamb_update.py:50"),
    "flash_fwd": dict(route="cuda",
                      source="src/repro_torch/kernels/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention.py:122",
                      design="bf16: flash_fwd_mma_kernel, mma.sync m16n8k16 on the tensor "
                             "cores, q in registers, k/v in a 2-stage cp.async ring, p as "
                             "three bf16 terms; fp32: flash_fwd_kernel, FMA"),
    "flash_dq": dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:213",
                     design="bf16: flash_dq_mma_kernel, mma.sync m16n8k16 on the tensor "
                            "cores, q/do in registers, k/v in a 2-stage cp.async ring, ds as "
                            "bf16 hi+lo into dq += ds k; fp32: flash_dq_kernel, FMA"),
    "flash_dkv": dict(route="cuda",
                      source="src/repro_torch/kernels/csrc/flash_attention.cu",
                      replaces="src/repro/kernels/flash_attention.py:246",
                      design="bf16: flash_dkv_mma_kernel, mma.sync m16n8k16 on the tensor "
                             "cores, k/v in shared memory, q/do/lse/di in a 2-stage cp.async "
                             "ring, p and ds as bf16 hi+lo, dk/dv in fp32 registers; fp32: "
                             "flash_dkv_kernel, FMA"),
    "fused_ce_fwd": dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_ce.cu",
                         replaces="src/repro/kernels/fused_ce.py:87",
                         design="bf16: fused_ce_fwd_mma_kernel, mma.sync m16n8k16 on the "
                                "tensor cores, 64 h rows resident over all of D, w in 64-column "
                                "chunks through a 4-slot cp.async ring, online max/sum/argmax "
                                "on the fragments, vocab split across blocks, + combine; fp32: "
                                "fused_ce_fwd_kernel, FMA"),
    "fused_ce_dh": dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_ce.cu",
                        replaces="src/repro/kernels/fused_ce.py:162",
                        design="bf16: fused_ce_dh_mma_kernel, mma.sync m16n8k16 on the tensor "
                               "cores, 32 h rows and a 64-row w tile resident over all of D, "
                               "refilled by cp.async two D chunks at a time, dlogits as bf16 "
                               "hi+lo, 32 x D fp32 accumulator in registers, vocab split "
                               "across blocks; fp32: fused_ce_dh_kernel, FMA"),
    "fused_ce_dw": dict(route="cuda", source="src/repro_torch/kernels/csrc/fused_ce.cu",
                        replaces="src/repro/kernels/fused_ce.py:184",
                        design="bf16: fused_ce_dw_mma_kernel, as fused_ce_dh_mma_kernel with "
                               "a 32-row dw tile per block over every row of h; fp32: "
                               "fused_ce_dw_kernel, FMA"),
}
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
FUSED_CE = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")

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


# Flash-attention checks: (name, b, h, hkv, s, t, d, causal, window, kv_valid
# or None, dtype, layout).  The first two are the shapes the main path gives
# the kernels at seq 128 and 512.  Layout "bshd": q, k, v and do are the
# model's (B, S, H, D) tensors seen as (B, H, S, D) views, as flash_sdpa
# hands them over.
FLASH_CASES = [
    ("main path", 32, 16, 16, 128, 128, 64, False, 0, None, "bfloat16", "bhsd"),
    ("seq 512", 16, 16, 16, 512, 512, 64, False, 0, None, "bfloat16", "bhsd"),
    ("causal", 4, 16, 16, 256, 256, 64, True, 0, None, "bfloat16", "bhsd"),
    ("window", 4, 8, 8, 512, 512, 64, True, 128, None, "float32", "bhsd"),
    ("valid + window, dead rows", 3, 4, 4, 300, 300, 64, True, 64, [40, 300, 177], "float32",
     "bhsd"),
    ("valid + window, dead rows", 3, 4, 4, 300, 300, 64, True, 64, [40, 300, 177], "bfloat16",
     "bhsd"),
    ("ragged valid", 4, 16, 16, 128, 128, 64, False, 0, [128, 77, 1, 0], "bfloat16", "bhsd"),
    ("ragged S = T", 4, 16, 16, 200, 200, 64, False, 0, None, "bfloat16", "bhsd"),
    ("GQA 8/2 + valid", 4, 8, 2, 256, 256, 64, False, 0, [256, 200, 31, 129], "bfloat16",
     "bhsd"),
    ("model layout, GQA 16/4", 8, 16, 4, 128, 128, 64, False, 0,
     [128, 100, 64, 1, 128, 77, 128, 5], "bfloat16", "bshd"),
    ("cross-length causal", 4, 8, 8, 128, 384, 64, True, 0, None, "float32", "bhsd"),
    ("D 16", 4, 8, 8, 256, 256, 16, False, 0, [256, 100, 17, 256], "bfloat16", "bhsd"),
    ("D 32 causal", 4, 8, 8, 320, 320, 32, True, 0, None, "bfloat16", "bhsd"),
    ("D 128 fp32", 4, 8, 8, 384, 384, 128, True, 0, None, "float32", "bhsd"),
    ("D 128 bf16", 4, 8, 8, 384, 384, 128, False, 0, None, "bfloat16", "bhsd"),
]
# Flash timing shapes (b, h, s, d): what the main path gives the kernels.
FLASH_TIMING = [("seq 128", 32, 16, 128, 64), ("seq 512", 16, 16, 512, 64)]

# Fused CE checks: (name, n, d, v, dtype, layout).  The first two are the
# shapes the main path gives the kernels: 32 sequences × 20 gathered positions
# at seq 128, 16 × 77 at seq 512, against the tied (30522, 1024) embedding.
# Layout "dense": h a contiguous (n, d) tensor; "model": h the rows
# gather_supervised takes from a (32, 128, d) hidden state, as the model's
# loss hands them over, against w cast from an fp32 embedding as the step
# casts its masters; "offset": h starts 2 bytes past a 16-byte boundary, so
# bf16 K7 and K8 take the FMA design.
CE_CASES = [
    ("main path", 640, 1024, 30522, "bfloat16", "dense"),
    ("seq 512", 1232, 1024, 30522, "bfloat16", "dense"),
    ("ragged rows and vocab", 97, 1024, 300, "bfloat16", "dense"),
    ("fp32", 640, 1024, 30522, "float32", "dense"),
    ("ragged fp32, D 80", 97, 80, 300, "float32", "dense"),
    ("ragged bf16, D 80", 97, 80, 300, "bfloat16", "dense"),
    ("bf16 D 1000, N 333", 333, 1000, 5003, "bfloat16", "dense"),
    ("model layout", 640, 1024, 30522, "bfloat16", "model"),
    ("bf16 rows off 16 bytes", 97, 1024, 300, "bfloat16", "offset"),
]
# Fused CE timing shapes (n rows; D 1024, V 30522, bf16).
CE_TIMING = [("seq 128", 640), ("seq 512", 1232)]
CE_D, CE_V = 1024, 30522


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


def ptxas_lines(log_text: str) -> list:
    """The registers and spill lines of ptxas's report, each after the
    kernel it belongs to (``name<dtype, D>``)."""
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.strip()}")
    return out


def _kernel_name(sym: str) -> str:
    """``flash_fwd_mma_kernel<64>`` from its mangled name in the anonymous
    namespace (types: f = fp32, __nv_bfloat16 = bf16; ints: Li64E = 64)."""
    m = re.match(r"_ZN(\d+)", sym)
    if not m:
        return sym
    at = m.end() + int(m.group(1))   # past the namespace's name
    m = re.match(r"\d+", sym[at:])
    if not m:
        return sym
    at, n = at + m.end(), int(m.group())
    name, args = sym[at:at + n], sym[at + n:]
    targs = args[1:args.find("EEv") + 1] if args.startswith("I") else ""
    shown = ["bf16" if t.group(0).startswith("13") else t.group(1) or "fp32"
             for t in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f", targs)]
    return f"{name}<{', '.join(shown)}>" if shown else name


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
        x0, m0, v0 = x.clone(), m.clone(), v.clone()
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
        check_ok_flag(name, x0, g, m0, v0, count, lr, kw)
        del x, g, m, v, ref, out, x0, m0, v0, step
    torch.cuda.empty_cache()
    return errs


def check_ok_flag(name, x, g, m, v, count, lr, kw) -> None:
    """K1/K2 with the guard's flag: ``ok`` 0 stores nothing (x, m, v equal to
    the inputs bit for bit, Σ(x'−x)² exactly 0), as the plain version does;
    ``ok`` 1 gives the bits of the call without a flag.  Raises otherwise."""
    import torch

    from repro_torch.kernels import lamb_update

    def run(flag, plain=False):
        ok = None if flag is None else torch.tensor(flag, dtype=torch.int32, device=x.device)
        return lamb_update(x.clone(), g, m.clone(), v.clone(), count, lr, ok=ok,
                           plain=plain, **kw)

    skip, skip_plain = run(0), run(0, plain=True)
    taken, bare = run(1), run(None)
    torch.cuda.synchronize()
    skip_ok = all(torch.equal(a, b) for out in (skip, skip_plain)
                  for a, b in zip((out.x, out.m, out.v), (x, m, v))) \
        and float(skip.delta_sq) == 0.0 == float(skip_plain.delta_sq)
    taken_ok = all(torch.equal(a, b) for a, b in zip(
        (taken.x, taken.m, taken.v, taken.delta_sq), (bare.x, bare.m, bare.v, bare.delta_sq)))
    log(f"check {name:26s} ok=0: x, m, v unchanged and dsq 0 (kernel and plain) "
        f"{skip_ok}; ok=1 equal to no flag bit for bit {taken_ok}")
    if not (skip_ok and taken_ok):
        raise AssertionError(f"K1/K2 do not honour the ok flag on {name}")


def check_flash(device) -> dict:
    """Max abs errors per flash kernel over FLASH_CASES; raises on a mismatch.

    The kernels run through the autograd boundary (K3, then K4 and K5);
    each is held against the plain version on the same inputs: the forward
    on q, k, v, the backward on the kernel forward's residuals (o, lse) and
    do.  Both sides compute in fp32 from those inputs, in another order (the
    kernel's sums against cuBLAS), so fp32 outputs agree to 1e-4 relative
    plus 1e-4 of the tensor's largest magnitude; bf16 outputs round those
    fp32 values, so they may differ by one bf16 ulp (2^-7 relative): 1e-2
    relative plus the same absolute term.  lse is fp32: 1e-5.  A bf16 o
    that rounds to the other neighbouring value changes di = rowsum(o do),
    and through the cancelling dp - di the dq of its row by more than an
    ulp; so the plain backward from the plain forward's own o is not the
    same input, and how far the two chains part is logged, not held.
    """
    import torch

    from repro_torch.kernels.flash_attention import FlashSpec, flash_attention, \
        flash_attention_bwd, flash_attention_fwd, flash_dkv, flash_dq, row_dot

    errs = dict.fromkeys(FLASH, 0.0)
    gen = torch.Generator(device=device).manual_seed(2)

    def make(b, heads, n, d, dtype, layout):
        if layout == "bshd":
            x = torch.randn((b, n, heads, d), generator=gen, device=device)
            return x.to(dtype).transpose(1, 2)
        return torch.randn((b, heads, n, d), generator=gen, device=device).to(dtype)

    for name, b, h, hkv, s, t, d, causal, window, valid, dt, layout in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, do = (make(b, h, s, d, dtype, layout) for _ in range(2))
        k, v = (make(b, hkv, t, d, dtype, layout) for _ in range(2))
        kv_valid = None if valid is None else torch.tensor(valid, dtype=torch.int32,
                                                           device=device)
        outs = {}
        for plain in (True, False):
            qkv = [x.clone().requires_grad_() for x in (q, k, v)]
            o = flash_attention(*qkv, kv_valid, causal=causal, window=window, plain=plain)
            outs[plain] = [o.detach(), *torch.autograd.grad(o, qkv, do)]
        lim = None if valid is None else kv_valid.clamp(1, t)
        spec = FlashSpec(d**-0.5, causal, window, valid is not None)
        (o_k, lse), (o_ref, lse_ref) = (flash_attention_fwd(q, k, v, lim, spec, plain=p)
                                        for p in (False, True))
        same_inputs = [o_ref, *flash_attention_bwd(q, k, v, lim, o_k, lse, do, spec, plain=True)]
        torch.cuda.synchronize()
        rtol = 1e-2 if dt == "bfloat16" else 1e-4
        ok = bool(torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5))
        diffs, parted = [], []
        for a, r, c in zip(outs[False], same_inputs, outs[True]):
            a, r, c = a.float(), r.float(), c.float()
            atol = 1e-4 * max(1.0, float(r.abs().max()))
            ok = ok and bool(torch.isfinite(a).all()) and bool(
                torch.allclose(a, r, rtol=rtol, atol=atol))
            diffs.append(float((a - r).abs().max()))
            parted.append(int(((a - c).abs() > rtol * c.abs() + atol).sum()))
        if valid is not None and window:
            # rows where window ∩ valid is empty: o = 0 and dq = 0 exactly
            rows = torch.arange(s, device=device)
            dead = rows[None, :] > lim[:, None] + window - 2 - (t - s)   # (b, s)
            dead_o = outs[False][0].float()[dead[:, None, :, None].expand(b, h, s, d)]
            dead_dq = outs[False][1].float()[dead[:, None, :, None].expand(b, h, s, d)]
            ok = ok and int(dead.sum()) > 0 and float(dead_o.abs().max()) == 0.0 \
                and float(dead_dq.abs().max()) == 0.0
        log(f"check flash {name:26s} q {(b, h, s, d)} kv {(hkv, t)} causal {causal} "
            f"window {window} valid {valid} {dt} {layout}: |do| {diffs[0]:.2e} "
            f"|ddq| {diffs[1]:.2e} "
            f"|ddk| {diffs[2]:.2e} |ddv| {diffs[3]:.2e} |dlse| "
            f"{float((lse - lse_ref).abs().max()):.2e} (rtol {rtol:g}) "
            f"{'ok' if ok else 'MISMATCH'}; against the plain chain, elements past "
            f"that tolerance (o, dq, dk, dv): {parted} of {q.numel()}")
        if not ok:
            raise AssertionError(f"flash kernels disagree with the plain version on {name}")
        errs["flash_fwd"] = max(errs["flash_fwd"], diffs[0])
        errs["flash_dq"] = max(errs["flash_dq"], diffs[1])
        errs["flash_dkv"] = max(errs["flash_dkv"], diffs[2], diffs[3])
        del q, k, v, do, outs, same_inputs, o_k, o_ref
    # K4 and K5 own their dq and dk/dv tiles and sum in a fixed order: two
    # runs, equal bits
    for name, b, h, hkv, s, t, d, causal, window, valid, dt, layout in (
            FLASH_CASES[0], next(c for c in FLASH_CASES if c[0] == "GQA 8/2 + valid")):
        dtype = getattr(torch, dt)
        q, do = (make(b, h, s, d, dtype, layout) for _ in range(2))
        k, v = (make(b, hkv, t, d, dtype, layout) for _ in range(2))
        lim = None if valid is None else torch.tensor(valid, dtype=torch.int32,
                                                      device=device).clamp(1, t)
        spec = FlashSpec(d**-0.5, causal, window, valid is not None)
        o, lse = flash_attention_fwd(q, k, v, lim, spec)
        di = row_dot(o, do)
        runs = [(flash_dq(q, k, v, lim, lse, di, do, spec),
                 *flash_dkv(q, k, v, lim, lse, di, do, spec)) for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        log(f"check flash_dq, flash_dkv {name}: two runs {'equal' if same else 'DIFFER'} "
            f"bit for bit")
        if not same:
            raise AssertionError(f"flash_dq or flash_dkv is not bit-reproducible on {name}")
        del q, k, v, do, o, lse, di, runs
    torch.cuda.empty_cache()
    return errs


def ce_operand(x, layout: str):
    """``x`` (n, d) as the tensor the kernels are handed in CE_CASES's
    ``layout``, made from a fresh leaf that requires grad; gradients are
    taken against it."""
    import torch

    from repro_torch.train.loss import IGNORE, gather_supervised

    n, d = x.shape
    if layout == "dense":
        return x.clone().requires_grad_()
    if layout == "offset":
        leaf = x.clone().requires_grad_()
        return torch.cat([x.new_zeros(1), leaf.reshape(-1)])[1:].view(n, d)
    b, s = 32, 128                  # layout "model": n = 32 sequences × n / 32 rows
    p = n // b
    pos = torch.stack([torch.randperm(s, device=x.device)[:p].sort().values for _ in range(b)])
    leaf = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    leaf[torch.arange(b, device=x.device)[:, None], pos] = x.view(b, p, d)
    leaf.requires_grad_()
    labels = torch.full((b, s), IGNORE, dtype=torch.int32, device=x.device)
    labels[torch.arange(b, device=x.device)[:, None], pos] = 0
    return gather_supervised(leaf, labels, p)[0].reshape(n, d)


def check_fused_ce(device) -> dict:
    """Max abs errors per fused CE kernel over CE_CASES; raises on a mismatch.

    Inputs: h with std 1 whose first quarter of rows is all zero (every logit
    0, so the argmax is column 0: ties), w with std 0.05, labels at 0 and
    V − 1, the argmax on every other row (so ``correct`` is exercised) and
    random elsewhere, a cotangent that is 0 on every third row.  Both sides
    compute in fp32 from the same inputs in another order (the kernel's sums
    against cuBLAS; in the tensor-core design the dlogits enter the second
    product as two bf16 terms, ~16 bits), so nll and lse agree to 1e-5;
    ``correct`` is equal except where the label's logit ties the maximum
    within fp32 rounding; fp32 gradients agree to 1e-4 relative plus 1e-5 of
    the tensor's largest magnitude, bf16 gradients round those fp32 values,
    so one bf16 ulp (2^-7 relative) apart at most: 1e-2 relative plus 1e-4
    of the largest.  Rows with a zero cotangent must get exactly zero dh.
    Every case checks which design K6, K7 and K8 ran: the tensor cores for
    bf16 they can stage, FMA otherwise.  Then K7 and K8 run twice on two cases
    and must give equal bits.
    """
    import torch

    from repro_torch.kernels import VARIANT_LAUNCHES, reset_launches
    from repro_torch.kernels.fused_ce import fused_ce, fused_ce_dh, fused_ce_dw, fused_ce_fwd

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32
    errs = dict.fromkeys(FUSED_CE, 0.0)
    gen = torch.Generator(device=device).manual_seed(4)
    torch.manual_seed(4)   # the model layout's positions

    def make(n, d, v, dtype):
        rows = torch.arange(n, device=device)
        h = torch.randn((n, d), generator=gen, device=device)
        h[: n // 4] = 0.0
        h = h.to(dtype)
        w = (0.05 * torch.randn((v, d), generator=gen, device=device)).to(dtype)
        logits = h.float() @ w.float().t()
        lbl = torch.randint(0, v, (n,), generator=gen, device=device, dtype=torch.int32)
        lbl = torch.where(rows % 2 == 0, logits.argmax(1).to(torch.int32), lbl)
        lbl[0], lbl[1] = 0, v - 1
        g = torch.rand((n,), generator=gen, device=device)
        g[rows % 3 == 1] = 0.0
        return h, w, logits, lbl, g

    for name, n, d, v, dt, layout in CE_CASES:
        dtype = getattr(torch, dt)
        rows = torch.arange(n, device=device)
        h, w, logits, lbl, g = make(n, d, v, dtype)
        outs = {}
        for plain in (True, False):
            hh = ce_operand(h, "dense" if plain else layout)
            ww = w.clone().requires_grad_()
            reset_launches()
            nll, correct = fused_ce(hh, ww, lbl, plain=plain)
            outs[plain] = [nll.detach(), correct, *torch.autograd.grad(nll, (hh, ww), g)]
        designs = {k: dict(VARIANT_LAUNCHES[k]) for k in FUSED_CE}
        want = "mma" if dtype == torch.bfloat16 and layout != "offset" else "fma"
        design_ok = all(c == {"mma": int(want == "mma"), "fma": int(want == "fma")}
                        for c in designs.values())
        lse, lse_ref = (fused_ce_fwd(h, w, lbl, plain=p)[2] for p in (False, True))
        torch.cuda.synchronize()
        (nll, correct, dh, dw), (nll_r, correct_r, dh_r, dw_r) = outs[False], outs[True]
        ok = bool(torch.allclose(nll, nll_r, rtol=1e-5, atol=1e-5)
                  and torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5))
        flips = correct != correct_r
        if bool(flips.any()):
            top = logits.amax(1)
            gap = (top - logits.gather(1, lbl.long()[:, None])[:, 0]).abs()
            ok = ok and bool((gap[flips] <= 1e-5 * (1 + top[flips].abs())).all())
        bf16 = dtype == torch.bfloat16
        diffs = []
        for a, r in ((dh, dh_r), (dw, dw_r)):
            a, r = a.float(), r.float()
            scale = max(float(r.abs().max()), 1e-30)
            ok = ok and bool(torch.isfinite(a).all()) and bool(torch.allclose(
                a, r, rtol=1e-2 if bf16 else 1e-4, atol=(1e-4 if bf16 else 1e-5) * scale))
            diffs.append(float((a - r).abs().max()))
        zero = rows < n // 4
        ties_ok = torch.equal(correct[zero], (lbl[zero] == 0).float())
        still_ok = float(dh[g == 0].abs().max()) == 0.0
        ok = ok and ties_ok and still_ok and design_ok
        e_fwd = max(float((nll - nll_r).abs().max()), float((lse - lse_ref).abs().max()))
        log(f"check fused CE {name:24s} n {n} d {d} v {v} {dt} {layout}: |dnll|,|dlse| "
            f"{e_fwd:.2e} correct flips {int(flips.sum())} of {n} (label wins on "
            f"{int(correct_r.sum())}) |ddh| {diffs[0]:.2e} |ddw| {diffs[1]:.2e} ties {ties_ok} "
            f"zero-g rows {still_ok} K6-K8 designs {designs} (want {want}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"fused CE kernels disagree with the plain version on {name}")
        errs["fused_ce_fwd"] = max(errs["fused_ce_fwd"], e_fwd)
        errs["fused_ce_dh"] = max(errs["fused_ce_dh"], diffs[0])
        errs["fused_ce_dw"] = max(errs["fused_ce_dw"], diffs[1])
        del h, w, logits, outs, dh, dw, dh_r, dw_r
    # K7 and K8 own their outputs (no atomics; K7's splits summed in order):
    # two runs, equal bits
    for name, n, d, v, dt, _ in (CE_CASES[0], next(c for c in CE_CASES if "N 333" in c[0])):
        h, w, _, lbl, g = make(n, d, v, getattr(torch, dt))
        lse = fused_ce_fwd(h, w, lbl)[2]
        same = all(torch.equal(*(fn(h, w, lbl, lse, g) for _ in range(2)))
                   for fn in (fused_ce_dh, fused_ce_dw))
        log(f"check fused_ce_dh, fused_ce_dw {name}: two runs "
            f"{'equal' if same else 'DIFFER'} bit for bit")
        if not same:
            raise AssertionError(f"fused CE backward is not bit-reproducible on {name}")
        del h, w, lbl, g, lse
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
    from repro_torch.kernels import LAUNCHES, FusedLambState, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bert_large.smoke().replace(activation_dtype="float32", use_flash_kernel=True,
                                     use_fused_ce_head=True)
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
    reset_launches()
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
    want = 2 * cfg.n_layers * 2  # steps × layers × micro-batches
    if any(LAUNCHES[k] != want for k in FLASH) or any(LAUNCHES[k] != 2 * 2 for k in FUSED_CE):
        raise AssertionError(f"kernels launched {LAUNCHES}, want {want} of each flash "
                             "kernel and 4 of each fused CE kernel")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def _want_launches(steps: int) -> dict:
    want = dict.fromkeys(("lamb_moments", "lamb_apply"), LEAVES * steps)
    want.update(dict.fromkeys(FLASH, LAYERS * ACCUM * steps))
    want.update(dict.fromkeys(FUSED_CE, ACCUM * steps))
    return want


def _train(device, argv, steps, label):
    """One launcher run with the counts set to 0 just before it; raises on
    non-finite metrics or launch counts off the path's shape."""
    import torch

    from repro_torch.kernels import COPIES, LAUNCHES, VARIANT_LAUNCHES, reset_launches
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    trainer = launch_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    designs = {k: dict(v) for k, v in VARIANT_LAUNCHES.items()}
    copies = dict(COPIES)
    peak = torch.cuda.max_memory_allocated(device)

    hist = trainer.history
    n_leaves = len(trainer.state.params)
    cfg = trainer.model.cfg
    if len(hist) != steps or n_leaves != LEAVES or not cfg.use_flash_kernel \
            or not cfg.use_fused_ce_head:
        raise AssertionError(f"{len(hist)} logged steps, {n_leaves} leaves, flash "
                             f"{cfg.use_flash_kernel}, fused CE {cfg.use_fused_ce_head}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("loss/total", "grad_norm", "update_norm")):
            raise AssertionError(f"non-finite metrics at step {h['step']}: {h}")
    if launches != _want_launches(steps):
        raise AssertionError(f"{label}: launches {launches}, want {_want_launches(steps)}")
    # bf16 K3–K8 on the tensor cores, every launch; autograd's do read as it
    # came, never copied
    n_flash, n_ce = LAYERS * ACCUM * steps, ACCUM * steps
    want_designs = {**{k: {"mma": n_flash, "fma": 0} for k in FLASH},
                    **{k: {"mma": n_ce, "fma": 0} for k in FUSED_CE}}
    if designs != want_designs or any(copies.values()):
        raise AssertionError(f"{label}: launches by design {designs}, want "
                             f"{want_designs}; copies {copies}, want none")
    walls = [h["wall_s"] for h in hist]
    log(f"{label}: losses {[round(h['loss/total'], 4) for h in hist]}")
    if "--mixed-batch" in argv:
        log(f"{label}: stages {[h['stage'] for h in hist]}, step walls "
            f"{[round(b - a, 4) for a, b in zip([0.0] + walls, walls)]} s (the first of "
            f"each stage includes its warm-up), peak memory {peak / 2**30:.2f} GiB")
    else:
        steady = [b - a for a, b in zip(walls[1:], walls[2:])]  # after two warm-up steps
        step_s = sum(steady) / len(steady)
        batch, seq = (int(argv[argv.index(f) + 1]) for f in ("--batch", "--seq"))
        log(f"{label}: first step {walls[0]:.3f} s, steps 3-{steps} "
            f"{[round(s, 4) for s in steady]} s, mean {step_s * 1e3:.1f} ms/step, "
            f"{batch * seq / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    log(f"{label}: launches {launches}")
    log(f"{label}: launches by design {designs}; input copies {copies}")
    return trainer, launches


def run_main_path(device) -> dict:
    import torch

    trainer, launches = _train(device, MAIN_ARGV, MAIN_STEPS, "main path")
    hist = trainer.history
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
    del trainer
    torch.cuda.empty_cache()
    # the paper's stage-2 length: same model, seq 512
    trainer, _ = _train(device, SEQ512_ARGV, SEQ512_STEPS, "seq 512")
    del trainer
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the two-stage recipe, the guard and checkpoints at full width
# ---------------------------------------------------------------------------

def _state_tensors(state) -> dict:
    """Every tensor of a TrainState by its checkpoint path."""
    from repro_torch.checkpoint import tree_leaves_with_paths

    return dict(tree_leaves_with_paths(state))


def run_two_stages(device):
    """``--mixed-batch --skip-nonfinite`` on full-width BERT-large: every loss
    finite, no step skipped, ``count`` carried over the switch (6),
    ``sched_count`` restarted (2), ``step`` 6, and the launch counts of 6
    steps (each stage with accum 2).  Returns the trainer."""
    trainer, launches = _train(device, STAGES_ARGV, STAGES_STEPS, "two stages")
    hist, state = trainer.history, trainer.state
    o = state.opt_state
    counters = tuple(int(t) for t in (o.count, o.sched_count, state.step, state.skipped))
    skips = [h["nonfinite/skip"] for h in hist]
    log(f"two stages: count, sched_count, step, skipped {counters}; nonfinite/skip {skips}; "
        f"update norms {[round(h['update_norm'], 4) for h in hist]}")
    if [h["stage"] for h in hist] != [0, 0, 0, 0, 1, 1] or counters != (6, 2, 6, 0) \
            or any(skips) or [h["step"] for h in hist] != [1, 2, 3, 4, 5, 6]:
        raise AssertionError("the two-stage run did not carry count, restart sched_count "
                             "and take every step")
    return trainer


def check_guard(trainer, device) -> None:
    """A ``grad_nan`` step at full width with the guard on: params, moments,
    ``count``, ``sched_count`` and ``step`` bit-identical to before, ``skipped``
    + 1, K1 and K2 still launched once per leaf; the next clean step moves
    the weights."""
    import torch

    from repro_torch.data import DataPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train import GUARD_KEY, FaultInjector, FaultSpec, make_train_step

    _, step = make_train_step(trainer.model, trainer.tc, lambda t: torch.full(
        (), 1e-3, device=t.device))
    data = DataPipeline(trainer.model.cfg, 64, 128, device=device, seed=7)
    poisoned = FaultInjector([FaultSpec("grad_nan", at=0)]).stamp(next(data), 0)
    state = trainer.state
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    reset_launches()
    state, m = step(state, poisoned)
    torch.cuda.synchronize()
    k12 = (LAUNCHES["lamb_moments"], LAUNCHES["lamb_apply"])
    after = _state_tensors(state)
    changed = [k for k, v in before.items() if k != "skipped" and not torch.equal(v, after[k])]
    skipped = int(state.skipped) - int(before["skipped"])
    log(f"guard: grad_nan step: nonfinite/skip {float(m[GUARD_KEY])}, update norm "
        f"{float(m['update_norm'])}, leaves changed {changed}, skipped +{skipped}, "
        f"K1/K2 launches {k12}")
    if changed or skipped != 1 or k12 != (LEAVES, LEAVES) or float(m[GUARD_KEY]) != 1.0:
        raise AssertionError("the skipped step was not a bit-exact no-op")
    state, m = step(state, next(data))
    torch.cuda.synchronize()
    moved = sum(not torch.equal(v, state.params[k[len("params/"):]])
                for k, v in before.items() if k.startswith("params/"))
    log(f"guard: next clean step: nonfinite/skip {float(m[GUARD_KEY])}, loss "
        f"{float(m['loss/total']):.4f}, update norm {float(m['update_norm']):.4f}, "
        f"param leaves moved {moved} of {LEAVES}, step {int(state.step)}")
    if float(m[GUARD_KEY]) != 0.0 or moved == 0 or int(state.step) != int(before["step"]) + 1:
        raise AssertionError("the clean step after a skip did not move the weights")
    del before, after


def check_checkpoint_resume(device) -> None:
    """4 uninterrupted steps; then 2 steps with an async checkpoint at step 2,
    the checkpoint restored bit for bit, a sync save timed, and a fresh
    trainer resumed to 4 steps: its losses and params equal to the
    uninterrupted run's.  The checkpoints go to a directory under
    ``build/``, removed in a ``finally``."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from repro_torch.launch.train import build, parse_args

    def run(extra, steps):
        trainer, data, _ = build(parse_args(RESUME_ARGV + extra))
        trainer.log = lambda msg: None
        trainer.fit(data, steps)
        torch.cuda.synchronize()
        return trainer

    ref = run([], 4)
    ref_params = {k: v.cpu() for k, v in ref.state.params.items()}
    ref_losses = [h["loss/total"] for h in ref.history]
    del ref
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="ckpt_"))
    try:
        free = shutil.disk_usage(tmp).free
        ckpt = ["--checkpoint-dir", str(tmp / "run"), "--checkpoint-every", "2",
                "--async-checkpoint"]
        first = run(ckpt, 2)
        # two more saves of the same state: the second snapshot allocates the
        # other host buffer, the third reuses the first (the steady cost)
        ck = first.checkpointer
        ck.save(2, first.state)
        ck.save(2, first.state)
        ck.wait()
        path = latest_checkpoint(str(tmp / "run"))
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        saved = _state_tensors(first.state)
        restored = _state_tensors(restore_checkpoint(path, first.state))
        same = [k for k in saved if torch.equal(saved[k], restored[k])]
        t0 = time.perf_counter()
        save_checkpoint(str(tmp / "sync"), 2, first.state)
        sync_s = time.perf_counter() - t0
        shutil.rmtree(tmp / "sync")
        log(f"checkpoint: {len(saved)} leaves, {nbytes} bytes on disk "
            f"({nbytes / 1e9:.3f} GB; {free / 1e9:.1f} GB free before); sync save "
            f"{sync_s:.3f} s ({nbytes / sync_s / 1e9:.2f} GB/s)")
        for n, t in enumerate(ck.timings, 1):
            log(f"checkpoint: async save {n}: snapshot {t['snapshot_s']:.4f} s on the step "
                f"loop, blocked {t['blocked_s']:.4f} s on the previous write, device-to-host "
                f"copies {t['copy_s']:.4f} s on the stream ({nbytes / max(t['copy_s'], 1e-9) / 1e9:.1f} "
                f"GB/s), writer waited {t['copy_wait_s']:.4f} s for them, write "
                f"{t['write_s']:.3f} s in the background")
        log(f"checkpoint: restored leaves equal to the saved state bit for bit: "
            f"{len(same)} of {len(saved)}")
        if len(same) != len(saved) or nbytes < STATE_BYTES:
            raise AssertionError("the restored state differs from the saved one")
        del first, ck, saved, restored
        torch.cuda.empty_cache()
        resumed = run(ckpt + ["--resume"], 4)
        losses = [h["loss/total"] for h in resumed.history]
        diff = max(float((v.cpu() - ref_params[k]).abs().max())
                   for k, v in resumed.state.params.items())
        log(f"resume: steps {[h['step'] for h in resumed.history]}, losses {losses} against "
            f"uninterrupted {ref_losses[2:]}; largest |param difference| {diff}")
        if losses != ref_losses[2:] or diff != 0.0 or int(resumed.state.step) != 4:
            raise AssertionError("the resumed run is not bit-equal to the uninterrupted one")
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls after two warm-up calls.

    The device first sleeps (~20 ms at the H100's boost clock) while the host
    queues every call behind it, so the span between the events is device
    time even for a call whose host dispatch outlasts its kernels.
    """
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    taken = torch.tensor(1, dtype=torch.int32, device=device)   # the guard's flag

    def moments(plain, ok=None):
        for x, g, m, v, _, layers in leaves:
            lamb_moments(x, g, m, v, c, layers, ok=ok, plain=plain)

    def apply(plain, ok=None):
        for x, _, m, v, ratio, layers in leaves:
            lamb_apply(x, m, v, c, ratio, layers, ok=ok, plain=plain)

    # bytes each function must move: inputs read once, outputs written once
    fp32 = 4
    bytes_ = {"lamb_moments": n * fp32 * (4 + 2), "lamb_apply": n * fp32 * (3 + 1)}
    flops = {"lamb_moments": n * 16, "lamb_apply": n * 9}
    fns = {"lamb_moments": moments, "lamb_apply": apply}
    # plain, kernel, kernel with the guard's flag, the same twice more, plain:
    # the versions compared within one call
    times = {name: {"plain": [], "cuda": [], "ok": []} for name in fns}
    for name, fn in fns.items():
        for plain in (True, False, False, True):
            times[name]["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain)))
            if not plain:
                times[name]["ok"].append(cuda_ms(lambda: fn(False, taken)))
    out = {}
    for name in fns:
        t_k = min(times[name]["cuda"])
        t_p = min(times[name]["plain"])
        t_bytes, t_ops = bytes_[name] / rate, flops[name] / PEAK_OPS["float32"]
        bound = max(t_bytes, t_ops) * 1e3
        out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=None, ok_ms=min(times[name]["ok"]))
        log(f"time {name}: kernel {times[name]['cuda']} ms, with ok=1 {times[name]['ok']} ms, "
            f"plain {times[name]['plain']} ms "
            f"over {n} elements in 13 leaves; bound {bound:.3f} ms "
            f"({bytes_[name] / 1e9:.2f} GB at {rate / 1e12:.2f} TB/s); "
            f"{bytes_[name] / (t_k * 1e-3) / 1e12:.2f} TB/s achieved")
    log("time library: none; no single PyTorch call computes a LAMB update")
    log(f"time full update (K1 + K2): kernel {out['lamb_moments']['ms'] + out['lamb_apply']['ms']:.3f}"
        f" ms, plain {out['lamb_moments']['plain_ms'] + out['lamb_apply']['plain_ms']:.3f} ms")
    return out


def time_flash(device, rate: float) -> dict:
    """K3–K5 at each FLASH_TIMING shape (bf16, no mask), plain, kernel,
    kernel, plain, beside their bound and ``scaled_dot_product_attention``.
    Returns the seq-128 (main path) numbers by kernel name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import FlashSpec, flash_attention_fwd, \
        flash_dkv, flash_dq, row_dot

    gen = torch.Generator(device=device).manual_seed(3)
    result = {}
    for label, b, h, s, d in FLASH_TIMING:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=device)
                       .to(torch.bfloat16) for _ in range(4))
        valid = None   # the main path's batches carry no lengths
        spec = FlashSpec(d**-0.5, False, 0, False)
        o, lse = flash_attention_fwd(q, k, v, valid, spec, plain=True)
        di = row_dot(o, do)
        fns = {
            "flash_fwd": lambda plain: flash_attention_fwd(q, k, v, valid, spec, plain=plain),
            "flash_dq": lambda plain: flash_dq(q, k, v, valid, lse, di, do, spec, plain=plain),
            "flash_dkv": lambda plain: flash_dkv(q, k, v, valid, lse, di, do, spec,
                                                 plain=plain),
        }
        # bytes each must move (bf16 tensors of n elements, fp32 rows of lse
        # and di) and the operations of its (S x T x D) products
        n, rows, mm = b * h * s * d, b * h * s, 2 * b * h * s * s * d
        bytes_ = {"flash_fwd": 4 * n * 2 + rows * 4, "flash_dq": 5 * n * 2 + 2 * rows * 4,
                  "flash_dkv": 6 * n * 2 + 2 * rows * 4}
        flops = {"flash_fwd": 2 * mm, "flash_dq": 3 * mm, "flash_dkv": 4 * mm}
        times = {name: {"plain": [], "cuda": []} for name in fns}
        for name, fn in fns.items():
            for plain in (True, False, False, True):
                times[name]["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain)))
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do))
        out = {}
        for name in fns:
            t_k, t_p = min(times[name]["cuda"]), min(times[name]["plain"])
            t_bytes, t_ops = bytes_[name] / rate, flops[name] / PEAK_OPS["bfloat16"]
            out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=max(t_bytes, t_ops) * 1e3,
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             library_ms=sdpa_fwd if name == "flash_fwd" else None)
            log(f"time {name} {label} (b {b} h {h} s {s} d {d} bf16): kernel "
                f"{times[name]['cuda']} ms, plain {times[name]['plain']} ms; bound "
                f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
                f"({bytes_[name] / 1e6:.1f} MB, {flops[name] / 1e9:.2f} GFLOP); achieved "
                f"{flops[name] / (t_k * 1e-3) / 1e12:.2f} TFLOP/s, "
                f"{bytes_[name] / (t_k * 1e-3) / 1e12:.3f} TB/s")
        log(f"time library {label}: scaled_dot_product_attention forward {sdpa_fwd:.4f} ms, "
            f"forward + backward {sdpa_fb:.4f} ms (backward {sdpa_fb - sdpa_fwd:.4f} ms); "
            f"K3 {out['flash_fwd']['ms']:.4f} ms, K4 + K5 "
            f"{out['flash_dq']['ms'] + out['flash_dkv']['ms']:.4f} ms")
        result[label] = out
        del q, k, v, do, qg, kg, vg, o, lse, di
    torch.cuda.empty_cache()
    return result[FLASH_TIMING[0][0]]


def time_fused_ce(device, rate: float) -> dict:
    """K6–K8 at each CE_TIMING shape (bf16), plain, kernel, kernel, plain,
    beside their bound and the dense head's two calls (``matmul`` then
    ``cross_entropy``) forward and forward + backward.  K6–K8 run on the
    tensor cores; their FMA design (what bf16 rows off a 16-byte boundary
    take) is timed in the same turns, on h 2 bytes off.  Returns the seq-128
    (main path) numbers by kernel name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd

    gen = torch.Generator(device=device).manual_seed(5)
    d, v = CE_D, CE_V
    w = (0.05 * torch.randn((v, d), generator=gen, device=device)).to(torch.bfloat16)
    result = {}
    for label, n in CE_TIMING:
        h = torch.randn((n, d), generator=gen, device=device).to(torch.bfloat16)
        lbl = torch.randint(0, v, (n,), generator=gen, device=device, dtype=torch.int32)
        g = torch.full((n,), 1.0 / n, device=device)
        lse = fused_ce_fwd(h, w, lbl, plain=True)[2]
        fns = {
            "fused_ce_fwd": lambda plain: fused_ce_fwd(h, w, lbl, plain=plain),
            "fused_ce_dh": lambda plain: fused_ce_dh(h, w, lbl, lse, g, plain=plain),
            "fused_ce_dw": lambda plain: fused_ce_dw(h, w, lbl, lse, g, plain=plain),
        }
        # bytes each must move (bf16 h, w, dh, dw; int32 labels; fp32 per-row
        # values) and the operations of its (N x V x D) products
        hw, rows = (n * d + v * d) * 2, n * 4
        bytes_ = {"fused_ce_fwd": hw + 4 * rows, "fused_ce_dh": hw + 3 * rows + n * d * 2,
                  "fused_ce_dw": hw + 3 * rows + v * d * 2}
        mm = 2 * n * v * d
        flops = {"fused_ce_fwd": mm, "fused_ce_dh": 2 * mm, "fused_ce_dw": 2 * mm}
        h_off = torch.cat([h.new_zeros(1), h.reshape(-1)])[1:].view(n, d)   # FMA design
        fma = {"fused_ce_fwd": lambda: fused_ce_fwd(h_off, w, lbl),
               "fused_ce_dh": lambda: fused_ce_dh(h_off, w, lbl, lse, g),
               "fused_ce_dw": lambda: fused_ce_dw(h_off, w, lbl, lse, g)}
        times = {name: {"plain": [], "cuda": [], "fma": []} for name in fns}
        for name, fn in fns.items():
            for plain in (True, False, False, True):
                times[name]["plain" if plain else "cuda"].append(cuda_ms(lambda: fn(plain)))
                if name in fma and plain:
                    times[name]["fma"].append(cuda_ms(fma[name]))
        lbl64 = lbl.long()
        dense_fwd = cuda_ms(lambda: F.cross_entropy(torch.matmul(h, w.t()), lbl64,
                                                    reduction="none"))
        hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
        dense_fb = cuda_ms(lambda: torch.autograd.grad(
            F.cross_entropy(torch.matmul(hg, wg.t()), lbl64, reduction="none"), (hg, wg), g))
        out = {}
        for name in fns:
            t_k, t_p = min(times[name]["cuda"]), min(times[name]["plain"])
            t_bytes, t_ops = bytes_[name] / rate, flops[name] / PEAK_OPS["bfloat16"]
            out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=max(t_bytes, t_ops) * 1e3,
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             library_ms=dense_fwd if name == "fused_ce_fwd" else None)
            if times[name]["fma"]:
                out[name]["fma_ms"] = min(times[name]["fma"])
            log(f"time {name} {label} (n {n} d {d} v {v} bf16): kernel "
                f"{times[name]['cuda']} ms, plain {times[name]['plain']} ms, FMA design "
                f"{times[name]['fma'] or 'n/a'} ms; bound "
                f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
                f"({bytes_[name] / 1e6:.1f} MB, {flops[name] / 1e9:.2f} GFLOP); achieved "
                f"{flops[name] / (t_k * 1e-3) / 1e12:.2f} TFLOP/s")
        log(f"time library {label}: dense head matmul + cross_entropy (two calls, bf16 "
            f"logits) forward {dense_fwd:.4f} ms, forward + backward {dense_fb:.4f} ms "
            f"(backward {dense_fb - dense_fwd:.4f} ms); K6 {out['fused_ce_fwd']['ms']:.4f} ms, "
            f"K7 + K8 {out['fused_ce_dh']['ms'] + out['fused_ce_dw']['ms']:.4f} ms")
        result[label] = out
        del h, h_off, hg, lse, g
    del w, wg
    torch.cuda.empty_cache()
    return result[CE_TIMING[0][0]]


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
        for line in ptxas_lines((build.BUILD_DIR / f"{src}.log").read_text()):
            log(f"ptxas {src}: {line}")

    errs = {**check_kernels(device), **check_flash(device), **check_fused_ce(device)}
    check_against_cpu(device)
    launches = run_main_path(device)
    trainer = run_two_stages(device)
    check_guard(trainer, device)
    del trainer
    torch.cuda.empty_cache()
    check_checkpoint_resume(device)
    timing = {**time_kernels(device, rate), **time_flash(device, rate),
              **time_fused_ce(device, rate)}

    kernels = [dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errs[k],
                    **timing[k]) for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
