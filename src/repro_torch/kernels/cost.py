"""One count of each kernel's work, K1–K8: what it must move and compute.

Each function gives a :class:`Work` from a kernel call's shapes and dtypes:
the bytes the function must move, each input read once and each output
written once (what the kernel reads again or keeps in scratch does not
count), and the operations it does, each multiply and add one.  Causal and
windowed attention (K3–K5) count only the (row, key) pairs the mask keeps.
``Work.rate`` names the peak the operations run at: the tensor cores' for
bf16 attention and CE, fp32's for fp32 inputs and for LAMB's arithmetic.

The same count serves every reader: ``chip_smoke.py``'s and ``PERF.md``'s
bound column (``launch/roofline.bound``), and the dry-run, where a kernel
called on meta tensors launches nothing and adds its count here instead
(:func:`record` into the :func:`counting` tally).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import torch

Dtype = Union[torch.dtype, str]


class Work(NamedTuple):
    bytes: int
    operations: int
    rate: str   # "bfloat16" (the tensor cores) or "float32"


def _size(dtype: Dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def rate_of(dtype: Dtype) -> str:
    """The peak ``dtype``'s operations run at: 16-bit types on the tensor
    cores (``"bfloat16"``), the rest fp32's."""
    return "bfloat16" if _size(dtype) == 2 else "float32"


def total(works: Iterable[Work]) -> Work:
    """The sum of several calls' work (one rate: the first's)."""
    works = list(works)
    return Work(sum(w.bytes for w in works), sum(w.operations for w in works),
                works[0].rate if works else "float32")


# ---------------------------------------------------------------------------
# K1, K2: the fused LAMB update of one leaf viewed as (layers, P)
# ---------------------------------------------------------------------------

def lamb_moments(numel: int, layers: int = 1, x_dtype: Dtype = torch.float32,
                 g_dtype: Dtype = torch.float32, ok: bool = False) -> Work:
    """K1: reads x, g, m, v (fp32), the [c1, c2] pair and the guard's flag;
    writes m, v and each layer's Σx², Σu².  16 fp32 operations an element."""
    nbytes = (numel * (_size(x_dtype) + _size(g_dtype) + 4 * 4) + 2 * 4 + 2 * layers * 4
              + 4 * ok)
    return Work(nbytes, 16 * numel, "float32")


def lamb_apply(numel: int, layers: int = 1, x_dtype: Dtype = torch.float32,
               ok: bool = False) -> Work:
    """K2: reads x, m, v, the [c1, c2] pair, each layer's ratio and the
    flag; writes x and each layer's Σ(x'−x)².  9 fp32 operations an
    element."""
    nbytes = numel * (2 * _size(x_dtype) + 2 * 4) + 2 * 4 + 2 * layers * 4 + 4 * ok
    return Work(nbytes, 9 * numel, "float32")


# ---------------------------------------------------------------------------
# K3–K5: flash attention, q (B, H, S, D) against k/v (B, Hkv, T, D)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def attention_pairs(s: int, t: int, causal: bool = False, window: int = 0) -> int:
    """The (row, key) pairs one head of one example keeps: with ``causal``
    each row's keys up to its row + (T − S), with ``window`` only those
    within the window before it (``csrc/flash_attention.cu``'s masks).  A
    per-example length mask is not counted: its lengths are data."""
    rows = torch.arange(s, dtype=torch.int64) + (t - s)
    hi = torch.clamp(rows + 1, max=t) if causal else torch.full_like(rows, t)
    lo = torch.clamp(rows - window + 1, min=0) if window else torch.zeros_like(rows)
    return int(torch.clamp(hi - lo, min=0).sum())


def _flash(b, h, hkv, s, t, d, dtype, causal, window, lengths):
    e = _size(dtype)
    nq, nk, rows = b * h * s * d, b * hkv * t * d, b * h * s
    mm = 2 * b * h * attention_pairs(s, t, bool(causal), int(window)) * d   # one S×T×D product
    return e, nq, nk, rows, mm, 4 * b if lengths else 0


def flash_fwd(b: int, h: int, hkv: int, s: int, t: int, d: int, dtype: Dtype,
              causal: bool = False, window: int = 0, lengths: bool = False) -> Work:
    """K3: reads q, k, v (and with ``lengths`` the (B,) int32 key lengths);
    writes o and the fp32 lse.  Two products, q·kᵀ and p·v."""
    e, nq, nk, rows, mm, nl = _flash(b, h, hkv, s, t, d, dtype, causal, window, lengths)
    return Work((2 * nq + 2 * nk) * e + rows * 4 + nl, 2 * mm, rate_of(dtype))


def flash_dq(b: int, h: int, hkv: int, s: int, t: int, d: int, dtype: Dtype,
             causal: bool = False, window: int = 0, lengths: bool = False) -> Work:
    """K4: reads q, k, v, do, the fp32 lse and di; writes dq.  Three
    products: q·kᵀ, do·vᵀ and ds·k."""
    e, nq, nk, rows, mm, nl = _flash(b, h, hkv, s, t, d, dtype, causal, window, lengths)
    return Work((3 * nq + 2 * nk) * e + 2 * rows * 4 + nl, 3 * mm, rate_of(dtype))


def flash_dkv(b: int, h: int, hkv: int, s: int, t: int, d: int, dtype: Dtype,
              causal: bool = False, window: int = 0, lengths: bool = False) -> Work:
    """K5: reads q, k, v, do, lse and di; writes dk, dv.  Four products:
    q·kᵀ, do·vᵀ, dsᵀ·q and pᵀ·do."""
    e, nq, nk, rows, mm, nl = _flash(b, h, hkv, s, t, d, dtype, causal, window, lengths)
    return Work((2 * nq + 4 * nk) * e + 2 * rows * 4 + nl, 4 * mm, rate_of(dtype))


# ---------------------------------------------------------------------------
# K6–K8: the fused CE head, h (N, D) against w (V, D)
# ---------------------------------------------------------------------------

def fused_ce_fwd(n: int, d: int, v: int, dtype: Dtype, stats: bool = False) -> Work:
    """K6: reads h, w and the int32 labels; writes nll, correct and lse
    (fp32 rows), with ``stats`` also the label logit, row max and argmax.
    One (N×V×D) product."""
    rows = n * 4 * (1 + 3 + (3 if stats else 0))
    return Work((n * d + v * d) * _size(dtype) + rows, 2 * n * v * d, rate_of(dtype))


def fused_ce_dh(n: int, d: int, v: int, dtype: Dtype) -> Work:
    """K7: reads h, w, labels, lse and g; writes dh.  Two products (the
    scores again, then dlogits·w)."""
    e = _size(dtype)
    return Work((n * d + v * d) * e + 3 * n * 4 + n * d * e, 4 * n * v * d, rate_of(dtype))


def fused_ce_dw(n: int, d: int, v: int, dtype: Dtype) -> Work:
    """K8: reads h, w, labels, lse and g; writes dw.  Two products."""
    e = _size(dtype)
    return Work((n * d + v * d) * e + 3 * n * 4 + v * d * e, 4 * n * v * d, rate_of(dtype))


# ---------------------------------------------------------------------------
# the dry-run's count
# ---------------------------------------------------------------------------

_ACTIVE: List[Tuple[Dict[str, Dict[str, int]], Dict[str, int]]] = []


@contextlib.contextmanager
def counting(tally: Dict[str, Dict[str, int]], by_rate: Optional[Dict[str, int]] = None):
    """Within the block, each kernel a meta route stands for adds one
    launch and its :class:`Work` to ``tally`` (``{name: {"launches",
    "bytes", "operations"}}``), and its operations to ``by_rate`` under
    its ``Work.rate``."""
    _ACTIVE.append((tally, {} if by_rate is None else by_rate))
    try:
        yield tally
    finally:
        _ACTIVE.pop()


def record(name: str, work: Work) -> None:
    """One launch of kernel ``name`` doing ``work``, added to the innermost
    active :func:`counting` tally (none: nothing is counted)."""
    if not _ACTIVE:
        return
    tally, by_rate = _ACTIVE[-1]
    entry = tally.setdefault(name, {"launches": 0, "bytes": 0, "operations": 0})
    entry["launches"] += 1
    entry["bytes"] += int(work.bytes)
    entry["operations"] += int(work.operations)
    by_rate[work.rate] = by_rate.get(work.rate, 0) + int(work.operations)
