"""Fused chunked-vocab cross-entropy: CUDA kernels K6–K8 and their plain version.

Port of ``repro.kernels.fused_ce``, the MLM head without the logits: given
gathered rows ``h`` (N, D) and the vocab projection ``w`` (V, D) in the
embedding layout, it streams vocab chunks through projection + online
log-sum-exp, so the (N, V) logits never exist, forward or backward.  Three
kernels share one ``torch.autograd.Function``, as the three Pallas kernels
share one ``jax.custom_vjp`` (see ``csrc/fused_ce.cu`` for the kernels, their
bound and design):

  forward (K6, ``fused_ce_fwd``): per-row nll, correct and lse;
  backward dh (K7, ``fused_ce_dh``): dh = Σ_chunks ((p − onehot)·g)·w_c,
      p rebuilt from lse;
  backward dw (K8, ``fused_ce_dw``): one CUDA block owns a tile of dw rows and
      sums every row of h into it.

All statistics are fp32 whatever the inputs' type; dh comes back in h's type
and dw in w's.  Each pass dispatches on where its tensors lie: on the CPU it
runs the plain PyTorch version below (the chunked math of the JAX package's
XLA backend, vocab chunks of ``block_v``); on a CUDA tensor it launches the
kernel or raises; on a meta tensor (the dry-run) it allocates what the
kernel's call allocates, its scratch planned for an H100 SXM
(:func:`plan_splits`, from constants that mirror ``csrc/fused_ce.cu``: any
change to the kernels' registers, tiles or launch bounds must update them,
or ``chip_smoke.py``'s plan check fails), launches nothing and adds the kernel's
``kernels/cost.py`` count to the dry-run's.  There is no fallback from the
kernel to the plain version or the meta route.  On the card each kernel has
two designs, chosen by ``_check``'s rule before the launch: bf16 whose rows
can be copied in 16-byte pieces runs on the tensor cores (``mma.sync``; in
K7 and K8 the fp32 dlogits as two bf16 terms); fp32, and bf16 that cannot be
copied so, on fp32 FMA kernels.
``VARIANT_LAUNCHES`` counts which design ran.

Over a ``model`` axis that splits the vocab (``fused_ce(..., model=)``),
each rank holds V/M rows of ``w`` from row ``v0``: K6 runs on the slice with
its labels compared against ``v0 +`` the local column and also returns each
row's label logit, max and first global argmax, which
:func:`combine_vocab_slices` merges over the ranks (a log-sum-exp of the
slices' lse, the owner's label logit, the lowest index reaching the global
max); K7's dh on the slice is a partial summed over ``model``, and K8's dw
is the slice's own rows.  K7 and K8 take the labels shifted by ``v0``: a
label outside ``[0, V/M)`` is no hit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import aligned16
from repro_torch.kernels.launches import count_launch, register
from repro_torch.sharding.collectives import all_reduce, copy_to_model, replicated

DESIGNS = ("mma", "fma")   # bf16 on the tensor cores (mma.sync); fp32 FMA
register("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw", variants=DESIGNS)

NEG_INF = -1e30
# csrc/fused_ce.cu's plan (its `plan`) redone for the meta route on an H100
# SXM.  Each constant mirrors a symbol of csrc/fused_ce.cu; a change there to
# a kernel's registers, tiles, shared memory or launch bounds must be made
# here too, or chip_smoke.py's check of this plan against the library's
# (phase 18, `check_split_plans`) fails on the card.  No CPU test sees it.
D_WINDOW = 1024          # kDW: the D columns one block holds at once
H100_SMS = 132           # cudaDevAttrMultiProcessorCount of an H100 SXM
_TILE = 128              # kBT: vocab columns of a tile
_MMA_BLOCK_TILES = 2     # kMmaBlockTiles: a tensor-core block's fixed cost
# owner rows of a block: kBO6 for fused_ce_fwd_mma_kernel, else kBO
_OWNER_ROWS = {(0, "mma"): 64, (0, "fma"): 32, (1, "mma"): 32, (1, "fma"): 32}
# what cudaOccupancyMaxActiveBlocksPerMultiprocessor gives in `plan` for
# (pass, design): fused_ce_fwd_mma_kernel (__launch_bounds__(kThreads, 1),
# fwd_mma_smem), fused_ce_fwd_kernel (kThreads, static shared memory), and
# grad_kernel's dh kernels (mma_smem / the FMA kernel's smem), by ptxas's
# registers and shared memory
BLOCKS_PER_SM = {(0, "mma"): 1, (0, "fma"): 4, (1, "mma"): 1, (1, "fma"): 1}
_IDX_INF = torch.iinfo(torch.int32).max

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGN_CODES = {"fma": 0, "mma": 1}
_LIB: Optional[ctypes.CDLL] = None


def _backend(device: torch.device, plain: bool) -> str:
    if plain or device.type == "cpu":
        return "plain"
    if device.type in ("cuda", "meta"):
        return device.type
    raise ValueError(f"fused CE has no backend for device {device}")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load

        lib = load("fused_ce")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.fused_ce_fwd.argtypes = [p] * 11 + [i64, i64, i, i, i, i, i, i, i, p]
        lib.fused_ce_dh.argtypes = [p] * 7 + [i64, i64, i, i, i, i, i, i, p]
        lib.fused_ce_dw.argtypes = [p] * 6 + [i64, i64, i, i, i, i, i, p]
        lib.fused_ce_plan.argtypes = [i] * 6
        for fn in (lib.fused_ce_fwd, lib.fused_ce_dh, lib.fused_ce_dw, lib.fused_ce_plan):
            fn.restype = i
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def fused_ce_fwd_plain(h, w, lbl, block_v: int = 512, *, v0: int = 0, stats: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """(nll, correct, lse) in fp32 by the online log-sum-exp over vocab
    chunks of ``block_v`` (port of ``_xla_fwd``).  ``lbl`` is int32 in
    [v0, v0 + V) (outside it: no hit, and the label logit stays -1e30);
    ``correct`` takes the first maximum, as ``jnp.argmax`` does.  With
    ``stats``, also each row's label logit, max logit and its first column
    plus ``v0`` (what :func:`combine_vocab_slices` merges)."""
    n, v = h.shape[0], w.shape[0]
    f32, dev = torch.float32, h.device
    hf = h.to(f32)
    m = torch.full((n,), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((n,), dtype=f32, device=dev)
    ll = torch.full((n,), NEG_INF, dtype=f32, device=dev)
    bmax = torch.full((n,), NEG_INF, dtype=f32, device=dev)
    bidx = torch.zeros((n,), dtype=torch.int32, device=dev)
    for c0 in range(0, v, block_v):
        s = hf @ w[c0:c0 + block_v].to(f32).t()               # (n, chunk)
        cols = c0 + torch.arange(s.shape[1], dtype=torch.int32, device=dev)
        m_cur = s.amax(1)
        m_new = torch.maximum(m, m_cur)
        l = torch.exp(m - m_new) * l + torch.exp(s - m_new[:, None]).sum(1)
        m = m_new
        hit = cols[None, :] + v0 == lbl[:, None]
        ll = torch.where(hit.any(1), torch.where(hit, s, 0.0).sum(1), ll)
        # lowest column reaching the chunk's max; a strict > across chunks
        # keeps the earlier chunk's winner
        cand = torch.where(s == m_cur[:, None], cols[None, :], _IDX_INF).amin(1)
        bidx = torch.where(m_cur > bmax, cand, bidx)
        bmax = torch.maximum(bmax, m_cur)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = (lse - ll, (bidx + v0 == lbl).to(f32), lse)
    return out + (ll, m, bidx + v0) if stats else out


def _grads_plain(h, w, lbl, lse, g, block_v: int, *, want_dh: bool, want_dw: bool):
    """(dh, dw) from the residuals, p rebuilt per vocab chunk from lse (port
    of ``_xla_bwd``); dh in h's dtype, dw in w's, None where not wanted."""
    f32, dev = torch.float32, h.device
    hf = h.to(f32)
    dh = torch.zeros(hf.shape, dtype=f32, device=dev)
    dws = []
    for c0 in range(0, w.shape[0], block_v):
        wf = w[c0:c0 + block_v].to(f32)
        s = hf @ wf.t()
        cols = c0 + torch.arange(s.shape[1], dtype=torch.int32, device=dev)
        onehot = (cols[None, :] == lbl[:, None]).to(f32)
        dlog = (torch.exp(s - lse[:, None]) - onehot) * g[:, None]
        if want_dw:
            dws.append(dlog.t() @ hf)
        if want_dh:
            dh = dh + dlog @ wf
    return (dh.to(h.dtype) if want_dh else None,
            torch.cat(dws).to(w.dtype) if want_dw else None)


def fused_ce_dh_plain(h, w, lbl, lse, g, block_v: int = 512) -> torch.Tensor:
    """dh alone (what K7 computes)."""
    return _grads_plain(h, w, lbl, lse, g, block_v, want_dh=True, want_dw=False)[0]


def fused_ce_dw_plain(h, w, lbl, lse, g, block_v: int = 512) -> torch.Tensor:
    """dw alone (what K8 computes)."""
    return _grads_plain(h, w, lbl, lse, g, block_v, want_dh=False, want_dw=True)[1]


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(h, w, lbl, **rows) -> str:
    """Raise on what the kernels cannot take; else the design K6–K8 run.

    The rule: "mma" (the tensor cores) for bf16 h and w whose rows the
    kernels can copy in 16-byte pieces: 16-byte aligned base pointers, and
    row strides and D that are multiples of 8 elements; "fma" (the fp32 FMA
    kernels) for fp32, and for bf16 that breaks any of those."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError("h and w must be 2-D: (N, D) and (V, D)")
    n, d = h.shape
    v = w.shape[0]
    if w.shape[1] != d:
        raise ValueError(f"h feature dim {d} != w feature dim {w.shape[1]}")
    if min(n, v, d) < 1 or max(n, v, d) >= 2**31 // 128:
        raise ValueError(f"sizes out of range: h {tuple(h.shape)}, w {tuple(w.shape)}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {h.dtype} is not float32 or bfloat16")
    if w.dtype != h.dtype:
        raise TypeError(f"w dtype {w.dtype} differs from h's {h.dtype}")
    for name, x in (("h", h), ("w", w)):
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
        if x.stride(1) != 1 or (x.shape[0] > 1 and x.stride(0) < d):
            raise ValueError(f"{name} must have contiguous rows (stride {x.stride()})")
    for name, x in (("labels", lbl), *rows.items()):
        want = torch.int32 if name == "labels" else torch.float32
        if x.device != h.device or x.dtype != want or x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} ({n},) tensor on h's device")
    stageable = d % 8 == 0 and all(aligned16(x) and _row_stride(x) % 8 == 0 for x in (h, w))
    return DESIGNS[0] if h.dtype == torch.bfloat16 and stageable else DESIGNS[1]


def d_windows(d: int) -> int:
    """The D windows K7 and K8 run at width ``d`` (their grids' z extent:
    each window's block forms the scores over all of D; K6's tensor-core
    kernel loads its h rows once per window): 7 at deepseek-v3's 7168."""
    return -(-d // D_WINDOW)


def _row_stride(x: torch.Tensor) -> int:
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


@functools.lru_cache(maxsize=None)
def _splits(index: int, pass_: int, design: int, dtype: int, n: int, v: int, d: int) -> int:
    """Vocab splits of K6 (``pass_`` 0) or K7 (1) in a design on card
    ``index``, planned by the library from the blocks per SM of the kernel
    that will launch (once per shape)."""
    with torch.cuda.device(index):
        splits = _lib().fused_ce_plan(pass_, design, dtype, n, v, d)
    if splits < 1:
        raise RuntimeError(f"fused_ce_plan failed with CUDA error {-splits}")
    return splits


def plan_splits(pass_: int, design: str, n: int, v: int, d: int,
                sms: int = H100_SMS) -> int:
    """The vocab splits the library plans for K6 (``pass_`` 0) or K7 (1)
    in ``design`` at these sizes (``csrc/fused_ce.cu``'s ``plan``), on a
    card of ``sms`` SMs holding :data:`BLOCKS_PER_SM` of the kernel: the
    count that minimises waves × the longest block's tiles, each split
    non-empty, a tie keeping fewer."""
    slots = sms * BLOCKS_PER_SM[(pass_, design)]
    rows = _OWNER_ROWS[(pass_, design)]
    row_tiles = -(-n // rows) * (d_windows(d) if pass_ == 1 else 1)
    n_tiles = -(-v // _TILE)
    best, best_cost = 1, None
    for want in range(1, min(n_tiles, 65535) + 1):
        per = -(-n_tiles // want)
        if -(-n_tiles // per) != want:
            continue
        c = -(-(row_tiles * want) // slots) * (per + (_MMA_BLOCK_TILES if design == "mma"
                                                      else 0))
        if best_cost is None or c < best_cost:
            best, best_cost = want, c
    return best


def _plan(h, w, pass_: int, design: str) -> int:
    return _splits(h.device.index, pass_, _DESIGN_CODES[design], _DTYPE_CODES[h.dtype],
                   h.shape[0], w.shape[0], h.shape[1])


def _shape_args(h, w, design: str) -> list:
    return [_row_stride(h), _row_stride(w), _DTYPE_CODES[h.dtype], _DESIGN_CODES[design],
            h.shape[0], w.shape[0], h.shape[1]]


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _count(name: str, design: str) -> None:
    """One launch of ``name``, under the design it ran."""
    count_launch(name, design)


def _fwd_cuda(h, w, lbl, v0: int = 0, stats: bool = False):
    design = _check(h, w, lbl)
    n, dev = h.shape[0], h.device
    splits = _plan(h, w, 0, design)
    rows = torch.empty((5 if stats else 3, n), dtype=torch.float32, device=dev)
    nll, correct, lse = rows[0], rows[1], rows[2]
    ll, row_max = (rows[3], rows[4]) if stats else (None, None)
    row_idx = torch.empty((n,), dtype=torch.int32, device=dev) if stats else None
    part = torch.empty((3, splits, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    extra = [0 if x is None else x.data_ptr() for x in (ll, row_max, row_idx)]
    err = _lib().fused_ce_fwd(h.data_ptr(), w.data_ptr(), lbl.data_ptr(), nll.data_ptr(),
                              correct.data_ptr(), lse.data_ptr(), part.data_ptr(),
                              part_idx.data_ptr(), *extra, *_shape_args(h, w, design),
                              splits, v0, _stream(h))
    _raise_on(err, "fused_ce_fwd")
    _count("fused_ce_fwd", design)
    return (nll, correct, lse, ll, row_max, row_idx) if stats else (nll, correct, lse)


def _dh_cuda(h, w, lbl, lse, g):
    design = _check(h, w, lbl, lse=lse, g=g)
    n, d, dev = h.shape[0], h.shape[1], h.device
    splits = _plan(h, w, 1, design)
    dh = torch.empty((n, d), dtype=h.dtype, device=dev)
    part = torch.empty((splits, n, d), dtype=torch.float32, device=dev)
    err = _lib().fused_ce_dh(h.data_ptr(), w.data_ptr(), lbl.data_ptr(), lse.data_ptr(),
                             g.data_ptr(), dh.data_ptr(), part.data_ptr(),
                             *_shape_args(h, w, design), splits, _stream(h))
    _raise_on(err, "fused_ce_dh")
    _count("fused_ce_dh", design)
    return dh


def _dw_cuda(h, w, lbl, lse, g):
    design = _check(h, w, lbl, lse=lse, g=g)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    err = _lib().fused_ce_dw(h.data_ptr(), w.data_ptr(), lbl.data_ptr(), lse.data_ptr(),
                             g.data_ptr(), dw.data_ptr(), *_shape_args(h, w, design),
                             _stream(h))
    _raise_on(err, "fused_ce_dw")
    _count("fused_ce_dw", design)
    return dw


# ---------------------------------------------------------------------------
# meta routes: what each launch allocates, and its count (the dry-run)
# ---------------------------------------------------------------------------

def _fwd_meta(h, w, lbl, v0: int = 0, stats: bool = False):
    design = _check(h, w, lbl)
    (n, d), v, dev = h.shape, w.shape[0], h.device
    splits = plan_splits(0, design, n, v, d)
    rows = torch.empty((5 if stats else 3, n), dtype=torch.float32, device=dev)
    row_idx = torch.empty((n,), dtype=torch.int32, device=dev) if stats else None
    torch.empty((3, splits, n), dtype=torch.float32, device=dev)   # the scratch
    torch.empty((splits, n), dtype=torch.int32, device=dev)
    cost.record("fused_ce_fwd", cost.fused_ce_fwd(n, d, v, h.dtype, stats))
    if stats:
        return rows[0], rows[1], rows[2], rows[3], rows[4], row_idx
    return rows[0], rows[1], rows[2]


def _dh_meta(h, w, lbl, lse, g):
    design = _check(h, w, lbl, lse=lse, g=g)
    (n, d), v = h.shape, w.shape[0]
    dh = torch.empty((n, d), dtype=h.dtype, device=h.device)
    torch.empty((plan_splits(1, design, n, v, d), n, d), dtype=torch.float32,
                device=h.device)   # the scratch
    cost.record("fused_ce_dh", cost.fused_ce_dh(n, d, v, h.dtype))
    return dh


def _dw_meta(h, w, lbl, lse, g):
    _check(h, w, lbl, lse=lse, g=g)
    cost.record("fused_ce_dw", cost.fused_ce_dw(h.shape[0], h.shape[1], w.shape[0], h.dtype))
    return torch.empty(w.shape, dtype=w.dtype, device=w.device)


_ROUTES = {"cuda": (_fwd_cuda, _dh_cuda, _dw_cuda), "meta": (_fwd_meta, _dh_meta, _dw_meta)}


def fused_ce_fwd(h, w, lbl, *, block_v: int = 512, plain: bool = False, v0: int = 0,
                 stats: bool = False):
    """(nll, correct, lse): kernel K6 on a CUDA tensor, the plain version on
    a CPU one (or anywhere with ``plain=True``).  ``w`` holds the vocab
    rows from ``v0`` on (labels are compared against ``v0 +`` the column);
    ``stats`` adds each row's label logit, max and first global argmax."""
    backend = _backend(h.device, plain)
    if backend == "plain":
        return fused_ce_fwd_plain(h, w, lbl, block_v, v0=v0, stats=stats)
    return _ROUTES[backend][0](h, w, lbl, v0, stats)


def fused_ce_dh(h, w, lbl, lse, g, *, block_v: int = 512, plain: bool = False):
    """dh: kernel K7 on a CUDA tensor, else the plain version (or the meta
    route)."""
    backend = _backend(h.device, plain)
    if backend == "plain":
        return fused_ce_dh_plain(h, w, lbl, lse, g, block_v)
    return _ROUTES[backend][1](h, w, lbl, lse, g)


def fused_ce_dw(h, w, lbl, lse, g, *, block_v: int = 512, plain: bool = False):
    """dw: kernel K8 on a CUDA tensor, else the plain version (or the meta
    route)."""
    backend = _backend(h.device, plain)
    if backend == "plain":
        return fused_ce_dw_plain(h, w, lbl, lse, g, block_v)
    return _ROUTES[backend][2](h, w, lbl, lse, g)


def fused_ce_bwd(h, w, lbl, lse, g, *, want_dh: bool = True, want_dw: bool = True,
                 block_v: int = 512, plain: bool = False):
    """(dh, dw), None where not wanted: K7 and K8 on CUDA tensors (or their
    meta routes), else the plain version in one pass over the vocab
    chunks."""
    backend = _backend(h.device, plain)
    if backend == "plain":
        return _grads_plain(h, w, lbl, lse, g, block_v, want_dh=want_dh, want_dw=want_dw)
    _, dh_fn, dw_fn = _ROUTES[backend]
    return (dh_fn(h, w, lbl, lse, g) if want_dh else None,
            dw_fn(h, w, lbl, lse, g) if want_dw else None)


# ---------------------------------------------------------------------------
# autograd boundary and public entry
# ---------------------------------------------------------------------------

def combine_vocab_slices(lse, ll, row_max, row_idx, reduce):
    """The whole vocabulary's ``(lse, label logit, argmax)`` of each row
    from its slices' K6 statistics (``fused_ce_fwd(..., stats=True)``).

    ``reduce(op, x)`` reduces ``x`` over the slices by ``op`` (sum, max or
    min): an all-reduce over ``model`` on one rank's (k, N) operand, or
    :func:`~repro_torch.sharding.collectives.all_reduce_plain` over a
    leading slice axis.  ``lse = M + log Σ_r exp(lse_r − M)`` with ``M`` the
    largest ``lse_r``; the label logit is the owning slice's (the others
    hold -1e30); the argmax is the lowest global index among the slices
    whose max is the global max, as ``jnp.argmax`` keeps the first.  Three
    reductions: max, sum, min."""
    top, ll_all, best = reduce("max", torch.stack([lse, ll, row_max], -2)).unbind(-2)
    lse_all = top + torch.log(reduce("sum", torch.exp(lse - top)))
    idx = reduce("min", torch.where(row_max == best, row_idx, _IDX_INF))
    return lse_all, ll_all, idx


class FusedCE(torch.autograd.Function):
    """``(nll, correct) = apply(h, w, lbl, model, block_v, plain)``; saves
    the residuals of the JAX package's ``_fused_ce_fwd``: h, w, lbl, lse.
    ``correct`` is piecewise constant and ``lbl`` integral: neither gets a
    gradient.

    ``model`` (a :class:`~repro_torch.sharding.context.ModelAxis`, or
    None) splits the vocab: ``w`` is this rank's rows from ``v0 = index ·
    V/M`` and ``lbl`` global.  K6 then runs on the slice and
    :func:`combine_vocab_slices` merges the slices over ``model``; the
    labels are saved shifted by ``v0`` with the global lse, so K7 gives this
    rank's dh partial (the caller sums it over ``model``: ``h`` comes
    through ``copy_to_model``) and K8 the dw of its rows."""

    @staticmethod
    def forward(ctx, h, w, lbl, model, block_v: int, plain: bool):
        if model is None:
            nll, correct, lse = fused_ce_fwd(h, w, lbl, block_v=block_v, plain=plain)
        else:
            v0 = model.index * w.shape[0]
            _, _, lse, ll, row_max, row_idx = fused_ce_fwd(h, w, lbl, block_v=block_v,
                                                           plain=plain, v0=v0, stats=True)
            lse, ll, idx = combine_vocab_slices(
                lse, ll, row_max, row_idx, lambda op, x: all_reduce(x, op, model.group))
            nll, correct = lse - ll, (idx == lbl).to(torch.float32)
            lbl = (lbl - v0).contiguous()
        ctx.save_for_backward(h, w, lbl, lse)
        ctx.block_v, ctx.plain = block_v, plain
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, d_nll, _d_correct):
        h, w, lbl, lse = ctx.saved_tensors
        g = d_nll.to(torch.float32).contiguous()
        dh, dw = fused_ce_bwd(h, w, lbl, lse, g, want_dh=ctx.needs_input_grad[0],
                              want_dw=ctx.needs_input_grad[1], block_v=ctx.block_v,
                              plain=ctx.plain)
        return dh, dw, None, None, None, None


def fused_ce(
    h: torch.Tensor,       # (N, D) gathered rows
    w: torch.Tensor,       # (V, D) vocab projection, embedding layout
    labels: torch.Tensor,  # (N,) int targets; clipped into [0, V)
    *,
    block_v: int = 512,
    plain: bool = False,
    model=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(nll, correct)`` without materialising the (N, V) logits
    (port of ``repro.kernels.fused_ce.fused_ce``).

    ``nll[i] = logsumexp_v(h[i]·w[v]) − h[i]·w[labels[i]]`` in fp32;
    ``correct[i] = argmax_v(h[i]·w[v]) == labels[i]`` with the first maximum
    winning a tie.  Differentiable w.r.t. ``h`` and ``w``; a row whose ``nll``
    gets a zero cotangent contributes exactly zero to both gradients.
    ``block_v`` is the plain version's vocab chunk (the CUDA kernels use
    tiles of their own).  ``h`` and ``w`` of different float types are both
    taken in the wider one (exact: the products are fp32 either way).
    ``plain=True`` runs the plain version on any device, the reference a
    kernel run is held to on the card.  ``model`` (a
    :class:`~repro_torch.sharding.context.ModelAxis`) makes ``w`` this
    rank's slice of a vocab of ``V · model.size`` rows (:class:`FusedCE`);
    the labels are clipped into that.
    """
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError("h and w must be 2-D: (N, D) and (V, D)")
    n, d = h.shape
    v = w.shape[0]
    if w.shape[1] != d:
        raise ValueError(f"h feature dim {d} != w feature dim {w.shape[1]}")
    if tuple(labels.shape) != (n,):
        raise ValueError(f"labels shape {tuple(labels.shape)} != ({n},)")
    if h.dtype != w.dtype:
        wide = torch.promote_types(h.dtype, w.dtype)
        h, w = h.to(wide), w.to(wide)
    whole = v if model is None else v * model.size
    lbl = torch.clamp(labels.to(device=h.device, dtype=torch.int32), 0, whole - 1).contiguous()
    if model is None:
        return FusedCE.apply(h, w, lbl, model, min(block_v, v), plain)
    nll, correct = FusedCE.apply(copy_to_model(h, model.group), w, lbl, model,
                                 min(block_v, v), plain)
    return replicated(nll, model.group), correct
