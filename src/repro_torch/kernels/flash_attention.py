"""Differentiable flash attention: CUDA kernels K3–K5 and their plain version.

Port of ``repro.kernels.flash_attention``: block-wise online-softmax
attention that never materialises the (S, T) score matrix, forward or
backward.  Three kernels share one ``torch.autograd.Function``, as the three
Pallas kernels share one ``jax.custom_vjp`` (see ``csrc/flash_attention.cu``
for the kernels, their bound and design):

  forward (K3, ``flash_fwd``): o and the per-row logsumexp ``lse``;
  backward dq (K4, ``flash_dq``): dq = scale·Σ_k ds·k, ds = p∘(do·vᵀ − di);
  backward dk/dv (K5, ``flash_dkv``): one CUDA block owns a (kv tile) of
      dk/dv and sums every q head of its GQA group and every q tile into it.

di = rowsum(o∘do) is taken between them with torch ops, as the JAX package
does.  q is (B, H, S, D), k/v are (B, Hkv, T, D) with Hkv dividing H (GQA:
q head h reads kv head h // (H/Hkv); k/v are never repeated).  Masks:
``causal`` with the T − S row offset, a sliding ``window``, and a per-example
``kv_valid`` length; rows they mask entirely give o = 0 and zero gradients.

Each pass dispatches on where its tensors lie: on the CPU it runs the plain
PyTorch version below (the chunked online softmax of the JAX package's XLA
backend); on a CUDA tensor it launches the kernel or raises; on a meta
tensor (the dry-run) it allocates what the kernel's call allocates, launches
nothing and adds the kernel's ``kernels/cost.py`` count to the dry-run's.
There is no fallback from the kernel to the plain version or the meta
route.  On the card, bf16 K3–K5 run on the tensor cores and fp32 on fp32
FMA kernels, by dtype (``VARIANT_LAUNCHES`` counts which design ran).  The tensor-core kernels
move bf16 rows in 16-byte pieces, so they need 16-byte aligned base pointers
and (b, h, s) strides that are multiples of 8 elements; the wrappers raise
on anything else.  The kernels are built for the head dims of
``HEAD_DIMS``, and past 256 the wide kernels take any multiple of ``WIDE``
(the scores formed over D in ``WIDE``-column slices); :func:`flash_attention`
runs any other head dim on the card by zero-padding q, k and v to the next
one (:func:`padded_flash_attention`: zero columns add nothing to q·k, and o,
dq, dk and dv are sliced back), with the softmax scale of the real head
dim.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.launches import count_copy, count_launch, register, register_copies

DESIGNS = ("mma", "fma")   # bf16 on the tensor cores (mma.sync); fp32 FMA
register("flash_fwd", "flash_dq", "flash_dkv", variants=DESIGNS)
register_copies("flash_do")

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' head dims; others are zero-padded
WIDE = 128   # past 256, the wide kernels take any multiple of WIDE

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


class FlashSpec(NamedTuple):
    """Static configuration of one attention call.

    ``block_k`` is the plain version's kv chunk (the JAX package's tile);
    the CUDA kernels use tiles of their own.
    """

    scale: float
    causal: bool
    window: int          # sliding-window size; 0 = full attention
    use_valid: bool      # apply the per-example kv_valid length mask
    block_k: int = 128


def _backend(device: torch.device, plain: bool) -> str:
    if plain or device.type == "cpu":
        return "plain"
    if device.type in ("cuda", "meta"):
        return device.type
    raise ValueError(f"flash attention has no backend for device {device}")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load

        lib = load("flash_attention")
        p, i, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        shape = [i] * 6 + [f64, i, i, i, p]   # B H Hkv S T D, scale, flags, stream
        lib.flash_fwd.argtypes = [p, p, p, p, p, p, p, i] + shape
        lib.flash_dq.argtypes = [p, p, p, p, p, p, p, p, p, i] + shape
        lib.flash_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p, i] + shape
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv):
            fn.restype = i
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# mask algebra (the JAX package's ``_mask_conds``)
# ---------------------------------------------------------------------------

def _mask_conds(spec: FlashSpec, rows, cols, offset: int, valid):
    """Keep-mask over (rows, cols) absolute indices; None if nothing is masked.

    ``offset = T − S`` aligns causal masking for cross-length attention.
    """
    ok = None

    def _and(a, b):
        return b if a is None else a & b

    if spec.causal:
        ok = _and(ok, cols <= rows + offset)
    if spec.window:
        ok = _and(ok, cols > rows + offset - spec.window)
    if spec.use_valid:
        ok = _and(ok, cols < valid)
    return ok


def _chunk_mask(spec: FlashSpec, s: int, j0: int, width: int, valid, offset: int, dev):
    """(B or 1, 1, 1, S or 1, width) keep-mask of kv columns [j0, j0+width)."""
    rows = torch.arange(s, device=dev)[:, None]
    cols = j0 + torch.arange(width, device=dev)[None, :]
    lim = valid[:, None, None] if spec.use_valid else None
    ok = _mask_conds(spec, rows[None], cols[None], offset, lim)
    return None if ok is None else ok[:, None, None]


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o∘do) in fp32, (B, H, S): the backward's one reduction
    outside the kernels."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(-1)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, valid, spec: FlashSpec
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) by the chunked online softmax over kv blocks of
    ``spec.block_k`` (port of ``_xla_fwd``): o in q's dtype, lse fp32."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    offset = t - s
    f32 = torch.float32
    qg = q.reshape(b, hkv, g, s, d).to(f32)
    m = torch.full((b, hkv, g, s), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, d), dtype=f32, device=q.device)
    for j0 in range(0, t, spec.block_k):
        kj = k[:, :, j0:j0 + spec.block_k].to(f32)
        vj = v[:, :, j0:j0 + spec.block_k].to(f32)
        sij = torch.einsum("bngsd,bntd->bngst", qg, kj) * spec.scale
        ok = _chunk_mask(spec, s, j0, kj.shape[2], valid, offset, q.device)
        if ok is not None:
            sij = torch.where(ok, sij, NEG_INF)
        m_new = torch.maximum(m, sij.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sij - m_new[..., None])
        if ok is not None:
            p = torch.where(ok, p, 0.0)   # fully masked rows: p = 0, not 1
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum("bngst,bntd->bngsd", p, vj)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = (acc / l[..., None]).reshape(b, h, s, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return o, lse


def _grads_plain(q, k, v, valid, lse, di, do, spec: FlashSpec, *, want_dq: bool,
                 want_dkv: bool):
    """(dq, dk, dv) from the residuals, p rebuilt per kv block from lse
    (port of ``_xla_bwd``); each in its input's dtype, None where not wanted."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    offset = t - s
    f32 = torch.float32
    qg = q.reshape(b, hkv, g, s, d).to(f32)
    dog = do.reshape(b, hkv, g, s, d).to(f32)
    lseg = lse.reshape(b, hkv, g, s)
    dig = di.reshape(b, hkv, g, s)
    dq = torch.zeros((b, hkv, g, s, d), dtype=f32, device=q.device)
    dks, dvs = [], []
    for j0 in range(0, t, spec.block_k):
        kj = k[:, :, j0:j0 + spec.block_k].to(f32)
        vj = v[:, :, j0:j0 + spec.block_k].to(f32)
        sij = torch.einsum("bngsd,bntd->bngst", qg, kj) * spec.scale
        ok = _chunk_mask(spec, s, j0, kj.shape[2], valid, offset, q.device)
        if ok is not None:
            sij = torch.where(ok, sij, NEG_INF)
        p = torch.exp(sij - lseg[..., None])
        if ok is not None:
            # fully masked rows have lse ≈ NEG_INF: zero p as in the forward
            p = torch.where(ok, p, 0.0)
        dp = torch.einsum("bngsd,bntd->bngst", dog, vj)
        ds = p * (dp - dig[..., None])
        if want_dkv:
            dks.append(spec.scale * torch.einsum("bngst,bngsd->bntd", ds, qg))
            dvs.append(torch.einsum("bngst,bngsd->bntd", p, dog))
        if want_dq:
            dq = dq + spec.scale * torch.einsum("bngst,bntd->bngsd", ds, kj)
    return (dq.reshape(b, h, s, d).to(q.dtype) if want_dq else None,
            torch.cat(dks, 2).to(k.dtype) if want_dkv else None,
            torch.cat(dvs, 2).to(v.dtype) if want_dkv else None)


def flash_dq_plain(q, k, v, valid, lse, di, do, spec: FlashSpec) -> torch.Tensor:
    """dq alone (what K4 computes), given di = rowsum(o∘do)."""
    return _grads_plain(q, k, v, valid, lse, di, do, spec, want_dq=True, want_dkv=False)[0]


def flash_dkv_plain(q, k, v, valid, lse, di, do, spec: FlashSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) alone (what K5 computes), given di = rowsum(o∘do)."""
    return _grads_plain(q, k, v, valid, lse, di, do, spec, want_dq=False, want_dkv=True)[1:]


def flash_attention_bwd_plain(q, k, v, valid, o, lse, do, spec: FlashSpec
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in one pass over the kv blocks."""
    return _grads_plain(q, k, v, valid, lse, row_dot(o, do), do, spec, want_dq=True,
                        want_dkv=True)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def aligned16(x: torch.Tensor) -> bool:
    """``x``'s first element on a 16-byte boundary; on the meta device, as
    the caching allocator's 512-byte aligned storage would place it."""
    if x.device.type == "meta":
        return x.storage_offset() * x.element_size() % 16 == 0
    return x.data_ptr() % 16 == 0


def _rows_aligned(x: torch.Tensor) -> bool:
    """A 16-byte aligned base pointer and (b, h, s) strides of whole 16 bytes."""
    n = 16 // x.element_size()
    return aligned16(x) and all(st % n == 0 for st in x.stride()[:3])


def _check(q, k, v, valid, spec: FlashSpec, *, aligned: bool = False, **more) -> None:
    """Raise on what the kernels cannot take; ``aligned``: also on a bf16
    tensor the tensor-core kernels could not copy in 16-byte pieces."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B, H, S, D) and (B, Hkv, T, D)")
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"n_heads {h} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS and not (d > HEAD_DIMS[-1] and d % WIDE == 0):
        raise ValueError(f"head dim {d} is not one of the kernels' {HEAD_DIMS} nor a "
                         f"multiple of {WIDE} past them (flash_attention pads others)")
    if min(b, h, s, t) < 1 or max(b * h, s, t) >= 2**31:
        raise ValueError(f"sizes out of range: q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if name in ("lse", "di"):
            if x.dtype != torch.float32 or x.shape != (b, h, s) or not x.is_contiguous():
                raise ValueError(f"{name} must be a contiguous float32 {(b, h, s)} tensor")
            continue
        if x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} differs from q's {q.dtype}")
        if name == "do" and x.shape != q.shape:
            raise ValueError(f"do has shape {tuple(x.shape)}, q {tuple(q.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim (stride {x.stride()})")
        if aligned and x.dtype == torch.bfloat16 and not _rows_aligned(x):
            raise ValueError(
                f"{name}: the bf16 tensor-core kernels need a 16-byte aligned base pointer "
                f"and (b, h, s) strides that are multiples of 8 elements; got a pointer "
                f"{x.data_ptr() % 16} bytes off a 16-byte boundary and strides {x.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} is not float32 or bfloat16")
    if valid is None:
        if spec.use_valid:
            raise ValueError("spec.use_valid needs a valid tensor")
    elif valid.device != q.device or valid.dtype != torch.int32 or valid.shape != (b,) \
            or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous int32 (B,) tensor on q's device")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _strides(*ts) -> ctypes.Array:
    """(B, H, S) element strides of each 4-D tensor, in order, as int64[]."""
    vals = [st for x in ts for st in x.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _shape_args(q, k, spec: FlashSpec) -> list:
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    return [b, h, hkv, s, t, d, spec.scale, int(spec.causal), int(spec.window),
            int(spec.use_valid), stream]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _count(name: str, dtype: torch.dtype) -> None:
    """One launch of ``name``, under the design its dtype runs (the library
    dispatches bf16 to the tensor cores, fp32 to the FMA kernels)."""
    count_launch(name, DESIGNS[0] if dtype == torch.bfloat16 else DESIGNS[1])


def _fwd_cuda(q, k, v, valid, spec: FlashSpec):
    _check(q, k, v, valid, spec, aligned=True)
    o = torch.empty_like(q)   # q's strides: a (B, S, H, D) caller gets its layout back
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _lib().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid),
                           o.data_ptr(), lse.data_ptr(), _strides(q, k, v, o),
                           _DTYPE_CODES[q.dtype], *_shape_args(q, k, spec))
    _raise_on(err, "flash_fwd")
    _count("flash_fwd", q.dtype)
    return o, lse


def _dq_cuda(q, k, v, valid, lse, di, do, spec: FlashSpec):
    _check(q, k, v, valid, spec, aligned=True, do=do, lse=lse, di=di)
    dq = torch.empty_like(q)
    err = _lib().flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                          lse.data_ptr(), di.data_ptr(), _ptr(valid), dq.data_ptr(),
                          _strides(q, k, v, do, dq), _DTYPE_CODES[q.dtype],
                          *_shape_args(q, k, spec))
    _raise_on(err, "flash_dq")
    _count("flash_dq", q.dtype)
    return dq


def _dkv_cuda(q, k, v, valid, lse, di, do, spec: FlashSpec):
    _check(q, k, v, valid, spec, aligned=True, do=do, lse=lse, di=di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                           lse.data_ptr(), di.data_ptr(), _ptr(valid), dk.data_ptr(),
                           dv.data_ptr(), _strides(q, k, v, do, dk, dv),
                           _DTYPE_CODES[q.dtype], *_shape_args(q, k, spec))
    _raise_on(err, "flash_dkv")
    _count("flash_dkv", q.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# meta routes: what each launch allocates, and its count (the dry-run)
# ---------------------------------------------------------------------------

def _work(fn, q, k, valid, spec: FlashSpec):
    b, h, s, d = q.shape
    return fn(b, h, k.shape[1], s, k.shape[2], d, q.dtype, spec.causal, spec.window,
              lengths=valid is not None)


def _fwd_meta(q, k, v, valid, spec: FlashSpec):
    _check(q, k, v, valid, spec, aligned=True)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    cost.record("flash_fwd", _work(cost.flash_fwd, q, k, valid, spec))
    return o, lse


def _dq_meta(q, k, v, valid, lse, di, do, spec: FlashSpec):
    _check(q, k, v, valid, spec, aligned=True, do=do, lse=lse, di=di)
    cost.record("flash_dq", _work(cost.flash_dq, q, k, valid, spec))
    return torch.empty_like(q)


def _dkv_meta(q, k, v, valid, lse, di, do, spec: FlashSpec):
    _check(q, k, v, valid, spec, aligned=True, do=do, lse=lse, di=di)
    cost.record("flash_dkv", _work(cost.flash_dkv, q, k, valid, spec))
    return torch.empty_like(k), torch.empty_like(v)


_ROUTES = {"cuda": (_fwd_cuda, _dq_cuda, _dkv_cuda), "meta": (_fwd_meta, _dq_meta, _dkv_meta)}


def flash_attention_fwd(q, k, v, valid, spec: FlashSpec, *, plain: bool = False):
    """(o, lse): kernel K3 on a CUDA tensor, the plain version on a CPU one
    (or anywhere with ``plain=True``), the meta route on a meta one."""
    backend = _backend(q.device, plain)
    if backend == "plain":
        return flash_attention_fwd_plain(q, k, v, valid, spec)
    return _ROUTES[backend][0](q, k, v, valid, spec)


def flash_dq(q, k, v, valid, lse, di, do, spec: FlashSpec, *, plain: bool = False):
    """dq: kernel K4 on a CUDA tensor, else the plain version (or the meta
    route)."""
    backend = _backend(q.device, plain)
    if backend == "plain":
        return flash_dq_plain(q, k, v, valid, lse, di, do, spec)
    return _ROUTES[backend][1](q, k, v, valid, lse, di, do, spec)


def flash_dkv(q, k, v, valid, lse, di, do, spec: FlashSpec, *, plain: bool = False):
    """(dk, dv): kernel K5 on a CUDA tensor, else the plain version (or the
    meta route)."""
    backend = _backend(q.device, plain)
    if backend == "plain":
        return flash_dkv_plain(q, k, v, valid, lse, di, do, spec)
    return _ROUTES[backend][2](q, k, v, valid, lse, di, do, spec)


def flash_attention_bwd(q, k, v, valid, o, lse, do, spec: FlashSpec, *, plain: bool = False):
    """(dq, dk, dv): di = rowsum(o∘do) by torch, then K4 and K5 on CUDA
    tensors (or their meta routes), else the plain version in one pass."""
    backend = _backend(q.device, plain)
    if backend == "plain":
        return flash_attention_bwd_plain(q, k, v, valid, o, lse, do, spec)
    _, dq_fn, dkv_fn = _ROUTES[backend]
    di = row_dot(o, do)
    return (dq_fn(q, k, v, valid, lse, di, do, spec),
            *dkv_fn(q, k, v, valid, lse, di, do, spec))


# ---------------------------------------------------------------------------
# autograd boundary and public entry
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """``(o, lse) = apply(q, k, v, valid, spec, plain)``; saves the residuals
    of the JAX package's ``_flash_fwd``: q, k, v, valid, o, lse (``valid``
    is None when ``spec.use_valid`` is off)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, spec: FlashSpec, plain: bool):
        o, lse = flash_attention_fwd(q, k, v, valid, spec, plain=plain)
        ctx.save_for_backward(q, k, v, valid, o, lse)
        ctx.spec, ctx.plain = spec, plain
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, valid, o, lse = ctx.saved_tensors
        # autograd may hand do in a layout the kernels cannot read (a strided
        # last dim; for the tensor-core kernels, rows not in whole 16 bytes):
        # then do alone is made contiguous, and COPIES counts it.  The main
        # path's do is the (B, S, H, D) gradient, which needs no copy.
        if do.stride(-1) != 1 or (not ctx.plain and do.device.type in ("cuda", "meta")
                                  and do.dtype == torch.bfloat16 and not _rows_aligned(do)):
            do = torch.empty_like(do, memory_format=torch.contiguous_format).copy_(do)
            count_copy("flash_do")
        dq, dk, dv = flash_attention_bwd(q, k, v, valid, o, lse, do, ctx.spec,
                                         plain=ctx.plain)
        return dq, dk, dv, None, None, None


def kernel_head_dim(d: int) -> int:
    """The head dim of the kernels that run head dim ``d``: the smallest of
    ``HEAD_DIMS`` at least ``d``, and past the largest the next multiple of
    ``WIDE`` (the wide kernels')."""
    for dk in HEAD_DIMS:
        if d <= dk:
            return dk
    return -(-d // WIDE) * WIDE


def padded_flash_attention(q, k, v, valid, spec: FlashSpec, plain: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of :class:`FlashAttention` with q, k and v zero-padded
    from head dim D to :func:`kernel_head_dim` (D) and o sliced back to D;
    autograd slices dq, dk and dv back the same way.  ``spec.scale`` is the
    caller's (1/√D of the real D); lse is the unpadded call's, since zero
    columns add nothing to q·k.  A head dim of the kernels passes through."""
    d = q.shape[-1]
    dk = kernel_head_dim(d)
    if dk != d:
        q, k, v = (torch.nn.functional.pad(x, (0, dk - d)) for x in (q, k, v))
    o, lse = FlashAttention.apply(q, k, v, valid, spec, plain)
    return (o if dk == d else o[..., :d]), lse


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D), Hkv dividing H
    v: torch.Tensor,  # (B, Hkv, T, D)
    kv_valid: Optional[torch.Tensor] = None,  # (B,) valid kv lengths
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    window: int = 0,
    plain: bool = False,
) -> torch.Tensor:
    """Differentiable flash attention (port of ``repro.kernels.flash_attention``).

    Keys at positions ``>= kv_valid[b]`` are masked for every query row of
    example ``b`` (lengths clipped to [1, T]; None masks nothing and passes
    the kernels no lengths at all); ``scale`` defaults to 1/√D.
    Any S and T: the kernels mask their own ragged tails.  Any head dim: on
    the card one outside ``HEAD_DIMS`` (and, past 256, not a multiple of
    ``WIDE``) runs padded (:func:`padded_flash_attention`); the plain version
    takes it as it is.
    ``plain=True`` runs the plain version on any device, the reference a
    kernel run is held to on the card.
    """
    h, d = q.shape[1], q.shape[3]
    hkv, t = k.shape[1], k.shape[2]
    if h % max(hkv, 1):
        raise ValueError(f"n_heads {h} not a multiple of kv heads {hkv}")
    scale = scale if scale is not None else 1.0 / (d**0.5)
    valid = None
    if kv_valid is not None:
        valid = torch.clamp(kv_valid.to(device=q.device, dtype=torch.int32), 1, t).contiguous()
    spec = FlashSpec(scale=float(scale), causal=bool(causal), window=int(window),
                     use_valid=valid is not None)
    if _backend(q.device, plain) != "plain":   # the kernels' head dims
        return padded_flash_attention(q, k, v, valid, spec)[0]
    o, _ = FlashAttention.apply(q, k, v, valid, spec, plain)
    return o
