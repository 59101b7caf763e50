"""Fused LAMB update on one tensor: CUDA kernels K1/K2 and their plain version.

Port of ``repro.kernels.lamb_update`` (the Pallas kernels ``_moments_kernel``
and ``_apply_kernel``).  The leaf is viewed as ``(layers, P)`` — layers =
the stacked axis when ``layer_axis == 0``, else 1 — and updated in two
passes (see ``csrc/lamb_update.cu`` for the kernels, their bound and design):

  pass A (:func:`lamb_moments`): m', v' in place, per-layer Σx² and Σu²;
  between the passes, a few torch ops: the trust ratio φ(‖x‖)/‖u‖ (1 when
      either norm is 0, φ clipped to ``phi_lo/phi_hi``), times lr_t;
  pass B (:func:`lamb_apply`): x' = x − ratio·u in place, per-layer Σ(x'−x)².

``ok`` (an int32 device scalar, or None for "always") is the non-finite
guard's verdict: where it is 0, pass A stores no moment and pass B no
parameter (Σ(x'−x)² is 0), so the skipped step leaves x, m and v
bit-identical without a copy and without waiting on the host.

Each pass dispatches on where its tensors lie: on the CPU it runs the plain
PyTorch version below; on a CUDA tensor it launches the kernel or raises;
on a meta tensor (the dry-run) it allocates what the kernel's call
allocates (the per-block partial sums), launches nothing and adds the
kernel's ``kernels/cost.py`` count to the dry-run's.  There is no fallback
from the kernel to the plain version or the meta route.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Collection, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.launches import count_launch, register

register("lamb_moments", "lamb_apply")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/lamb_update.cu's kChunk (kThreads × kItems): the elements of a layer
# one block sums, for the meta route's partials; a change there must be made
# here too (chip_smoke.py's check_split_plans holds the two equal on the card)
CHUNK_ELEMS = 4096
_LIB: Optional[ctypes.CDLL] = None


def resolve_fused_backend(device: torch.device) -> str:
    """``"plain"`` for CPU tensors, ``"cuda"`` for CUDA tensors, ``"meta"``
    for meta tensors (the dry-run's route); else raise."""
    if device.type == "cpu":
        return "plain"
    if device.type in ("cuda", "meta"):
        return device.type
    raise ValueError(f"fused LAMB has no backend for device {device}")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load

        lib = load("lamb_update")
        p, i, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
        lib.lamb_chunk_elems.argtypes = []
        lib.lamb_chunk_elems.restype = i
        lib.lamb_moments.argtypes = [p, i, p, i, p, p, p, p, p, p, i64, i64,
                                     f64, f64, f64, f64, p]
        lib.lamb_moments.restype = i
        lib.lamb_apply.argtypes = [p, i, p, p, p, p, p, p, i64, i64, f64, f64, p]
        lib.lamb_apply.restype = i
        _LIB = lib
    return _LIB


def bias_corrections(step: Union[int, torch.Tensor], b1: float, b2: float,
                     device: torch.device) -> torch.Tensor:
    """``[1/(1-b1^t), 1/(1-b2^t)]`` in fp32 on ``device``, t the 1-based step."""
    t = torch.as_tensor(step, device=device).to(torch.float32)
    return torch.stack([1.0 / (1.0 - b1**t), 1.0 / (1.0 - b2**t)])


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _keep(ok, new, old):
    """``new`` where the step is taken (``ok`` None or nonzero), else ``old``."""
    return new if ok is None else torch.where(ok != 0, new, old)


def lamb_moments_plain(x, g, m, v, c, layers, *, b1, b2, eps, weight_decay, ok=None):
    """Pass A in PyTorch ops (port of ``lamb_update_ref``'s first half)."""
    x32 = x.reshape(layers, -1).to(torch.float32)
    g32 = g.reshape(layers, -1).to(torch.float32)
    m2, v2 = m.view(layers, -1), v.view(layers, -1)
    m_new = m2 * b1 + (1 - b1) * g32
    v_new = v2 * b2 + (1 - b2) * g32 * g32
    u = (m_new * c[0]) / (torch.sqrt(v_new * c[1]) + eps) + weight_decay * x32
    m2.copy_(_keep(ok, m_new, m2))
    v2.copy_(_keep(ok, v_new, v2))
    return (x32 * x32).sum(1), (u * u).sum(1)


def lamb_apply_plain(x, m, v, c, ratio, layers, *, eps, weight_decay, ok=None):
    """Pass B in PyTorch ops (port of ``lamb_update_ref``'s second half)."""
    x2 = x.view(layers, -1)
    x32 = x2.to(torch.float32)
    u = (m.view(layers, -1) * c[0]) / (torch.sqrt(v.view(layers, -1) * c[1]) + eps)
    u = u + weight_decay * x32
    x_new = (x32 - ratio[:, None] * u).to(x.dtype)
    d = x_new.to(torch.float32) - x32
    dsq = (d * d).sum(1)
    x2.copy_(_keep(ok, x_new, x2))
    return dsq if ok is None else torch.where(ok != 0, dsq, 0.0)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(x, g, m, v, layers):
    for name, t in (("x", x), ("g", g), ("m", m), ("v", v)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, x {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("g", g)):
        if t is not None and t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} is not float32 or bfloat16")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("m and v must be float32")
    if x.numel() == 0 or x.numel() % layers:
        raise ValueError(f"x of shape {tuple(x.shape)} is not (layers={layers}, P)")


def _partials(layers: int, per_layer: int, device) -> torch.Tensor:
    chunk = CHUNK_ELEMS if device.type == "meta" else _lib().lamb_chunk_elems()
    nblocks = -(-per_layer // chunk)
    return torch.empty((layers, nblocks), dtype=torch.float32, device=device)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _ok_ptr(ok) -> Optional[int]:
    return None if ok is None else ok.data_ptr()


def _moments_cuda(x, g, m, v, c, layers, *, b1, b2, eps, weight_decay, ok=None):
    per_layer = x.numel() // layers
    xsq = _partials(layers, per_layer, x.device)
    usq = torch.empty_like(xsq)
    err = _lib().lamb_moments(
        x.data_ptr(), _DTYPE_CODES[x.dtype], g.data_ptr(), _DTYPE_CODES[g.dtype],
        m.data_ptr(), v.data_ptr(), c.data_ptr(), _ok_ptr(ok), xsq.data_ptr(),
        usq.data_ptr(),
        layers, per_layer, b1, b2, eps, weight_decay, _stream(x.device),
    )
    _raise_on(err, "lamb_moments")
    count_launch("lamb_moments")
    return xsq.sum(1), usq.sum(1)


def _apply_cuda(x, m, v, c, ratio, layers, *, eps, weight_decay, ok=None):
    per_layer = x.numel() // layers
    dsq = _partials(layers, per_layer, x.device)
    err = _lib().lamb_apply(
        x.data_ptr(), _DTYPE_CODES[x.dtype], m.data_ptr(), v.data_ptr(),
        c.data_ptr(), ratio.data_ptr(), _ok_ptr(ok), dsq.data_ptr(), layers, per_layer,
        eps, weight_decay, _stream(x.device),
    )
    _raise_on(err, "lamb_apply")
    count_launch("lamb_apply")
    return dsq.sum(1)


def _moments_meta(x, g, m, v, c, layers, *, b1, b2, eps, weight_decay, ok=None):
    xsq = _partials(layers, x.numel() // layers, x.device)
    usq = torch.empty_like(xsq)
    cost.record("lamb_moments", cost.lamb_moments(x.numel(), layers, x.dtype, g.dtype,
                                                  ok is not None))
    return xsq.sum(1), usq.sum(1)


def _apply_meta(x, m, v, c, ratio, layers, *, eps, weight_decay, ok=None):
    dsq = _partials(layers, x.numel() // layers, x.device)
    cost.record("lamb_apply", cost.lamb_apply(x.numel(), layers, x.dtype, ok is not None))
    return dsq.sum(1)


# ---------------------------------------------------------------------------
# the two passes, and the whole update
# ---------------------------------------------------------------------------

_MOMENTS = {"plain": lamb_moments_plain, "cuda": _moments_cuda, "meta": _moments_meta}
_APPLY = {"plain": lamb_apply_plain, "cuda": _apply_cuda, "meta": _apply_meta}


def _check_ok(ok, x) -> None:
    if ok is None:
        return
    if ok.device != x.device or ok.dtype != torch.int32 or ok.numel() != 1:
        raise ValueError(f"ok must be one int32 on {x.device}, got {ok.dtype} "
                         f"{tuple(ok.shape)} on {ok.device}")


@torch.no_grad()
def lamb_moments(x, g, m, v, c, layers: int, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 ok: Optional[torch.Tensor] = None, plain: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A: m, v updated in place; returns per-layer (Σx², Σu²) in fp32.

    ``c`` is the fp32 ``[c1, c2]`` bias-correction pair on x's device; with
    ``ok`` (int32 device scalar) 0, m and v are left as they were.  Runs the
    kernel on a CUDA tensor, the plain version on a CPU tensor (or anywhere
    with ``plain=True``), the meta route on a meta one.
    """
    _check(x, g, m, v, layers)
    _check_ok(ok, x)
    fn = _MOMENTS["plain" if plain else resolve_fused_backend(x.device)]
    return fn(x, g, m, v, c.to(torch.float32).contiguous(), layers, b1=b1, b2=b2,
              eps=eps, weight_decay=weight_decay, ok=ok)


@torch.no_grad()
def lamb_apply(x, m, v, c, ratio, layers: int, *, eps: float = 1e-6,
               weight_decay: float = 0.01, ok: Optional[torch.Tensor] = None,
               plain: bool = False) -> torch.Tensor:
    """Pass B: x updated in place by ``ratio[layer]·u``; returns per-layer Σ(x'−x)².

    ``ratio`` is the fp32 per-layer trust ratio with the learning rate folded
    in; with ``ok`` 0, x is left as it was and the sums are 0.  Dispatches
    like :func:`lamb_moments`.
    """
    _check(x, None, m, v, layers)
    _check_ok(ok, x)
    if ratio.shape != (layers,):
        raise ValueError(f"ratio has shape {tuple(ratio.shape)}, want ({layers},)")
    fn = _APPLY["plain" if plain else resolve_fused_backend(x.device)]
    return fn(x, m, v, c.to(torch.float32).contiguous(),
              ratio.to(torch.float32).contiguous(), layers, eps=eps,
              weight_decay=weight_decay, ok=ok)


class LambOut(NamedTuple):
    x: torch.Tensor         # x' (the input tensor, updated in place)
    m: torch.Tensor         # m' (in place)
    v: torch.Tensor         # v' (in place)
    ratio: torch.Tensor     # applied trust ratio before the lr fold: (layers,) or ()
    delta_sq: torch.Tensor  # Σ(x' − x)² over the leaf, fp32 scalar


def trust_ratio(xsq, usq, *, phi_lo=None, phi_hi=None, apply_trust=True):
    """Per-layer φ(‖x‖)/‖u‖; 1 where either norm is 0 or trust is off."""
    w_norm = torch.sqrt(xsq)
    u_norm = torch.sqrt(usq)
    if phi_lo is not None or phi_hi is not None:
        w_norm = torch.clamp(w_norm, min=0.0 if phi_lo is None else phi_lo,
                             max=float("inf") if phi_hi is None else phi_hi)
    one = torch.ones_like(w_norm)
    if not apply_trust:
        return one
    return torch.where(w_norm > 0, torch.where(u_norm > 0, w_norm / u_norm, one), one)


@torch.no_grad()
def lamb_update_leaves(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    mu: Dict[str, torch.Tensor],
    nu: Dict[str, torch.Tensor],
    c: torch.Tensor,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    wd_mask: Optional[Dict[str, bool]] = None,
    trust_mask: Optional[Dict[str, bool]] = None,
    layer_axes: Optional[Dict[str, int]] = None,
    phi_bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
    ok: Optional[torch.Tensor] = None,
    plain: bool = False,
    split: Sequence[str] = (),
    uncounted: Collection[str] = frozenset(),
    reduce_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The two passes over a dict of leaves, in place on params, mu and nu.

    ``c`` is the ``[c1, c2]`` bias-correction pair and ``lr`` the fp32
    learning rate, both on the leaves' device.  Pass A runs on every leaf,
    then pass B.  The ``split`` leaves are one rank's slices: their
    per-layer (Σx², Σu²) partials are packed into one buffer that
    ``reduce_sum`` sums over the ranks in one call before the trust ratios,
    and their Σ(x'−x)² the same way after pass B, so every ratio and sum is
    the whole leaf's; this rank adds zeros for the ``uncounted`` ones (a
    block another rank holds too, and counts).  Returns ``({path: ratio}, {path: Σ(x'−x)²})``: the
    applied trust ratio before the lr fold ((layers,) for a stacked leaf,
    else a scalar) and the fp32 squared update norm of each leaf.
    """
    lo, hi = (None, None) if phi_bounds is None else phi_bounds
    leaves = {}
    for k, x in params.items():
        stacked = (layer_axes or {}).get(k, -1) == 0
        layers = x.shape[0] if stacked else 1
        wd = weight_decay if (wd_mask or {}).get(k, True) else 0.0
        sums = lamb_moments(x, grads[k], mu[k], nu[k], c, layers, b1=b1, b2=b2,
                            eps=eps, weight_decay=wd, ok=ok, plain=plain)
        leaves[k] = (stacked, layers, wd, sums)
    if split:   # one collective for every split leaf's per-layer partials
        packed = reduce_sum(torch.cat([torch.zeros_like(t) if k in uncounted else t
                                       for k in split for t in leaves[k][3]]))
        at = 0
        for k in split:
            stacked, layers, wd, _ = leaves[k]
            leaves[k] = (stacked, layers, wd,
                         (packed[at:at + layers], packed[at + layers:at + 2 * layers]))
            at += 2 * layers
    ratios, dsq = {}, {}
    for k, x in params.items():
        stacked, layers, wd, (xsq, usq) = leaves[k]
        ratio = trust_ratio(xsq, usq, phi_lo=lo, phi_hi=hi,
                            apply_trust=bool((trust_mask or {}).get(k, True)))
        dsq[k] = lamb_apply(x, mu[k], nu[k], c, ratio * lr, layers, eps=eps,
                            weight_decay=wd, ok=ok, plain=plain).sum()
        ratios[k] = ratio if stacked else ratio[0]
    if split:
        dsq.update(zip(split, reduce_sum(torch.stack(
            [torch.zeros_like(dsq[k]) if k in uncounted else dsq[k] for k in split])).unbind()))
    return ratios, dsq


@torch.no_grad()
def lamb_update(
    x: torch.Tensor,
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    step: Union[int, torch.Tensor],
    lr_t: Union[float, torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    phi_lo: Optional[float] = None,
    phi_hi: Optional[float] = None,
    layer_axis: Optional[int] = None,
    apply_trust: bool = True,
    ok: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> LambOut:
    """One fused LAMB step on one tensor, in place on x, m and v: the
    one-leaf call of :func:`lamb_update_leaves`.

    ``step`` is the 1-based iteration and ``lr_t`` the learning rate (either
    may be a device tensor: nothing here waits on the host).  ``layer_axis``
    is 0 (per-layer trust ratios over a stacked leaf) or None/-1 (one ratio).
    ``ok`` (int32 device scalar or None) is the non-finite guard: with 0,
    x, m and v are left bit-identical and ``delta_sq`` is 0.
    ``plain=True`` runs the plain passes whatever the device: the reference
    a kernel run is held to on the card.
    """
    if layer_axis not in (None, -1, 0):
        raise ValueError("lamb_update supports layer_axis in {None, 0}")
    c = bias_corrections(step, b1, b2, x.device)
    lr = torch.as_tensor(lr_t, dtype=torch.float32, device=x.device)
    ratios, dsq = lamb_update_leaves(
        {"x": x}, {"x": g}, {"x": m}, {"x": v}, c, lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, trust_mask={"x": apply_trust},
        layer_axes={"x": 0 if layer_axis == 0 else -1}, phi_bounds=(phi_lo, phi_hi),
        ok=ok, plain=plain)
    return LambOut(x, m, v, ratios["x"], dsq["x"])
