"""The port's flash attention (K3–K5, the plain version on the CPU) against
the JAX package's flash attention on the same numpy inputs: forward and lse,
gradients, the ``flash_sdpa`` wrapper, the attention layer, and bert-smoke
train steps with flash on.  The JAX side runs its Pallas kernels in interpret
mode or its XLA backend, as the JAX suite does on the CPU.  Tolerances are the
JAX suite's own: 3e-5 in fp32 and 3e-2 in bf16.  The bf16 kernels' rounding on
the tensor cores (K3 and K5) is emulated in torch and held to the same."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import synthetic as jax_synthetic
from repro.kernels import flash_sdpa as jax_flash_sdpa
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import build_model as jax_build_model
from repro.models.layers import attention as jax_attention
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import bert_large, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.data import batch_iterator
from repro_torch.kernels import LAUNCHES, flash_sdpa, reset_launches
from repro_torch.kernels.flash_attention import NEG_INF, FlashSpec, _check, _chunk_mask, \
    _dkv_cuda, _dq_cuda, _fwd_cuda, flash_attention, flash_attention_fwd, flash_dq, row_dot
from repro_torch.models import build_model
from repro_torch.models.layers import attention
from repro_torch.nn import params_from_jax, state_from_jax
from repro_torch.train import TrainState, make_train_step

jax_flash_mod = importlib.import_module("repro.kernels.flash_attention")
F32, BF16 = 3e-5, 3e-2
NO_CE = dict(use_fused_ce_head=False)


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(a, b, tol, msg=""):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# forward and lse
# ---------------------------------------------------------------------------

# tests/test_kernels.py FLASH_SHAPES: (b, h, s, t, d, causal)
FLASH_SHAPES = [
    (1, 2, 128, 128, 64, True),
    (2, 3, 256, 256, 32, True),
    (1, 1, 128, 384, 64, False),   # cross-length, non-causal
    (2, 2, 384, 384, 128, True),
]


def _jax_fwd(backend, q, k, v, valid, *, causal, window=0):
    """(o, lse) of the JAX package's forward, lse included."""
    s, t = q.shape[2], k.shape[2]
    spec = jax_flash_mod.FlashSpec(
        scale=1.0 / q.shape[-1] ** 0.5, causal=causal, window=window,
        block_q=min(128, s), block_k=min(128, t), use_valid=valid is not None,
        backend=backend)
    full = jnp.full((q.shape[0],), t, jnp.int32) if valid is None else \
        jnp.clip(valid, 1, t)
    return jax_flash_mod._fwd_impl(spec, q, k, v, full)


def _port_fwd(q, k, v, valid, *, causal, window=0):
    spec = FlashSpec(1.0 / q.shape[-1] ** 0.5, causal, window, valid is not None)
    lim = None if valid is None else torch.clamp(valid, 1, k.shape[2])
    return flash_attention_fwd(q, k, v, lim, spec)


@pytest.mark.parametrize("b,h,s,t,d,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_flash_forward_and_lse_match_jax(b, h, s, t, d, causal, dtype, backend):
    (jq, q), (jk, k), (jv, v) = (_pair(_np(sh, i), dtype) for i, sh in
                                 enumerate([(b, h, s, d), (b, h, t, d), (b, h, t, d)]))
    jo, jlse = _jax_fwd(backend, jq, jk, jv, None, causal=causal)
    o, lse = _port_fwd(q, k, v, None, causal=causal)
    tol = BF16 if dtype == jnp.bfloat16 else F32
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    _assert_close(o, jo, tol, "o")
    _assert_close(lse, jlse, tol, "lse")
    # the public entry (through the autograd boundary) gives the same o
    torch.testing.assert_close(flash_attention(q, k, v, causal=causal), o, rtol=0, atol=0)


@pytest.mark.parametrize("s,w", [(512, 128), (256, 64), (384, 256)])
def test_flash_sliding_window_matches_jax(s, w):
    (jq, q), (jk, k), (jv, v) = (_pair(_np((1, 2, s, 64), i + 10), jnp.float32)
                                 for i in range(3))
    for backend in ("interpret", "xla"):
        jo, jlse = _jax_fwd(backend, jq, jk, jv, None, causal=True, window=w)
        o, lse = _port_fwd(q, k, v, None, causal=True, window=w)
        _assert_close(o, jo, F32, backend)
        _assert_close(lse, jlse, F32, backend)


def test_flash_gqa_layout_wrapper_matches_jax():
    b, s, h, hkv, d = 2, 128, 8, 2, 32
    (jq, q), (jk, k), (jv, v) = (_pair(_np(sh, i + 20), jnp.float32) for i, sh in
                                 enumerate([(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)]))
    jo = jax_flash_sdpa(jq, jk, jv, causal=True, interpret=True)
    o = flash_sdpa(q, k, v, causal=True)
    assert o.shape == (b, s, h, d)
    _assert_close(o, jo, F32)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _grads(port_fn, jax_fn, arrays, do, dtype=jnp.float32):
    """Outputs and (dq, dk, dv) of both under the same cotangent ``do``."""
    pairs = [_pair(a, dtype) for a in arrays]
    jo, vjp = jax.vjp(jax_fn, *(j for j, _ in pairs))
    jd, td = _pair(do, jo.dtype)
    jg = vjp(jd)
    ts = [t.requires_grad_() for _, t in pairs]
    o = port_fn(*ts)
    g = torch.autograd.grad(o, ts, td)
    return (o, *g), (jo, *jg)


# tests/test_kernels.py FLASH_GRAD_CASES: (b, h, hkv, s, d, causal, masked)
FLASH_GRAD_CASES = [
    (1, 2, 2, 128, 32, True, False),
    (1, 2, 2, 128, 32, False, False),    # bidirectional (BERT MLM)
    (2, 4, 1, 128, 32, True, False),     # MQA
    (2, 4, 2, 128, 16, False, False),    # GQA bidirectional
    (2, 2, 2, 128, 32, False, True),     # padding mask, bidirectional
    (1, 4, 2, 256, 32, True, True),      # padding mask + GQA + causal
]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,masked", FLASH_GRAD_CASES)
@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_flash_grads_match_jax(b, h, hkv, s, d, causal, masked, backend):
    valid = np.random.default_rng(30).integers(s // 2, s + 1, size=(b,)).astype(np.int32) \
        if masked else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)
    arrays = [_np((b, h, s, d), 31), _np((b, hkv, s, d), 32), _np((b, hkv, s, d), 33)]
    port, ref = _grads(
        lambda q, k, v: flash_attention(q, k, v, tvalid, causal=causal),
        lambda q, k, v: jax_flash(q, k, v, jvalid, causal=causal, backend=backend),
        arrays, _np((b, h, s, d), 34))
    for name, a, r in zip(("o", "dq", "dk", "dv"), port, ref):
        _assert_close(a, r, F32, name)


def test_flash_grads_window_match_jax():
    arrays = [_np((1, 2, 256, 32), 40 + i) for i in range(3)]
    port, ref = _grads(
        lambda q, k, v: flash_attention(q, k, v, causal=True, window=100),
        lambda q, k, v: jax_flash(q, k, v, causal=True, window=100, interpret=True),
        arrays, _np((1, 2, 256, 32), 43))
    for name, a, r in zip(("o", "dq", "dk", "dv"), port, ref):
        _assert_close(a, r, F32, name)


def test_flash_grads_bf16_match_jax():
    """bf16 q/k/v: fp32 inside, bf16 gradients out."""
    arrays = [_np((1, 2, 128, 64), 50 + i) for i in range(3)]
    port, ref = _grads(
        lambda q, k, v: flash_attention(q, k, v, causal=False),
        lambda q, k, v: jax_flash(q, k, v, causal=False, interpret=True),
        arrays, _np((1, 2, 128, 64), 53), dtype=jnp.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in port)
    for name, a, r in zip(("o", "dq", "dk", "dv"), port, ref):
        _assert_close(a, r, BF16, name)


@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_flash_window_plus_valid_fully_masked_rows(backend):
    """window ∩ valid is empty for some rows of example 0: o = 0 and zero
    gradients there, the JAX package's values everywhere."""
    b, h, s, d, w = 2, 2, 256, 32, 64
    valid = np.array([40, s], np.int32)
    live = np.arange(s)[None, :] <= valid[:, None] + w - 2          # (b, s)
    lm = np.broadcast_to(live[:, None, :, None], (b, h, s, d)).astype(np.float32)
    do = _np((b, h, s, d), 63) * lm   # a loss that never reads the dead rows
    arrays = [_np((b, h, s, d), 60 + i) for i in range(3)]
    port, ref = _grads(
        lambda q, k, v: flash_attention(q, k, v, torch.from_numpy(valid), causal=True,
                                        window=w),
        lambda q, k, v: jax_flash(q, k, v, jnp.asarray(valid), causal=True, window=w,
                                  backend=backend),
        arrays, do)
    assert float(np.abs(_f32(port[0]) * (1 - lm)).max()) == 0.0   # dead rows: o = 0
    assert float(np.abs(_f32(port[1]) * (1 - lm)).max()) == 0.0   # and dq = 0
    for name, a, r in zip(("o", "dq", "dk", "dv"), port, ref):
        _assert_close(a, r, F32, name)


def test_flash_sdpa_ragged_lengths_match_jax():
    """s = 200: JAX pads to the block and masks; the port masks its own tail."""
    b, s, h, hkv, d = 2, 200, 4, 2, 32
    arrays = [_np((b, s, h, d), 70), _np((b, s, hkv, d), 71), _np((b, s, hkv, d), 72)]
    port, ref = _grads(
        lambda q, k, v: flash_sdpa(q, k, v, causal=False),
        lambda q, k, v: jax_flash_sdpa(q, k, v, causal=False, interpret=True),
        arrays, _np((b, s, h, d), 73))
    for name, a, r in zip(("o", "dq", "dk", "dv"), port, ref):
        _assert_close(a, r, F32, name)


def test_flash_runs_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version and launches no kernel."""
    reset_launches()
    q = torch.from_numpy(_np((1, 2, 64, 32), 75)).requires_grad_()
    flash_attention(q, q, q, causal=True).sum().backward()
    assert all(LAUNCHES[k] == 0 for k in ("flash_fwd", "flash_dq", "flash_dkv"))
    assert torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, q[:, :1].expand(1, 3, 64, 32), q[:, :1].expand(1, 3, 64, 32))


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels' arithmetic (K3, K4, K5), emulated
# ---------------------------------------------------------------------------

MMA_KV_TILE = 64   # K3's kv tile: the online softmax rescales once per tile
# bf16 terms of p in K3, of ds in K4 (kDqTerms), of p and ds in K5
FWD_TERMS, DQ_TERMS, DKV_TERMS = 3, 2, 2
# (the fused CE head's K7 and K8 take the dlogits as 2: DLOGIT_TERMS in
# tests/test_torch_fused_ce.py)


def _terms(x, n):
    """x as n bf16 terms t0 = bf16(x), t1 = bf16(x − t0), …: how the kernels
    hand p and ds (fp32 in their registers) to the bf16 tensor cores."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).to(torch.float32))
        x = x - out[-1]
    return out


def _mma_fwd(q, k, v, valid, spec: FlashSpec):
    """K3's arithmetic: bf16 q, k, v; s = q·kᵀ with exact products and fp32
    sums; the online softmax over 64-row kv tiles in fp32; o += p·v with p
    as three bf16 terms, one product each.  Returns o in fp32 (the kernel
    rounds it to bf16) and lse."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, hkv, h // hkv, s, d).to(f32)
    m = torch.full(qg.shape[:-1], NEG_INF)
    l = torch.zeros(qg.shape[:-1])
    acc = torch.zeros(qg.shape)
    for j0 in range(0, t, MMA_KV_TILE):
        kj, vj = (x[:, :, j0:j0 + MMA_KV_TILE].to(f32) for x in (k, v))
        sij = torch.einsum("bngsd,bntd->bngst", qg, kj) * spec.scale
        ok = _chunk_mask(spec, s, j0, kj.shape[2], valid, t - s, q.device)
        if ok is not None:
            sij = torch.where(ok, sij, NEG_INF)
        m_new = torch.maximum(m, sij.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sij - m_new[..., None])
        if ok is not None:
            p = torch.where(ok, p, 0.0)
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc
        for term in _terms(p, FWD_TERMS):
            acc = acc + torch.einsum("bngst,bntd->bngsd", term, vj)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).reshape(b, h, s, d), (m + torch.log(l)).reshape(b, h, s)


def _probs_ds(q, k, v, valid, lse, di, do, spec: FlashSpec):
    """K4's and K5's p and ds in fp32 over the whole (S, T) tile, grouped
    (b, hkv, group, s, t): s = q·kᵀ and dp = do·vᵀ with exact products and
    fp32 sums, p = exp(scale·s − lse) under the mask, ds = p∘(dp − di)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg, dog = (x.reshape(b, hkv, h // hkv, s, d).to(f32) for x in (q, do))
    sij = torch.einsum("bngsd,bntd->bngst", qg, k.to(f32)) * spec.scale
    p = torch.exp(sij - lse.reshape(b, hkv, h // hkv, s)[..., None])
    ok = _chunk_mask(spec, s, 0, t, valid, t - s, q.device)
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    dp = torch.einsum("bngsd,bntd->bngst", dog, v.to(f32))
    return qg, dog, p, p * (dp - di.reshape(b, hkv, h // hkv, s)[..., None])


def _mma_dq(q, k, v, valid, lse, di, do, spec: FlashSpec, terms=DQ_TERMS):
    """K4's arithmetic: p and ds as in K5, then dq = scale·Σ ds·k with ds as
    ``terms`` bf16 terms, one product each with fp32 sums.  Returns fp32 dq
    (the kernel rounds it to bf16)."""
    ds = _probs_ds(q, k, v, valid, lse, di, do, spec)[3]
    kf = k.to(torch.float32)
    dq = sum(torch.einsum("bngst,bntd->bngsd", t, kf) for t in _terms(ds, terms))
    return (spec.scale * dq).reshape(q.shape)


def _mma_dkv(q, k, v, valid, lse, di, do, spec: FlashSpec):
    """K5's arithmetic: sᵀ = k·qᵀ and dpᵀ = v·doᵀ with exact products and
    fp32 sums, p and ds in fp32, then dv = Σ pᵀ·do and dk = scale·Σ dsᵀ·q
    with p and ds as two bf16 terms (hi + lo), summed over the GQA group and
    every q row.  Returns fp32 (dk, dv)."""
    qg, dog, p, ds = _probs_ds(q, k, v, valid, lse, di, do, spec)
    dv = sum(torch.einsum("bngst,bngsd->bntd", t, dog) for t in _terms(p, DKV_TERMS))
    dk = sum(torch.einsum("bngst,bngsd->bntd", t, qg) for t in _terms(ds, DKV_TERMS))
    return spec.scale * dk, dv


# FLASH_GRAD_CASES plus a window whose intersection with kv_valid leaves
# rows of example 0 with no key at all: (b, h, hkv, s, d, causal, masked, window)
MMA_CASES = [(*c, 0) for c in FLASH_GRAD_CASES] + [(2, 2, 2, 256, 32, True, True, 64)]


def _mma_case(b, h, hkv, s, d, causal, masked, window, out):
    """One MMA_CASES case on bf16-valued inputs (the kernels' operands): the
    JAX package's outputs in ``out`` (o, lse, dq, dk, dv), and what the
    emulation needs: q, k, v, do as bf16 tensors, the clipped lengths, the
    spec, and the (b, h, s, d) mask of live rows (do never reads a dead
    one)."""
    rng = np.random.default_rng(90)
    valid = None
    if window:
        valid = np.array([40, s], np.int32)
    elif masked:
        valid = rng.integers(s // 2, s + 1, size=(b,)).astype(np.int32)
    live = np.ones((b, s), bool)
    if window:
        live = np.arange(s)[None, :] <= valid[:, None] + window - 2
    lm = np.broadcast_to(live[:, None, :, None], (b, h, s, d)).astype(np.float32)
    arrays = [_np((b, h, s, d), 91), _np((b, hkv, s, d), 92), _np((b, hkv, s, d), 93),
              _np((b, h, s, d), 94) * lm]
    jdt = jnp.float32 if out == "float32" else jnp.bfloat16
    (jq, q), (jk, k), (jv, v), (jd, do) = (
        (jnp.asarray(a).astype(jnp.bfloat16).astype(jdt),
         torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)))
         .to(torch.bfloat16)) for a in arrays)
    jvalid = None if valid is None else jnp.asarray(valid)
    jo, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, jvalid, causal=causal, window=window,
                                                backend="xla"), jq, jk, jv)
    jdq, jdk, jdv = vjp(jd)
    _, jlse = _jax_fwd("xla", jq, jk, jv, jvalid, causal=causal, window=window)
    spec = FlashSpec(1.0 / d**0.5, causal, window, valid is not None)
    lim = None if valid is None else torch.clamp(torch.from_numpy(valid), 1, s)
    return (jo, jlse, jdq, jdk, jdv), (q, k, v, do, lim, spec, lm)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,masked,window", MMA_CASES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_flash_tensor_core_rounding_matches_jax(b, h, hkv, s, d, causal, masked, window, out):
    """The bf16 kernels' rounding against the JAX package on the same
    bf16-valued inputs.  ``float32``: JAX computes in fp32 and the emulation
    keeps fp32 o, dq, dk and dv, held to F32: p and ds as sums of bf16 terms
    keep fp32-level accuracy (a single bf16 p or ds, 8 bits, would not).
    ``bfloat16``: JAX's bf16 path against the emulation's outputs rounded to
    bf16, held to BF16.  Rows with no key give o = 0 and dq = 0 exactly."""
    (jo, jlse, jdq, jdk, jdv), (q, k, v, do, lim, spec, lm) = _mma_case(
        b, h, hkv, s, d, causal, masked, window, out)
    o, lse = _mma_fwd(q, k, v, lim, spec)
    if out == "bfloat16":
        o = o.to(torch.bfloat16)
    di = row_dot(o, do)
    dq = _mma_dq(q, k, v, lim, lse, di, do, spec)
    dk, dv = _mma_dkv(q, k, v, lim, lse, di, do, spec)
    tol = F32 if out == "float32" else BF16
    if out == "bfloat16":
        dq, dk, dv = (x.to(torch.bfloat16) for x in (dq, dk, dv))
    for x in (o, dq):   # dead rows: o = 0 and dq = 0
        assert float(np.abs(_f32(x) * (1 - lm)).max()) == 0.0
    for name, a, r in (("o", o, jo), ("lse", lse, jlse), ("dq", dq, jdq), ("dk", dk, jdk),
                       ("dv", dv, jdv)):
        _assert_close(a, r, tol, name)


def _dq_term_distances(case, terms=(1, 2, 3)):
    """For one MMA_CASES case: the emulated fp32 dq with each count of ds
    terms, as its largest distance from the JAX package's fp32 dq in units
    of the F32 bound (atol + rtol·|ref|): at most 1 passes."""
    (_, _, jdq, _, _), (q, k, v, do, lim, spec, _) = _mma_case(*case, "float32")
    o, lse = _mma_fwd(q, k, v, lim, spec)
    di, ref = row_dot(o, do), _f32(jdq)
    return {n: float((np.abs(_f32(_mma_dq(q, k, v, lim, lse, di, do, spec, terms=n)) - ref)
                      / (F32 + F32 * np.abs(ref))).max()) for n in terms}


@pytest.mark.parametrize("case", MMA_CASES)
def test_flash_one_ds_term_misses_f32_in_dq(case):
    """One bf16 term of ds (8 bits) is not enough for K4: the emulated fp32
    dq then leaves F32 of the JAX package's fp32 dq on every case, which the
    DQ_TERMS of test_flash_tensor_core_rounding_matches_jax meet (dq is the
    ill-conditioned output: ds = p∘(dp − di) cancels)."""
    dist = _dq_term_distances(case, terms=(1, DQ_TERMS))
    assert dist[1] > 1.0 and dist[DQ_TERMS] <= 1.0, dist


@pytest.mark.parametrize("seed", range(6))
def test_flash_tensor_core_o_rounds_as_the_plain_version(seed):
    """K3's o is bf16 and feeds dq through di = rowsum(o∘do) and the
    cancelling dp − di: an o that rounds to the other neighbouring bf16
    value moves the dq of rows that see few keys.  With p as three bf16
    terms the emulated o, and the dq the plain version takes from it, agree
    with the plain version's at the card's tolerance (one bf16 ulp, 1e-4 of
    the tensor's scale), on the causal MQA D 16 case where two terms did not
    on the card."""
    g = torch.Generator().manual_seed(seed)
    b, h, hkv, s, d = 2, 4, 1, 128, 16
    q, do = (torch.randn(b, h, s, d, generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=g).bfloat16() for _ in range(2))
    spec = FlashSpec(d**-0.5, True, 0, False)
    o_ref, lse = flash_attention_fwd(q, k, v, None, spec)
    o = _mma_fwd(q, k, v, None, spec)[0].to(torch.bfloat16)
    dq_ref, dq = (flash_dq(q, k, v, None, lse, row_dot(x, do), do, spec) for x in (o_ref, o))
    for a, r in ((o, o_ref), (dq, dq_ref)):
        a, r = a.float(), r.float()
        torch.testing.assert_close(a, r, rtol=1e-2, atol=1e-4 * max(1.0, float(r.abs().max())))


def test_flash_alignment_check_on_cpu_tensors():
    """The check the wrappers run before a bf16 tensor-core launch, on CPU
    tensors: the model's transposed (B, S, H, D) view passes; a bf16 view
    whose row start is 2 bytes off, or whose rows are 8 bytes off 16, raises
    (for q, k, v and do alike); fp32, which the FMA kernels take, does not.
    Each of the three passes' wrappers (K3, K4, K5) runs it before it
    reaches the library, so all three raise on such a tensor."""
    spec = FlashSpec(0.125, False, 0, False)
    b, s, h, d = 2, 64, 4, 64
    model = torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)
    _check(model, model, model, None, spec, aligned=True, do=model)
    off = torch.zeros(model.numel() + 1, dtype=torch.bfloat16)[1:].view(b, h, s, d)
    wide = torch.zeros((b, h, s, d + 4), dtype=torch.bfloat16)[..., :d]
    rows = torch.zeros((b, h, s))
    for bad in (off, wide):
        for i in range(3):
            args = [model, model, model]
            args[i] = bad
            with pytest.raises(ValueError, match="16-byte aligned"):
                _check(*args, None, spec, aligned=True)
        with pytest.raises(ValueError, match="16-byte aligned"):
            _check(model, model, model, None, spec, aligned=True, do=bad)
        _check(bad, bad, bad, None, spec)   # without aligned: any row start
        with pytest.raises(ValueError, match="16-byte aligned"):
            _fwd_cuda(bad, model, model, None, spec)
        for wrapper in (_dq_cuda, _dkv_cuda):
            with pytest.raises(ValueError, match="16-byte aligned"):
                wrapper(bad, model, model, None, rows, rows, model, spec)
            with pytest.raises(ValueError, match="16-byte aligned"):
                wrapper(model, model, model, None, rows, rows, bad, spec)
    off32 = torch.zeros(model.numel() + 1)[1:].view(b, h, s, d)
    _check(off32, off32, off32, None, spec, aligned=True)


# ---------------------------------------------------------------------------
# the attention layer and the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_layer_matches_jax(causal):
    jcfg = jax_bert.smoke().replace(causal=causal, **NO_CE)
    cfg = bert_large.smoke().replace(causal=causal, **NO_CE)
    assert jcfg.use_flash_kernel and cfg.use_flash_kernel
    b, s, d, h, dh = 3, 12, 128, 4, cfg.head_dim
    p = {"wq": _np((d, h, dh), 80) * 0.1, "wk": _np((d, h, dh), 81) * 0.1,
         "wv": _np((d, h, dh), 82) * 0.1, "wo": _np((h, dh, d), 83) * 0.1}
    x = _np((b, s, d), 84)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    valid = np.array([12, 5, 0], np.int32)  # full, ragged, fully padded
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ref, vjp = jax.vjp(lambda jp: jax_attention.attention(
        jp, jnp.asarray(x), jnp.asarray(pos), jcfg, valid_len=jnp.asarray(valid))[0], jp)
    out = attention.attention(tp, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                              valid_len=torch.from_numpy(valid))
    dy = _np((b, s, d), 85)
    jg = vjp(jnp.asarray(dy))[0]
    tg = torch.autograd.grad(out, list(tp.values()), torch.from_numpy(dy))
    _assert_close(out, ref, 1e-5)
    for k, a in zip(tp, tg):
        _assert_close(a, jg[k], 1e-5 * max(1.0, float(np.abs(jg[k]).max())), k)


def test_flash_train_steps_match_jax_fp32():
    """bert-smoke, flash on in both packages (the port's plain version, JAX's
    XLA flash), fused LAMB, fp32: the tolerances of test_torch_train.py."""
    jcfg = jax_bert.smoke().replace(activation_dtype="float32", **NO_CE)
    cfg = bert_large.smoke().replace(activation_dtype="float32", **NO_CE)
    kw = dict(optimizer="lamb", use_fused_lamb=True, accum_steps=2, precision="fp32",
              learning_rate=0.01)
    jinit, jstep = jax_make_train_step(jax_build_model(jcfg),
                                       JaxTrainConfig(fused_backend="interpret", **kw),
                                       jax_warmup_poly_decay(0.01, 10, 2))
    jstep = jax.jit(jstep)
    _, step = make_train_step(build_model(cfg), TrainConfig(**kw),
                              warmup_poly_decay(0.01, 10, 2))
    jstate = jinit(jax.random.key(0))
    state = TrainState(params_from_jax(jstate.params), state_from_jax(jstate.opt_state))
    data = jax_synthetic.batch_iterator(jcfg, 8, 32, seed=1)
    for _ in range(3):
        batch = next(data)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss/total", "loss/ce", "update_norm", "tokens/supervised"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]), atol=1e-6)
    assert float(m["update_norm"]) > 0.0
    for k, v in params_from_jax(jstate.params).items():
        diff = (state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


def test_train_step_flash_equals_dense_in_the_port():
    """Mirror of the JAX suite's test_train_step_flash_equals_dense: one
    fused-LAMB step of a small MLM model with flash on reproduces the dense
    attention's loss, gradient norm and parameters."""
    base = get_config("bert-large").replace(
        name="bert-flash-mini", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, activation_dtype="float32", **NO_CE)
    batch = {k: torch.from_numpy(v) for k, v in next(batch_iterator(base, 4, 128)).items()}
    states, metrics = [], []
    for flash in (True, False):
        init, step = make_train_step(build_model(base.replace(use_flash_kernel=flash)),
                                     TrainConfig(optimizer="lamb", use_fused_lamb=True,
                                                 grad_clip_norm=None))
        st, m = step(init(0, "cpu"), batch)
        states.append(st)
        metrics.append(m)
    assert float(metrics[0]["loss/total"]) == pytest.approx(
        float(metrics[1]["loss/total"]), rel=1e-5)
    assert float(metrics[0]["grad_norm"]) == pytest.approx(
        float(metrics[1]["grad_norm"]), rel=1e-4)
    for k in states[0].params:
        np.testing.assert_allclose(states[0].params[k].numpy(), states[1].params[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
