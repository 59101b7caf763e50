"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  No JAX here, so on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, lamb_update, reset_launches
from repro_torch.kernels.flash_attention import FlashSpec, flash_attention, \
    flash_attention_bwd, flash_attention_fwd, flash_dkv, flash_dq, row_dot

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, xdt, gdt, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device).to(xdt)
    g = torch.randn(shape, generator=gen, device=device).to(gdt)
    m = 0.1 * torch.randn(shape, generator=gen, device=device)
    v = 0.01 * torch.rand(shape, generator=gen, device=device)
    return x, g, m, v


@pytest.mark.parametrize("shape,axis", [((1000,), None), ((4, 300), 0), ((3, 4099), 0),
                                        ((2, 64, 32), 0)])
@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_lamb_kernels_match_plain_on_card(cuda, shape, axis, xdt, gdt):
    x, g, m, v = _inputs(shape, xdt, gdt, cuda)
    kw = dict(layer_axis=axis, weight_decay=0.01, phi_lo=0.1, phi_hi=10.0)
    ref = lamb_update(x.clone(), g, m.clone(), v.clone(), 3, 0.01, plain=True, **kw)
    reset_launches()
    out = lamb_update(x, g, m, v, torch.tensor(3, device=cuda), torch.tensor(0.01, device=cuda),
                      **kw)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] for k in ("lamb_moments", "lamb_apply")} == {
        "lamb_moments": 1, "lamb_apply": 1}
    torch.testing.assert_close(out.m, ref.m, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(out.v, ref.v, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(out.ratio, ref.ratio, rtol=1e-5, atol=0)
    # fp32: an ulp of x plus the ratio's reordered-sum share of the update;
    # bf16: at most one bf16 ulp
    tol = dict(rtol=8e-3, atol=0) if xdt == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out.x.float(), ref.x.float(), **tol)


def test_lamb_kernels_reject_what_they_cannot_take(cuda):
    x, g, m, v = _inputs((4, 8), torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lamb_update(x.t(), g.t(), m.t(), v.t(), 1, 0.1)
    with pytest.raises(TypeError):
        lamb_update(x.half(), g, m, v, 1, 0.1)
    with pytest.raises(ValueError, match="ok"):
        lamb_update(x, g, m, v, 1, 0.1, ok=torch.tensor(1, device=cuda))   # int64


@pytest.mark.parametrize("shape,axis", [((1000,), None), ((3, 4099), 0)])
@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_lamb_kernels_ok_flag_on_card(cuda, shape, axis, xdt, gdt):
    """K1/K2 with ``ok`` 0 store nothing (x, m, v bit-identical, Σ(x'−x)² 0),
    as the plain version does; with ``ok`` 1 they give the bits of the call
    without a flag.  Both launch once either way."""
    x, g, m, v = _inputs(shape, xdt, gdt, cuda, seed=1)
    kw = dict(layer_axis=axis, weight_decay=0.01)
    step, lr = torch.tensor(3, device=cuda), torch.tensor(0.01, device=cuda)
    for flag in (0, 1):
        ok = torch.tensor(flag, dtype=torch.int32, device=cuda)
        ins = [t.clone() for t in (x, m, v)]
        reset_launches()
        out = lamb_update(ins[0], g, ins[1], ins[2], step, lr, ok=ok, **kw)
        torch.cuda.synchronize()
        assert (LAUNCHES["lamb_moments"], LAUNCHES["lamb_apply"]) == (1, 1)
        plain = [t.clone() for t in (x, m, v)]
        ref = lamb_update(plain[0], g, plain[1], plain[2], step, lr, ok=ok, plain=True, **kw)
        if flag == 0:
            for a, b in zip((out.x, out.m, out.v), (x, m, v)):
                assert torch.equal(a, b)
            assert float(out.delta_sq) == 0.0 == float(ref.delta_sq)
            for a, b in zip((ref.x, ref.m, ref.v), (x, m, v)):
                assert torch.equal(a, b)
        else:
            bare = [t.clone() for t in (x, m, v)]
            want = lamb_update(bare[0], g, bare[1], bare[2], step, lr, **kw)
            for a, b in zip((out.x, out.m, out.v, out.delta_sq), (want.x, want.m, want.v,
                                                                   want.delta_sq)):
                assert torch.equal(a, b)


# (b, h, hkv, s, t, d, causal, window, masked): the mask, GQA, cross-length,
# ragged-tail and head-dim cases of the JAX suite's flash tests
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, False, 0, False),    # BERT: bidirectional, no mask
    (1, 2, 2, 256, 256, 32, True, 0, False),
    (1, 2, 2, 128, 384, 64, False, 0, False),    # cross-length
    (1, 2, 2, 128, 384, 64, True, 0, False),     # cross-length causal: T - S offset
    (2, 2, 2, 384, 384, 128, True, 0, False),
    (2, 8, 2, 200, 200, 32, False, 0, True),     # GQA, ragged tail, kv_valid
    (2, 4, 1, 128, 128, 16, True, 0, False),     # MQA
    (2, 2, 2, 256, 256, 32, True, 64, True),     # window ∩ valid: rows masked entirely
    (2, 4, 4, 200, 200, 16, False, 0, False),    # D 16, ragged S = T
    (1, 4, 2, 77, 77, 32, True, 0, True),        # D 32, ragged, GQA, causal, kv_valid
    (2, 2, 2, 300, 300, 64, False, 0, True),     # ragged S = T at the main path's D
]


def _flash_inputs(b, h, hkv, s, t, d, masked, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, h, s, d), generator=gen, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, t, d), generator=gen, device=device).to(dtype)
            for _ in range(2))
    valid = None
    if masked:
        valid = torch.randint(t // 4, t + 1, (b,), generator=gen, device=device,
                              dtype=torch.int32)
        valid[0] = 40
    return q, k, v, do, valid


def _close(a, b, dtype):
    """fp32: the kernel's FMA order against cuBLAS's, 1e-4 of the tensor's
    scale; bf16: the same before the cast, so at most one bf16 ulp (2^-7
    relative) after it."""
    a, b = a.detach().float(), b.detach().float()
    scale = max(1.0, float(b.abs().max()))
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(a, b, rtol=rtol, atol=1e-4 * scale)


@pytest.mark.parametrize("b,h,hkv,s,t,d,causal,window,masked", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_on_card(cuda, b, h, hkv, s, t, d, causal, window,
                                           masked, dtype):
    """K3, then K4 and K5 through the autograd boundary, each against the
    plain version on the same inputs: the forward on q, k, v, the backward
    on the kernel forward's residuals (o, lse) and do.  A bf16 o that rounds
    to the other neighbouring value moves di = rowsum(o∘do), and through the
    cancelling dp − di the dq of its row by more than an ulp, so the plain
    backward is given the kernel's o, not its own."""
    q, k, v, do, valid = _flash_inputs(b, h, hkv, s, t, d, masked, dtype, cuda)
    kw = dict(causal=causal, window=window)
    outs = {}
    for plain in (True, False):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        reset_launches()
        o = flash_attention(*qkv, valid, plain=plain, **kw)
        grads = torch.autograd.grad(o, qkv, do)
        torch.cuda.synchronize()
        launched = {n: LAUNCHES[n] for n in ("flash_fwd", "flash_dq", "flash_dkv")}
        assert set(launched.values()) == {0 if plain else 1}, launched
        if not plain:   # bf16 K3–K5 on the tensor cores; fp32 on FMA
            mma = {n: VARIANT_LAUNCHES[n]["mma"] for n in launched}
            bf16 = int(dtype == torch.bfloat16)
            assert mma == dict.fromkeys(launched, bf16), mma
        assert [g.dtype for g in grads] == [dtype] * 3
        outs[plain] = (o, *grads)
    lim = None if valid is None else valid.clamp(1, t)
    spec = FlashSpec(d**-0.5, causal, window, valid is not None)
    (o, lse), (o_ref, lse_ref) = (flash_attention_fwd(q, k, v, lim, spec, plain=p)
                                  for p in (False, True))
    assert torch.equal(o, outs[False][0])
    refs = (o_ref, *flash_attention_bwd(q, k, v, lim, o, lse, do, spec, plain=True))
    for name, a, ref in zip(("o", "dq", "dk", "dv"), outs[False], refs):
        assert torch.isfinite(a).all(), name
        _close(a, ref, dtype)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_model_layout_through_strides(cuda, dtype):
    """(B, S, H, D) tensors go in as transposed views and come back in the
    same layout: no copies, the same numbers as from contiguous inputs."""
    q, k, v, do, _ = _flash_inputs(2, 4, 2, 96, 96, 64, False, dtype, cuda)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
             for x in (q, k, v)]
    o = flash_attention(*views, causal=True)
    assert o.transpose(1, 2).is_contiguous()
    grads = torch.autograd.grad(o, views, do)
    assert all(g.transpose(1, 2).is_contiguous() for g in grads)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = flash_attention(*qkv, causal=True)
    for a, r in zip((o, *grads), (ref, *torch.autograd.grad(ref, qkv, do))):
        torch.testing.assert_close(a, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,d", [(False, 64), (True, 128), (False, 16)])
def test_flash_dq_is_deterministic(cuda, dtype, causal, d):
    """K4 owns its dq tile and sums its kv tiles in a fixed order (no
    atomics): two runs give the same bits."""
    q, k, v, do, valid = _flash_inputs(2, 8, 2, 320, 320, d, True, dtype, cuda, seed=4)
    spec = FlashSpec(d**-0.5, causal, 0, True)
    lim = valid.clamp(1, 320)
    o, lse = flash_attention_fwd(q, k, v, lim, spec)
    di = row_dot(o, do)
    reset_launches()
    runs = [flash_dq(q, k, v, lim, lse, di, do, spec) for _ in range(2)]
    torch.cuda.synchronize()
    assert VARIANT_LAUNCHES["flash_dq"]["mma" if dtype == torch.bfloat16 else "fma"] == 2
    assert torch.equal(*runs)
    _close(runs[0], flash_dq(q, k, v, lim, lse, di, do, spec, plain=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dkv_is_deterministic(cuda, dtype):
    """K5 owns its dk/dv tile and sums GQA heads and q tiles in a fixed
    order: two runs give the same bits."""
    q, k, v, do, valid = _flash_inputs(2, 8, 2, 320, 320, 64, True, dtype, cuda, seed=3)
    spec = FlashSpec(0.125, False, 0, True)
    lim = valid.clamp(1, 320)
    o, lse = flash_attention_fwd(q, k, v, lim, spec)
    di = row_dot(o, do)
    runs = [flash_dkv(q, k, v, lim, lse, di, do, spec) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_flash_wrapper_rejects_what_it_cannot_take(cuda):
    q, k, v, _, _ = _flash_inputs(1, 2, 2, 64, 64, 64, False, torch.float32, cuda)
    valid = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    spec = FlashSpec(0.125, False, 0, False)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :48], k[..., :48], v[..., :48], valid, spec)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half(), valid, spec)
    with pytest.raises(TypeError, match="differs"):
        flash_attention_fwd(q, k.bfloat16(), v, valid, spec)
    with pytest.raises(ValueError, match="last dim"):
        flash_attention_fwd(q.transpose(2, 3), k, v, valid, spec)
    with pytest.raises(ValueError, match="valid"):
        flash_attention_fwd(q, k, v, valid.cpu(), spec)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_fwd(torch.cat([q, q[:, :1]], 1), k, v, valid, spec)
    # bf16 rows the tensor-core kernels cannot copy in 16-byte pieces: a base
    # pointer 2 bytes off, and rows 4 elements (8 bytes) apart from 16 B
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    off = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(off, kb, vb, valid, spec)
    wide = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(qb, wide, vb, valid, spec)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        flash_dkv(qb, kb, vb, valid, lse, lse, off, spec)
    with pytest.raises(ValueError, match="16-byte"):
        flash_dq(qb, kb, vb, valid, lse, lse, off, spec)
    with pytest.raises(ValueError, match="16-byte"):
        flash_dq(off, kb, vb, valid, lse, lse, qb, spec)


# ---------------------------------------------------------------------------
# fused CE head (K6–K8)
# ---------------------------------------------------------------------------

# (n, d, v, dtype): the main path's shape (32 x 20 gathered rows of BERT-large),
# ragged rows and vocab, a D that is not a multiple of the kernels' chunks
CE_CASES = [
    (640, 1024, 30522, torch.bfloat16),
    (97, 64, 300, torch.float32),
    (33, 128, 1000, torch.bfloat16),
    (256, 1024, 4099, torch.float32),
    (50, 48, 777, torch.float32),
]


def _ce_inputs(n, d, v, dtype, device, seed=0):
    """Rows of h with std 1, w with std 0.05; a quarter of the rows all zero
    (every logit 0: the argmax is column 0), labels at 0, V - 1 and random,
    and a cotangent that is 0 on a third of the rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((n, d), generator=gen, device=device)
    h[: n // 4] = 0.0
    w = 0.05 * torch.randn((v, d), generator=gen, device=device)
    lbl = torch.randint(0, v, (n,), generator=gen, device=device, dtype=torch.int32)
    lbl[0], lbl[1], lbl[-1] = 0, v - 1, 0
    g = torch.rand((n,), generator=gen, device=device)
    g[torch.arange(n, device=device) % 3 == 1] = 0.0
    return h.to(dtype), w.to(dtype), lbl, g


def _ce_close(a, ref, dtype):
    """fp32: the kernels' FMA order against cuBLAS's, 1e-4 relative plus 1e-5
    of the tensor's scale; bf16 gradients round those fp32 values, so one
    bf16 ulp (2^-7 relative) apart at most, plus the same absolute term."""
    a, ref = a.detach().float(), ref.detach().float()
    scale = max(float(ref.abs().max()), 1e-30)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(a, ref, rtol=rtol, atol=(1e-4 if dtype == torch.bfloat16
                                                        else 1e-5) * scale)


@pytest.mark.parametrize("n,d,v,dtype", CE_CASES)
def test_fused_ce_kernels_match_plain_on_card(cuda, n, d, v, dtype):
    from repro_torch.kernels.fused_ce import fused_ce, fused_ce_fwd

    h, w, lbl, g = _ce_inputs(n, d, v, dtype, cuda)
    outs = {}
    for plain in (True, False):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        reset_launches()
        nll, correct = fused_ce(hh, ww, lbl, plain=plain)
        dh, dw = torch.autograd.grad(nll, (hh, ww), g)
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] for k in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")}
        assert set(launched.values()) == {0 if plain else 1}, launched
        assert dh.dtype == dw.dtype == dtype
        outs[plain] = (nll, correct, dh, dw)
    nll, correct, dh, dw = outs[False]
    nll_r, correct_r, dh_r, dw_r = outs[True]
    torch.testing.assert_close(nll, nll_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(correct, correct_r, rtol=0, atol=0)
    _ce_close(dh, dh_r, dtype)
    _ce_close(dw, dw_r, dtype)
    # zero rows: every logit is 0, so the argmax is column 0 and nll = log V
    zero = slice(0, n // 4)
    assert torch.equal(correct[zero], (lbl[zero] == 0).float())
    torch.testing.assert_close(nll[zero], torch.full_like(nll[zero], math.log(v)),
                               rtol=1e-6, atol=1e-5)
    # rows with a zero cotangent get exactly zero dh
    assert float(dh[g == 0].abs().max()) == 0.0
    (_, _, lse), (_, _, lse_r) = (fused_ce_fwd(h, w, lbl, plain=p) for p in (False, True))
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-5)


def test_fused_ce_kernels_are_deterministic(cuda):
    from repro_torch.kernels.fused_ce import fused_ce

    h, w, lbl, g = _ce_inputs(300, 256, 5000, torch.float32, cuda, seed=1)
    runs = []
    for _ in range(2):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        nll, correct = fused_ce(hh, ww, lbl)
        runs.append((nll, correct, *torch.autograd.grad(nll, (hh, ww), g)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_fused_ce_wrappers_reject_what_they_cannot_take(cuda):
    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_fwd

    h, w, lbl, g = _ce_inputs(16, 64, 100, torch.float32, cuda)
    lse = fused_ce_fwd(h, w, lbl)[2]
    with pytest.raises(ValueError, match="at most"):
        fused_ce_fwd(torch.zeros((4, 1040), device=cuda), torch.zeros((8, 1040), device=cuda),
                     lbl[:4])
    with pytest.raises(TypeError, match="differs"):
        fused_ce_fwd(h, w.bfloat16(), lbl)
    with pytest.raises(TypeError):
        fused_ce_fwd(h.half(), w.half(), lbl)
    with pytest.raises(ValueError, match="contiguous rows"):
        fused_ce_fwd(h.t().contiguous().t(), w, lbl)
    with pytest.raises(ValueError, match="labels"):
        fused_ce_fwd(h, w, lbl.long())
    with pytest.raises(ValueError, match="g must"):
        fused_ce_dh(h, w, lbl, lse, g.cpu())


# (n, d, v): bf16 K7 and K8 on the tensor cores: the main path's shape,
# ragged rows, vocab and D (D a multiple of 8, so that the rows can be copied
# in 16-byte pieces), one vocab tile, and two rows
CE_MMA_CASES = [
    (640, 1024, 30522),
    (333, 1000, 5003),
    (97, 80, 300),
    (33, 1024, 65),
    (2, 8, 3),
]


@pytest.mark.parametrize("n,d,v", CE_MMA_CASES)
def test_fused_ce_tensor_core_forward_on_card(cuda, n, d, v):
    """bf16 K6 launches the tensor-core design and agrees with the plain
    version on the same inputs: nll and lse to 1e-5 (bf16 x bf16 products
    are exact in fp32; the sums run in another order), ``correct`` equal
    except where the label's logit ties the maximum within that rounding,
    zero rows (all logits 0) on column 0; two runs give equal bits."""
    from repro_torch.kernels.fused_ce import fused_ce_fwd

    h, w, lbl, _ = _ce_inputs(n, d, v, torch.bfloat16, cuda, seed=5)
    logits = h.float() @ w.float().t()
    lbl = torch.where(torch.arange(n, device=cuda) % 2 == 0, logits.argmax(1).to(torch.int32),
                      lbl)
    reset_launches()
    runs = [fused_ce_fwd(h, w, lbl) for _ in range(2)]
    torch.cuda.synchronize()
    assert VARIANT_LAUNCHES["fused_ce_fwd"] == {"mma": 2, "fma": 0}, VARIANT_LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    nll, correct, lse = runs[0]
    nll_r, correct_r, lse_r = fused_ce_fwd(h, w, lbl, plain=True)
    torch.testing.assert_close(nll, nll_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-5)
    flips = correct != correct_r
    top = logits.amax(1)
    gap = (top - logits.gather(1, lbl.long()[:, None])[:, 0]).abs()
    assert bool((gap[flips] <= 1e-5 * (1 + top[flips].abs())).all())
    zero = slice(0, n // 4)
    assert torch.equal(correct[zero], (lbl[zero] == 0).float())


@pytest.mark.parametrize("n,d,v", CE_MMA_CASES)
def test_fused_ce_tensor_core_backward_on_card(cuda, n, d, v):
    """bf16 K7 and K8 launch the tensor-core design, agree with the plain
    version on the same inputs (one bf16 ulp plus 1e-4 of the scale, as
    _ce_close states), give exactly zero dh on rows with a zero cotangent,
    and give equal bits when run twice."""
    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd

    h, w, lbl, g = _ce_inputs(n, d, v, torch.bfloat16, cuda, seed=2)
    lse = fused_ce_fwd(h, w, lbl, plain=True)[2]
    reset_launches()
    runs = [(fused_ce_dh(h, w, lbl, lse, g), fused_ce_dw(h, w, lbl, lse, g)) for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("fused_ce_dh", "fused_ce_dw"):
        assert VARIANT_LAUNCHES[name] == {"mma": 2, "fma": 0}, VARIANT_LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dh, dw = runs[0]
    assert dh.dtype == dw.dtype == torch.bfloat16
    _ce_close(dh, fused_ce_dh(h, w, lbl, lse, g, plain=True), torch.bfloat16)
    _ce_close(dw, fused_ce_dw(h, w, lbl, lse, g, plain=True), torch.bfloat16)
    if bool((g == 0).any()):
        assert float(dh[g == 0].abs().max()) == 0.0


def test_fused_ce_unstageable_bf16_takes_the_fma_design(cuda):
    """bf16 rows that cannot be copied in 16-byte pieces (h starting 2 bytes
    past a 16-byte boundary) run the FMA kernels, K6 as K7 and K8, are
    counted so, and agree with the plain version."""
    from repro_torch.kernels.fused_ce import fused_ce_dh, fused_ce_dw, fused_ce_fwd

    h, w, lbl, g = _ce_inputs(97, 1024, 300, torch.bfloat16, cuda, seed=3)
    off = torch.cat([h.new_zeros(1), h.reshape(-1)])[1:].view(h.shape)
    assert off.data_ptr() % 16 != 0
    nll_r, _, lse = fused_ce_fwd(h, w, lbl, plain=True)
    reset_launches()
    nll, _, lse_k = fused_ce_fwd(off, w, lbl)
    dh, dw = fused_ce_dh(off, w, lbl, lse, g), fused_ce_dw(off, w, lbl, lse, g)
    torch.cuda.synchronize()
    for name in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
        assert VARIANT_LAUNCHES[name] == {"mma": 0, "fma": 1}, VARIANT_LAUNCHES
    torch.testing.assert_close(nll, nll_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse_k, lse, rtol=1e-5, atol=1e-5)
    _ce_close(dh, fused_ce_dh(h, w, lbl, lse, g, plain=True), torch.bfloat16)
    _ce_close(dw, fused_ce_dw(h, w, lbl, lse, g, plain=True), torch.bfloat16)
