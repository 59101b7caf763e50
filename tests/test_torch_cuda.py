"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  No JAX here, so on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES, lamb_update, reset_launches
from repro_torch.kernels.flash_attention import FlashSpec, flash_attention, flash_attention_fwd

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
        assert [g.dtype for g in grads] == [dtype] * 3
        outs[plain] = (o, *grads)
    for name, a, ref in zip(("o", "dq", "dk", "dv"), outs[False], outs[True]):
        assert torch.isfinite(a).all(), name
        _close(a, ref, dtype)
    lim = None if valid is None else valid.clamp(1, t)
    spec = FlashSpec(d**-0.5, causal, window, valid is not None)
    (_, lse), (_, lse_ref) = (flash_attention_fwd(q, k, v, lim, spec, plain=p)
                              for p in (False, True))
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)


def test_flash_reads_model_layout_through_strides(cuda):
    """(B, S, H, D) tensors go in as transposed views and come back in the
    same layout: no copies, the same numbers as from contiguous inputs."""
    q, k, v, do, _ = _flash_inputs(2, 4, 2, 96, 96, 64, False, torch.float32, cuda)
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
