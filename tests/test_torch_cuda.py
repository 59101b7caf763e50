"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  No JAX here, so on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES, lamb_update, reset_launches

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
    assert LAUNCHES == {"lamb_moments": 1, "lamb_apply": 1}
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
