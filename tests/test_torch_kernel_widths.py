"""Flash attention at any head dim (past 256 too) and the fused CE head at
any D, on the CPU: the pad-and-slice step that runs a head dim outside the kernels' own
through the plain version against the unpadded plain version (and the JAX
package), and the fused CE check at D past 1024.  The kernels themselves
are held to these on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, WIDE, FlashAttention, FlashSpec, \
    _check, kernel_head_dim, padded_flash_attention
from repro_torch.kernels.fused_ce import _check as ce_check
from repro_torch.kernels.fused_ce import fused_ce


def test_kernel_head_dims():
    """Up to 256 the kernels' own head dims; past 256 the wide kernels' next
    multiple of 128 (no head dim raises: the reference takes any)."""
    assert HEAD_DIMS == (16, 32, 64, 128, 256) and WIDE == 128
    assert [kernel_head_dim(d) for d in (8, 16, 40, 64, 80, 100, 128, 200, 256)] == [
        16, 16, 64, 64, 128, 128, 128, 256, 256]
    assert [kernel_head_dim(d) for d in (257, 320, 384, 512, 576, 640, 1000)] == [
        384, 384, 384, 512, 640, 640, 1024]


@pytest.mark.parametrize("d,padded", [(320, 384), (512, 512), (576, 640)])
def test_wide_head_dims_pass_the_kernels_check(d, padded):
    """The kernels' check takes a wide head dim that is a multiple of 128 and
    refuses the unpadded one, so flash_attention pads 320 and 576 on the card
    and hands 512 over as it is."""
    assert kernel_head_dim(d) == padded
    spec = FlashSpec(d**-0.5, True, 0, False)
    q = torch.zeros((1, 2, 8, padded))
    _check(q, q, q, None, spec)
    if padded != d:
        with pytest.raises(ValueError, match="multiple of 128"):
            _check(q[..., :d], q[..., :d], q[..., :d], None, spec)


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d))]


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("causal,hkv,valid", [(True, 2, None), (False, 4, [20, 7]),
                                             (True, 1, [33, 1])])
def test_padded_flash_matches_unpadded_plain(d, causal, hkv, valid):
    """o, lse, dq, dk and dv of the plain version run through the pad-and-
    slice step (q, k, v zero-padded to the kernels' next head dim, the scale
    of the real one) equal the unpadded plain version's: zero columns add
    exact zeros to q·k and to o's padded columns, so only the order of the
    fp32 sums of O(1) values over the padded width may differ (1e-5)."""
    b, h, s = 2, 4, 33
    q, k, v, do = _qkv(b, h, hkv, s, d, seed=d)
    lim = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    spec = FlashSpec(d**-0.5, causal, 0, lim is not None)
    outs = []
    for run in (padded_flash_attention, FlashAttention.apply):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = run(*qkv, lim, spec, True)
        outs.append([o, lse, *torch.autograd.grad(o, qkv, do)])
    for name, a, r in zip(("o", "lse", "dq", "dk", "dv"), *outs):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.detach().numpy(), r.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # and the JAX package's flash attention, which takes any head dim
    ref = jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                    None if lim is None else jnp.asarray(lim.numpy()), causal=causal,
                    backend="xla")
    np.testing.assert_allclose(outs[0][0].detach().numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,valid", [(True, None), (False, [20, 7])])
def test_padded_flash_at_d_320_matches_jax_reference(causal, valid):
    """Head dim 320, past 256: the pad-and-slice step (to the wide kernels'
    384) through the plain version, forward and backward, against the
    unpadded plain version (1e-5, as above) and against the JAX package's
    dense oracle ``repro.kernels.ref.flash_attention_ref`` and its
    ``jax.vjp`` (3e-5: the oracle's softmax over the whole row against the
    online one in fp32, tests/test_kernels.py's bound for the flash
    kernels against that oracle)."""
    import jax

    b, h, s, d = 2, 3, 33, 320
    q, k, v, do = _qkv(b, h, h, s, d, seed=7)
    lim = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    spec = FlashSpec(d**-0.5, causal, 0, lim is not None)
    outs = []
    for run in (padded_flash_attention, FlashAttention.apply):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        o, _ = run(*qkv, lim, spec, True)
        outs.append([o, *torch.autograd.grad(o, qkv, do)])
    for name, a, r in zip(("o", "dq", "dk", "dv"), *outs):
        np.testing.assert_allclose(a.detach().numpy(), r.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jlim = None if lim is None else jnp.asarray(lim.numpy())

    def ref(q_, k_, v_):
        return flash_attention_ref(q_, k_, v_, jlim, causal=causal)

    o_ref, vjp = jax.vjp(ref, jq, jk, jv)
    for name, a, r in zip(("o", "dq", "dk", "dv"), outs[0], (o_ref, *vjp(jdo))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), rtol=3e-5, atol=3e-5,
                                   err_msg=name)


def test_padding_passes_a_kernel_head_dim_through():
    q, k, v, _ = _qkv(1, 2, 2, 16, 64, seed=1)
    spec = FlashSpec(0.125, True, 0, False)
    a = padded_flash_attention(q, k, v, None, spec, True)
    b = FlashAttention.apply(q, k, v, None, spec, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d,dtype,design", [(1280, torch.bfloat16, "mma"),
                                            (2048, torch.bfloat16, "mma"),
                                            (2048, torch.float32, "fma"),
                                            (4104, torch.bfloat16, "mma")])
def test_fused_ce_check_takes_any_d(d, dtype, design):
    """The kernels' check has no D limit: D 1280 and 2048 (hubert-xlarge,
    paligemma-3b) and past them pick their design as at D 1024."""
    h, w = torch.zeros((4, d), dtype=dtype), torch.zeros((9, d), dtype=dtype)
    assert ce_check(h, w, torch.zeros(4, dtype=torch.int32)) == design
    with pytest.raises(ValueError, match="out of range"):
        ce_check(h[:, :0], w[:, :0], torch.zeros(4, dtype=torch.int32))


def test_fused_ce_plain_at_d_2048():
    """The plain version at D 2048 (the reference the kernels are held to
    there) against the dense log-softmax."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((6, 2048)).astype(np.float32))
    w = torch.from_numpy(0.05 * rng.standard_normal((300, 2048)).astype(np.float32))
    lbl = torch.from_numpy(rng.integers(0, 300, 6).astype(np.int32))
    nll, correct = fused_ce(h, w, lbl)
    logits = h @ w.t()
    ref = -torch.log_softmax(logits, -1).gather(1, lbl.long()[:, None])[:, 0]
    np.testing.assert_allclose(nll.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(correct, (logits.argmax(1) == lbl).float())
