"""The port's fused CE head (K6–K8, the plain version on the CPU) against the
JAX package's on the same numpy inputs: (nll, correct) and gradients against
``repro.kernels.fused_ce`` (Pallas in interpret mode and the XLA backend) and
the dense oracle ``fused_ce_ref``, the gather, the fused loss against the
dense one, overflow, the bert-smoke model's fused head, and bert-smoke train
steps with the fused head on.  Tolerances are the JAX suite's
(``tests/test_fused_ce.py``): 1e-5 on fp32 outputs, 1e-4 relative / 1e-5
absolute on fp32 gradients, 2e-2 on bf16 ones."""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import make_batch
from repro.data import synthetic as jax_synthetic
from repro.kernels import fused_ce as jax_fused_ce
from repro.kernels.ref import fused_ce_ref
from repro.models import build_model as jax_build_model
from repro.train import loss as jax_loss
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES, fused_ce, reset_launches
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.nn import flatten, params_from_jax, state_from_jax
from repro_torch.train import TrainState, make_loss_fn, make_train_step
from repro_torch.train import loss
from repro_torch.train.step import _microbatch_grads

# the module (the package's ``fused_ce`` attribute is the function)
fused_ce_module = importlib.import_module("repro_torch.kernels.fused_ce")
F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_GRAD = dict(rtol=2e-2, atol=2e-2)
BACKENDS = ["interpret", "xla"]
CE_KERNELS = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return j, t


def _inputs(n, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    lbl = rng.integers(0, v, n).astype(np.int32)
    # per-row cotangent weights, zero on about a third of the rows (ignored)
    wts = ((rng.random(n) > 0.3) * rng.random(n)).astype(np.float32)
    return h, w, lbl, wts


def _jax_ce(backend, h, w, lbl):
    kw = dict(interpret=True) if backend == "interpret" else dict(backend="xla")
    return jax_fused_ce(h, w, lbl, block_n=16, block_v=64, **kw)


def _both(backend, h, w, lbl, wts, dtype):
    """(nll, correct, dh, dw) of the JAX package and of the port under the
    cotangent ``wts`` on nll."""
    (jh, th), (jw, tw) = _pair(h, dtype), _pair(w, dtype)
    jl = jnp.asarray(lbl)

    def jloss(h, w):
        return jnp.sum(_jax_ce(backend, h, w, jl)[0] * wts)

    jnll, jcorrect = _jax_ce(backend, jh, jw, jl)
    jdh, jdw = jax.grad(jloss, (0, 1))(jh, jw)
    th.requires_grad_()
    tw.requires_grad_()
    nll, correct = fused_ce(th, tw, torch.from_numpy(lbl))
    dh, dw = torch.autograd.grad(nll, (th, tw), torch.from_numpy(wts))
    return (nll, correct, dh, dw), (jnll, jcorrect, jdh, jdw)


# ---------------------------------------------------------------------------
# the kernel module against the JAX kernels and the dense oracle
# ---------------------------------------------------------------------------

# tests/test_fused_ce.py CE_SHAPES: ragged rows and vocab, rows < one block
# with one vocab chunk, several row blocks
CE_SHAPES = [(48, 32, 300), (17, 16, 64), (256, 64, 1000)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n,d,v", CE_SHAPES)
def test_fused_ce_matches_jax(n, d, v, dtype, backend):
    """(nll, correct) and both gradients.  The port's vocab chunk (512) is not
    the JAX test's (64): the online statistics do not depend on it.  bf16
    rows and weights: every product is exact in fp32, so nll keeps the fp32
    tolerance; the bf16 gradients round it, so 2e-2."""
    h, w, lbl, wts = _inputs(n, d, v, seed=n + v)
    port, ref = _both(backend, h, w, lbl, wts, dtype)
    nll, correct, dh, dw = port
    assert nll.dtype == correct.dtype == torch.float32
    assert dh.dtype == dw.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    np.testing.assert_allclose(_f32(nll), _f32(ref[0]), **F32)
    np.testing.assert_array_equal(_f32(correct), _f32(ref[1]))
    tol = BF16_GRAD if dtype == jnp.bfloat16 else F32_GRAD
    np.testing.assert_allclose(_f32(dh), _f32(ref[2]), **tol)
    np.testing.assert_allclose(_f32(dw), _f32(ref[3]), **tol)
    # and the dense oracle on the same (possibly bf16-rounded) values
    jh, jw = (_pair(a, dtype)[0] for a in (h, w))
    nll_r, correct_r = fused_ce_ref(jh, jw, jnp.asarray(lbl))
    np.testing.assert_allclose(_f32(nll), _f32(nll_r), **F32)
    np.testing.assert_array_equal(_f32(correct), _f32(correct_r))


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_ce_ties_and_edge_labels_match_jax(backend):
    """Rows of zeros give every logit 0: the argmax is column 0 (the first
    maximum, across the port's and the JAX package's chunks alike), so only
    label 0 counts as correct; labels 0 and V − 1 sit on the chunk edges."""
    n, d, v = 40, 32, 700
    h, w, lbl, wts = _inputs(n, d, v, seed=5)
    h[:12] = 0.0
    lbl[0:3] = 0
    lbl[3:6] = v - 1
    lbl[12:14] = 0
    lbl[14:16] = v - 1
    # rows 16..: make the label the argmax half the time
    logits = h @ w.T
    lbl[16::2] = logits[16::2].argmax(1)
    port, ref = _both(backend, h, w, lbl, wts, jnp.float32)
    nll, correct = port[0], port[1]
    np.testing.assert_array_equal(_f32(correct[:12]), (lbl[:12] == 0).astype(np.float32))
    np.testing.assert_allclose(_f32(nll[:12]), np.full(12, np.log(v)), rtol=1e-6)
    assert _f32(correct[16::2]).all()
    np.testing.assert_allclose(_f32(nll), _f32(ref[0]), **F32)
    np.testing.assert_array_equal(_f32(correct), _f32(ref[1]))
    for a, r in zip(port[2:], ref[2:]):
        np.testing.assert_allclose(_f32(a), _f32(r), **F32_GRAD)


def test_fused_ce_labels_clip_and_shape_guards():
    h, w, lbl, _ = _inputs(8, 16, 32, seed=9)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    with pytest.raises(ValueError, match="feature dim"):
        fused_ce(th, torch.zeros((32, 8)), torch.from_numpy(lbl))
    with pytest.raises(ValueError, match="labels shape"):
        fused_ce(th, tw, torch.from_numpy(lbl[:4]))
    # out-of-range labels clip into [0, V), as the JAX entry clips them
    wild = np.array([-1, -7, 31, 40, 0, 5, 99, 2], np.int32)
    out = fused_ce(th, tw, torch.from_numpy(wild))
    ref = jax_fused_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(wild), backend="xla")
    for a, r in zip(out, ref):
        np.testing.assert_allclose(_f32(a), _f32(r), **F32)


def test_fused_ce_mixed_dtypes_take_the_wider_type():
    """bf16 rows against fp32 weights: the same numbers as both in fp32
    (products are fp32 either way), dh back in bf16 and dw in fp32."""
    h, w, lbl, wts = _inputs(24, 32, 200, seed=11)
    hb = torch.from_numpy(h).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    nll, _ = fused_ce(hb, tw, torch.from_numpy(lbl))
    dh, dw = torch.autograd.grad(nll, (hb, tw), torch.from_numpy(wts))
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    jnll, vjp = jax.vjp(lambda h, w: jax_fused_ce(h, w, jnp.asarray(lbl), backend="xla")[0],
                        jh, jnp.asarray(w))
    jdh, jdw = vjp(jnp.asarray(wts))
    np.testing.assert_allclose(_f32(nll), _f32(jnll), **F32)
    np.testing.assert_allclose(_f32(dh), _f32(jdh), **BF16_GRAD)
    np.testing.assert_allclose(_f32(dw), _f32(jdw), **F32_GRAD)


def test_fused_ce_runs_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version and launches no kernel; a zero
    cotangent gives exactly zero gradients."""
    h, w, lbl, _ = _inputs(20, 16, 100, seed=12)
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    reset_launches()
    nll, correct = fused_ce(th, tw, torch.from_numpy(lbl))
    assert not correct.requires_grad
    (nll * 0.0).sum().backward()
    assert all(LAUNCHES[k] == 0 for k in CE_KERNELS)
    assert float(th.grad.abs().max()) == 0.0 and float(tw.grad.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels' arithmetic (K7, K8), emulated
# ---------------------------------------------------------------------------

DLOGIT_TERMS = 2   # bf16 terms of the fp32 dlogits in K7's and K8's second product


def _terms(x, n):
    """x as n bf16 terms t0 = bf16(x), t1 = bf16(x − t0), …: how the kernels
    hand the dlogits (fp32 in their registers) to the bf16 tensor cores."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).to(torch.float32))
        x = x - out[-1]
    return out


def _mma_grads(h, w, lbl, lse, g, terms):
    """K7's and K8's arithmetic on bf16 h and w: s = h·wᵀ with exact products
    and fp32 sums, dlogits = (exp(s − lse) − onehot)·g in fp32, then
    dh = Σ t·w and dw = Σ tᵀ·h over the dlogits' bf16 terms t, one product
    per term with fp32 sums.  Returns fp32 (dh, dw), before the kernels'
    final rounding to bf16."""
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    onehot = torch.nn.functional.one_hot(lbl.long(), w.shape[0]).to(torch.float32)
    dlog = (torch.exp(hf @ wf.t() - lse[:, None]) - onehot) * g[:, None]
    parts = _terms(dlog, terms)
    return sum(t @ wf for t in parts), sum(t.t() @ hf for t in parts)


def _mma_case(n, d, v, seed, terms):
    """(emulated dh, dw; the JAX package's fp32 dh, dw; g) on bf16-valued
    inputs with labels at 0 and V − 1 and zero cotangents on some rows."""
    h, w, lbl, wts = _inputs(n, d, v, seed=seed)
    lbl[0], lbl[1], lbl[-1] = 0, v - 1, v - 1
    wts[3::5] = 0.0
    (_, th), (_, tw) = _pair(h, jnp.bfloat16), _pair(w, jnp.bfloat16)
    # the JAX package in fp32 on the same bf16 values: its backward before
    # the final cast to the inputs' type
    jh, jw = jnp.asarray(_f32(th)), jnp.asarray(_f32(tw))
    jdh, jdw = jax.grad(lambda h, w: jnp.sum(_jax_ce("interpret", h, w, jnp.asarray(lbl))[0]
                                             * wts), (0, 1))(jh, jw)
    tl, tg = torch.from_numpy(lbl), torch.from_numpy(wts)
    lse = fused_ce_module.fused_ce_fwd_plain(th, tw, tl)[2]
    return _mma_grads(th, tw, tl, lse, tg, terms), (jdh, jdw), wts


# CE_SHAPES plus a D that is not a multiple of 16 and ragged rows and vocab
MMA_CE_SHAPES = CE_SHAPES + [(97, 80, 300)]


@pytest.mark.parametrize("n,d,v", MMA_CE_SHAPES)
def test_fused_ce_tensor_core_rounding_matches_jax(n, d, v):
    """The bf16 K7 and K8 hand the fp32 dlogits to the tensor cores as
    DLOGIT_TERMS bf16 terms; emulated, their fp32 dh and dw stay within the
    JAX package's fp32 gradients at F32_GRAD (the JAX suite's fp32 gradient
    tolerance), and a row with a zero cotangent gets exactly zero dh."""
    (dh, dw), (jdh, jdw), wts = _mma_case(n, d, v, seed=n + d + v, terms=DLOGIT_TERMS)
    np.testing.assert_allclose(_f32(dh), _f32(jdh), **F32_GRAD)
    np.testing.assert_allclose(_f32(dw), _f32(jdw), **F32_GRAD)
    assert float(np.abs(_f32(dh)[wts == 0]).max()) == 0.0


def test_fused_ce_one_dlogit_term_misses_f32_grad():
    """One bf16 term (8 bits of each dlogit) is not enough: the emulated
    gradients then leave F32_GRAD, which the two terms of
    test_fused_ce_tensor_core_rounding_matches_jax meet on the same case."""
    n, d, v = CE_SHAPES[-1]
    (dh, dw), (jdh, jdw), _ = _mma_case(n, d, v, seed=n + d + v, terms=1)
    assert not (np.allclose(_f32(dh), _f32(jdh), **F32_GRAD)
                and np.allclose(_f32(dw), _f32(jdw), **F32_GRAD))


class _RecordingLib:
    """Stands in for the kernel library on CPU tensors: records the design
    code each entry point is handed (the argument after the dtype code) and
    launches nothing."""

    def __init__(self):
        self.designs = {}

    def fused_ce_plan(self, pass_, design, dtype, n, v, d):
        self.designs[f"plan {pass_}"] = design
        return 1

    def fused_ce_fwd(self, *args):   # 11 pointers (the last three optional), sh, sw, dtype
        self.designs["fused_ce_fwd"] = args[14]
        return 0

    def fused_ce_dh(self, *args):
        self.designs["fused_ce_dh"] = args[10]
        return 0

    def fused_ce_dw(self, *args):
        self.designs["fused_ce_dw"] = args[9]
        return 0


def test_fused_ce_design_rule_on_cpu_tensors(monkeypatch):
    """The rule by which K6, K7 and K8 pick their design, on CPU tensors:
    bf16 whose rows can be copied in 16-byte pieces takes the tensor cores
    ("mma"); fp32, bf16 starting 2 bytes past a 16-byte boundary, bf16 rows
    8 bytes apart from a multiple of 16, and bf16 with D not a multiple of 8
    take the FMA kernels.  Each wrapper (and K6's and K7's split plan) hands
    the library the design the rule gives, decided before the launch."""
    check = fused_ce_module._check
    n, d, v = 8, 64, 40
    lbl, row = torch.zeros(n, dtype=torch.int32), torch.zeros(n)
    h, w = torch.zeros((n, d), dtype=torch.bfloat16), torch.zeros((v, d), dtype=torch.bfloat16)
    assert check(h, w, lbl, lse=row, g=row) == "mma"
    assert check(h.float(), w.float(), lbl, lse=row, g=row) == "fma"
    off = torch.zeros(n * d + 1, dtype=torch.bfloat16)[1:].view(n, d)
    wide_h = torch.zeros((n, d + 4), dtype=torch.bfloat16)[:, :d]
    wide_w = torch.zeros((v, d + 4), dtype=torch.bfloat16)[:, :d]
    assert check(off, w, lbl) == "fma"
    assert check(wide_h, w, lbl) == "fma"
    assert check(h, wide_w, lbl) == "fma"
    assert check(h[:, :60].contiguous(), w[:, :60].contiguous(), lbl) == "fma"

    lib = _RecordingLib()
    monkeypatch.setattr(fused_ce_module, "_lib", lambda: lib)
    monkeypatch.setattr(fused_ce_module, "_splits", lambda index, *a: lib.fused_ce_plan(*a))
    monkeypatch.setattr(fused_ce_module, "_stream", lambda x: None)
    codes = fused_ce_module._DESIGN_CODES
    for hh, ww, want in ((h, w, "mma"), (h.float(), w.float(), "fma"), (off, w, "fma"),
                         (wide_h, w, "fma"), (h, wide_w, "fma")):
        reset_launches()
        lib.designs.clear()
        fused_ce_module._fwd_cuda(hh, ww, lbl)
        fused_ce_module._dh_cuda(hh, ww, lbl, row, row)
        fused_ce_module._dw_cuda(hh, ww, lbl, row, row)
        assert set(lib.designs.values()) == {codes[want]}, (want, lib.designs)
        assert len(lib.designs) == 5
        for name in CE_KERNELS:
            assert VARIANT_LAUNCHES[name] == {
                "mma": int(want == "mma"), "fma": int(want == "fma")}
    reset_launches()


# ---------------------------------------------------------------------------
# gather and the fused loss
# ---------------------------------------------------------------------------

def test_d_windows_match_the_kernels_constant():
    """The D-window count K7 and K8 launch over: the CUDA source's window
    width, and 7 windows at deepseek-v3's D 7168 (the full-width loss head)."""
    src = Path(fused_ce_module.__file__).parent / "csrc" / "fused_ce.cu"
    assert f"constexpr int kDW = {fused_ce_module.D_WINDOW};" in src.read_text()
    assert [fused_ce_module.d_windows(d) for d in (80, 1024, 1025, 2048, 2056, 7168)] == [
        1, 1, 2, 2, 3, 7]


def test_gather_supervised_packs_like_jax():
    labels = np.array([
        [-1, 5, -1, 7, -1, -1],
        [-1] * 6,
        [1, 2, 3, -1, -1, -1],
        [4, -1, 4, -1, 9, 0],
    ], np.int32)
    hidden = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)
    out = loss.gather_supervised(torch.from_numpy(hidden), torch.from_numpy(labels), 3)
    ref = jax_loss.gather_supervised(jnp.asarray(hidden), jnp.asarray(labels), 3)
    assert out[0].shape == (4, 3, 2) and out[1].shape == (4, 3)
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    np.testing.assert_array_equal(out[1][0].numpy(), [5, 7, loss.IGNORE])
    np.testing.assert_array_equal(out[3].numpy(), [2, 0, 3, 4])


@pytest.mark.parametrize("seq", [32, 128, 512])
def test_mlm_buffer_size_matches_jax(seq):
    for kw in ({}, dict(mlm_max_predictions=8), dict(mask_ratio=0.0), dict(mask_ratio=0.1)):
        cfg, jcfg = bert_large.smoke().replace(**kw), jax_bert.smoke().replace(**kw)
        assert loss.mlm_buffer_size(cfg, seq) == jax_loss.mlm_buffer_size(jcfg, seq)
    assert loss.mlm_buffer_size(bert_large.smoke(), 128) == 20
    assert loss.mlm_buffer_size(bert_large.smoke(), 512) == 77


def _labels(b, s, v, supervision, seed):
    rng = np.random.default_rng(seed)
    labels = np.full((b, s), loss.IGNORE, np.int32)
    if supervision == "full":
        return rng.integers(0, v, (b, s)).astype(np.int32)
    if supervision == "partial":
        sel = rng.random((b, s)) < 0.3
        sel[:, 0] = True
        labels[sel] = rng.integers(0, v, (b, s))[sel]
    return labels


@pytest.mark.parametrize("supervision", ["partial", "full", "zero"])
def test_fused_cross_entropy_matches_dense_and_jax(supervision):
    """Same semantics as the dense cross_entropy (token mean over labels >= 0;
    zero supervision: loss 0, accuracy 0, zero gradients), and the JAX
    package's fused_cross_entropy on the same arrays."""
    b, s, d, v = 3, 24, 16, 120
    rng = np.random.default_rng(13)
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.3).astype(np.float32)
    labels = _labels(b, s, v, supervision, seed=14)
    tl = torch.from_numpy(labels)

    def port(fn):
        th = torch.from_numpy(hidden).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        lo, acc = fn(th, tw)
        return lo.detach(), acc, *torch.autograd.grad(lo, (th, tw))

    fused = port(lambda h, w: loss.fused_cross_entropy(h, tl, w, max_positions=s))
    dense = port(lambda h, w: loss.cross_entropy(torch.einsum("bsd,vd->bsv", h, w), tl))
    jfn = lambda h, w: jax_loss.fused_cross_entropy(  # noqa: E731
        h, jnp.asarray(labels), w, max_positions=s, backend="xla")
    (jl, ja), jvjp = jax.vjp(jfn, jnp.asarray(hidden), jnp.asarray(w))
    jgrads = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    assert float(fused[0]) == pytest.approx(float(dense[0]), rel=1e-5, abs=1e-7)
    assert float(fused[1]) == pytest.approx(float(dense[1]))
    assert float(fused[0]) == pytest.approx(float(jl), rel=1e-5, abs=1e-7)
    assert float(fused[1]) == pytest.approx(float(ja))
    for a, bb, r in zip(fused[2:], dense[2:], jgrads):
        np.testing.assert_allclose(_f32(a), _f32(bb), **F32_GRAD)
        np.testing.assert_allclose(_f32(a), _f32(r), **F32_GRAD)
    if supervision == "zero":
        assert float(fused[0]) == 0.0 and float(fused[1]) == 0.0
        assert all(float(g.abs().max()) == 0.0 for g in fused[2:])


def test_fused_cross_entropy_overflow_raises_on_the_cpu():
    b, s, d, v = 2, 16, 8, 64
    hidden, w = torch.zeros((b, s, d)), torch.zeros((v, d))
    labels = torch.zeros((b, s), dtype=torch.int32)   # all 16 positions supervised
    with pytest.raises(ValueError, match="silently truncate"):
        loss.fused_cross_entropy(hidden, labels, w, max_positions=4)
    with pytest.raises(ValueError, match="silently truncate"):
        jax_loss.fused_cross_entropy(jnp.zeros((b, s, d)), jnp.zeros((b, s), jnp.int32),
                                     jnp.zeros((v, d)), max_positions=4)


def test_fused_cross_entropy_overflow_poisons_loss_and_gradients():
    """Past the eager check (which runs only for labels on the CPU: on the
    card it would cost a device sync) an overflowing buffer gives NaN loss,
    accuracy and gradients, as the JAX package's does under jit; a batch
    that fits stays finite."""
    b, s, d, v = 2, 16, 8, 64
    rng = np.random.default_rng(15)
    hidden = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))

    def run(labels):
        th, tw = hidden.clone().requires_grad_(), w.clone().requires_grad_()
        lo, acc = loss._gathered_cross_entropy(th, torch.from_numpy(labels), tw, 4)
        return (lo.detach(), acc, *torch.autograd.grad(lo, (th, tw)))

    over = run(np.zeros((b, s), np.int32))                      # 16 > 4
    assert np.isnan(float(over[0])) and np.isnan(float(over[1]))
    assert torch.isnan(over[2]).any() and torch.isnan(over[3]).any()
    jf = jax.jit(lambda l: jax_loss.fused_cross_entropy(
        jnp.asarray(hidden.numpy()), l, jnp.asarray(w.numpy()), max_positions=4)[0])
    assert np.isnan(float(jf(jnp.zeros((b, s), jnp.int32))))
    ok = np.full((b, s), loss.IGNORE, np.int32)
    ok[:, :3] = 1
    fine = run(ok)                                              # 3 <= 4
    assert all(torch.isfinite(x).all() for x in fine)
    assert float(fine[0]) == pytest.approx(float(jf(jnp.asarray(ok))), rel=1e-5)


def test_fused_ce_unsupported_configs_raise():
    cfg = bert_large.smoke()
    with pytest.raises(ValueError, match="logit_softcap"):
        loss.check_fused_ce_supported(cfg.replace(logit_softcap=30.0))
    with pytest.raises(ValueError, match="family"):
        loss.check_fused_ce_supported(cfg.replace(family="hybrid"))
    audio = cfg.replace(frontend="audio_stub", mask_ratio=0.08)
    with pytest.raises(ValueError, match="mlm_max_predictions"):
        loss.check_fused_ce_supported(audio)
    loss.check_fused_ce_supported(audio.replace(mlm_max_predictions=32))
    with pytest.raises(ValueError, match="needs params"):
        loss.lm_loss(None, {"labels": torch.zeros((1, 4), dtype=torch.int32)}, {}, cfg,
                     hidden=torch.zeros((1, 4, 128)))


# ---------------------------------------------------------------------------
# model level: the bert-smoke fused head
# ---------------------------------------------------------------------------

def _model_batch(cfg, supervision, b=4, s=32):
    if supervision == "partial":
        return make_batch(cfg, np.random.default_rng(0), b, s), cfg
    toks = jax_synthetic.SyntheticLM(cfg.vocab_size, seed=0).tokens(
        np.random.default_rng(1), b, s)
    if supervision == "full":
        # every position supervised: the buffer must be widened to S
        return {"tokens": toks, "labels": toks.copy()}, cfg.replace(mlm_max_predictions=s)
    return {"tokens": toks, "labels": np.full((b, s), loss.IGNORE, np.int32)}, cfg


def _port_loss_and_grads(cfg, jparams, batch, fused):
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    lo, metrics = make_loss_fn(build_model(cfg.replace(use_fused_ce_head=fused)))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(lo, list(params.values()))
    return float(lo.detach()), float(metrics["accuracy"]), dict(zip(params, grads))


@pytest.mark.parametrize("supervision", ["partial", "full", "zero"])
def test_bert_smoke_fused_head_matches_jax_fp32(supervision):
    """Loss, accuracy and every parameter's gradient (the tied ``embed``'s
    included: the lookup's gradient plus the head's dw) of the port's fused
    head against the JAX package's fused head on the same weights.  Whole
    model in fp32: behind the head the two frameworks' gradients differ by
    fp32 rounding amplified by bert-smoke's saturated attention, up to 6e-5
    of each leaf's largest entry with the dense head as with the fused one
    (3e-5 relative L2), so 1e-4 of it there; the leaves the head's gradient
    reaches first (``final_norm``) agree to 3e-6, so 1e-5 of it there."""
    raw, jcfg = _model_batch(jax_bert.smoke().replace(activation_dtype="float32"),
                             supervision)
    cfg = bert_large.smoke().replace(activation_dtype="float32",
                                     mlm_max_predictions=jcfg.mlm_max_predictions)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    (jl, jm), jg = jax.value_and_grad(jax_make_loss_fn(jmodel, use_fused_ce=True),
                                      has_aux=True)(jparams, jb)
    lo, acc, grads = _port_loss_and_grads(cfg, jparams, raw, fused=True)
    assert lo == pytest.approx(float(jl), rel=1e-5, abs=1e-7)
    assert acc == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    for k, ref in flatten(jax.tree.map(np.asarray, jg)).items():
        share = 1e-5 if k.startswith("final_norm") else 1e-4
        np.testing.assert_allclose(_f32(grads[k]), ref, rtol=1e-4,
                                   atol=share * max(float(np.abs(ref).max()), 1e-30), err_msg=k)
    if supervision == "zero":
        assert lo == 0.0 and all(float(g.abs().max()) == 0.0 for g in grads.values())


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_bert_smoke_fused_head_matches_dense_head(act_dtype):
    """Within the port, the fused head reproduces the dense head's loss,
    accuracy and gradients (tests/test_fused_ce.py's fused-vs-dense bounds:
    bf16 rounds the dense logits before its fp32 softmax while the fused
    head keeps the fp32 product)."""
    cfg = bert_large.smoke().replace(activation_dtype=act_dtype)
    raw = make_batch(jax_bert.smoke(), np.random.default_rng(0), 4, 32)
    jparams = jax_build_model(jax_bert.smoke()).init(jax.random.key(1))
    if act_dtype == "bfloat16":
        jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    lf, af, gf = _port_loss_and_grads(cfg, jparams, raw, fused=True)
    ld, ad, gd = _port_loss_and_grads(cfg, jparams, raw, fused=False)
    bf16 = act_dtype == "bfloat16"
    assert lf == pytest.approx(ld, rel=2e-2 if bf16 else 1e-5)
    assert af == pytest.approx(ad, abs=0.1 if bf16 else 1e-6)
    for k in gf:
        ref = _f32(gd[k])
        tol = dict(rtol=5e-2, atol=3e-2) if bf16 else dict(
            rtol=1e-4, atol=1e-5 * max(float(np.abs(ref).max()), 1e-30))
        np.testing.assert_allclose(_f32(gf[k]), ref, **tol, err_msg=k)


def test_fused_head_saves_no_logits_tensor():
    """Nothing of the fused loss holds a (B, S, V) or (B·P, V) tensor for the
    backward; the dense head does (the port's analog of the JAX suite's HLO
    check)."""
    cfg = bert_large.smoke().replace(vocab_size=3001, activation_dtype="float32")
    model = build_model(cfg)
    params = {k: v.requires_grad_() for k, v in model.init(0, "cpu").items()}
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(jax_bert.smoke().replace(vocab_size=3001), np.random.default_rng(0),
                        4, 32).items()}
    for fused, expect in ((True, False), (False, True)):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
            make_loss_fn(build_model(cfg.replace(use_fused_ce_head=fused)))(params, batch)
        assert any(3001 in sh and sh != (3001, 128) for sh in shapes) is expect, shapes


# ---------------------------------------------------------------------------
# the slice: train steps and the launcher
# ---------------------------------------------------------------------------

def test_fused_ce_train_steps_match_jax_fp32():
    """bert-smoke with flash and the fused CE head on in both packages (the
    port's plain versions, the JAX package's XLA backends), fused LAMB, fp32,
    accumulation 2: the tolerances of tests/test_torch_train.py."""
    jcfg = jax_bert.smoke().replace(activation_dtype="float32")
    cfg = bert_large.smoke().replace(activation_dtype="float32")
    assert jcfg.use_fused_ce_head and cfg.use_fused_ce_head and cfg.use_flash_kernel
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
    reset_launches()
    for _ in range(3):
        batch = next(data)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss/total", "loss/ce", "update_norm", "tokens/supervised"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]), atol=1e-6)
    assert float(m["update_norm"]) > 0.0
    assert all(LAUNCHES[k] == 0 for k in CE_KERNELS)   # the CPU runs the plain version
    for k, v in params_from_jax(jstate.params).items():
        diff = (state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


def test_fused_ce_embed_gradient_matches_jax():
    """The tied embedding's gradient through a whole accumulated step's loss:
    the lookup's share and the fused head's dw, summed by autograd in the
    port and by JAX's transpose in the reference, on the same weights."""
    jcfg = jax_bert.smoke().replace(activation_dtype="float32")
    cfg = bert_large.smoke().replace(activation_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.key(2))
    batch = next(jax_synthetic.batch_iterator(jcfg, 8, 32, seed=4))
    jg = jax.grad(lambda p: jax_make_loss_fn(jax_build_model(jcfg))(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    params = {k: v.requires_grad_() for k, v in params_from_jax(jparams).items()}
    grads, _ = _microbatch_grads(make_loss_fn(build_model(cfg)), params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    ref = np.asarray(jg["embed"])
    assert grads["embed"].shape == (512, 128)
    np.testing.assert_allclose(grads["embed"].numpy(), ref, rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref).max()))
    # both shares are there: rows of tokens never fed in still get the head's
    fed = np.unique(batch["tokens"])
    unfed = np.setdiff1d(np.arange(512), fed)
    assert unfed.size and np.abs(ref[unfed]).max() > 0


def test_launcher_fused_ce_smoke_runs_to_done(capsys, monkeypatch):
    """``--fused-ce`` on the CPU: the plain forward and backward of K6–K8 once
    per step, each micro-batch."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("fused_ce_fwd_plain", "fwd"), ("_grads_plain", "bwd")):
        def counted(*a, _f=getattr(fused_ce_module, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(fused_ce_module, name, counted)
    argv = ["--arch", "bert-large", "--smoke", "--batch", "4", "--seq", "16", "--fused-lamb",
            "--fused-ce", "--accum-steps", "2", "--steps", "2", "--device", "cpu",
            "--log-every", "1"]
    trainer = launch_train.main(argv)
    out = capsys.readouterr().out
    assert "fused_ce=True" in out and "done: step=2 " in out and "status=ok" in out
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss/total"]) for h in trainer.history)
    assert calls == {"fwd": 4, "bwd": 4}   # 2 steps x 2 micro-batches
