"""The port's configs, data, layers, forward and init against the JAX package
at bert-smoke size, on the same numpy inputs and bridged weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as jax_bert
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.models.layers import attention as jax_attention
from repro.models.layers import embeddings as jax_embeddings
from repro.models.layers import mlp as jax_mlp
from repro.models.layers import norms as jax_norms
from repro.train import loss as jax_loss
from repro_torch.configs import bert_large, get_config
from repro_torch.data import DataPipeline, batch_iterator, mlm_batch, SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.layers import attention, embeddings, mlp, norms
from repro_torch.nn import flatten, params_from_jax
from repro_torch.train import loss

F32 = dict(rtol=1e-5, atol=1e-5)
OFF = dict(use_flash_kernel=False, use_fused_ce_head=False)


def smoke_pair(**kw):
    return jax_bert.smoke().replace(**OFF, **kw), bert_large.smoke().replace(**OFF, **kw)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("make", [jax_bert.smoke, lambda: jax_bert.CONFIG, jax_bert.tiny])
def test_configs_equal_jax_copies(make):
    ref = make()
    port = {"bert-smoke": bert_large.smoke(), "bert-large": get_config("bert-large"),
            "bert-tiny": bert_large.tiny()}[ref.name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_unported_archs_and_kernels_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("smollm-360m")
    with pytest.raises(NotImplementedError, match="K3"):
        build_model(bert_large.smoke().replace(use_fused_ce_head=False))
    with pytest.raises(NotImplementedError, match="K6"):
        build_model(bert_large.smoke().replace(use_flash_kernel=False))
    for field in (dict(norm_type="rmsnorm"), dict(gated_mlp=True), dict(act_fn="silu"),
                  dict(n_experts=4), dict(tie_embeddings=False), dict(remat="full")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(bert_large.smoke().replace(**OFF, **field))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_mlm_batches_byte_equal_to_jax(seed):
    jcfg, cfg = smoke_pair()
    src, jsrc = SyntheticLM(512, seed=seed), jax_synthetic.SyntheticLM(512, seed=seed)
    a = mlm_batch(src, np.random.default_rng(seed), 4, 64, 0.15, max_predictions=9)
    b = jax_synthetic.mlm_batch(jsrc, np.random.default_rng(seed), 4, 64, 0.15,
                                max_predictions=9)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    it, jit_ = batch_iterator(cfg, 8, 32, seed=seed), jax_synthetic.batch_iterator(
        jcfg, 8, 32, seed=seed)
    for _ in range(3):
        a, b = next(it), next(jit_)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("vocab", [512, 30522])
def test_token_stream_byte_equal_to_jax(vocab):
    a = SyntheticLM(vocab, seed=4).tokens(np.random.default_rng(9), 16, 48)
    b = jax_synthetic.SyntheticLM(vocab, seed=4).tokens(np.random.default_rng(9), 16, 48)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_causal_lm_batches_byte_equal_to_jax():
    jcfg, cfg = smoke_pair(causal=True, mask_ratio=0.0)
    a = next(batch_iterator(cfg, 4, 16, seed=2))
    b = next(jax_synthetic.batch_iterator(jcfg, 4, 16, seed=2))
    for k in b:
        assert a[k].tobytes() == b[k].tobytes()


def test_data_pipeline_moves_batches_to_device():
    jcfg, cfg = smoke_pair()
    pipe = DataPipeline(cfg, 4, 16, device="cpu", seed=1)
    ref = jax_synthetic.batch_iterator(jcfg, 4, 16, seed=1)
    for _ in range(3):
        b, r = next(pipe), next(ref)
        for k in r:
            assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), r[k])
    stage = pipe.with_stage(2, 64)
    assert next(stage)["tokens"].shape == (2, 64)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)) * 3 + 1
    p = {"scale": rng.standard_normal(32), "bias": rng.standard_normal(32)}
    ref = jax_norms.apply_norm({k: j(v) for k, v in p.items()}, j(x), "layernorm")
    out = norms.apply_norm({k: t(v) for k, v in p.items()}, t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_gelu_mlp_matches_jax():
    jcfg, cfg = smoke_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 128))
    p = {"wi": rng.standard_normal((128, 256)) * 0.1, "wo": rng.standard_normal((256, 128)) * 0.1}
    ref = jax_mlp.mlp({k: j(v) for k, v in p.items()}, j(x), jcfg)
    out = mlp.mlp({k: t(v) for k, v in p.items()}, t(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32)[None] + 40, (2, 7))
    ref = jax_embeddings.apply_rope(j(x), jnp.asarray(pos), 10000.0)
    out = embeddings.apply_rope(t(x), torch.from_numpy(pos.copy()), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_matches_jax(causal):
    jcfg, cfg = smoke_pair(causal=causal)
    rng = np.random.default_rng(3)
    b, s, d, h, dh = 3, 12, 128, 4, cfg.head_dim
    x = rng.standard_normal((b, s, d))
    p = {"wq": rng.standard_normal((d, h, dh)) * 0.1, "wk": rng.standard_normal((d, h, dh)) * 0.1,
         "wv": rng.standard_normal((d, h, dh)) * 0.1, "wo": rng.standard_normal((h, dh, d)) * 0.1}
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    valid = np.array([12, 5, 0], np.int32)  # full, ragged, fully padded
    ref, _ = jax_attention.attention({k: j(v) for k, v in p.items()}, j(x),
                                     jnp.asarray(pos), jcfg, valid_len=jnp.asarray(valid))
    out = attention.attention({k: t(v) for k, v in p.items()}, t(x),
                              torch.from_numpy(pos), cfg, valid_len=torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 50)) * 4
    logits[0, 0, [3, 7]] = 20.0  # a tie: both pick the first maximum
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[:, ::2] = -1
    labels[0, 0] = 7
    ref = jax_loss.cross_entropy(j(logits), jnp.asarray(labels))
    out = loss.cross_entropy(t(logits), torch.from_numpy(labels))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _forward_pair(activation_dtype):
    jcfg, cfg = smoke_pair(activation_dtype=activation_dtype)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(1))
    batch = next(jax_synthetic.batch_iterator(jcfg, 4, 32, seed=5))
    batch["valid_len"] = np.array([32, 20, 9, 32], np.int32)
    ref, _ = jmodel.apply(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    out = model.apply(params_from_jax(jparams),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    return out, np.asarray(jnp.asarray(ref, jnp.float32))


def test_bert_smoke_forward_matches_jax_fp32():
    out, ref = _forward_pair("float32")
    assert out.shape == ref.shape == (4, 32, 512)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def test_bert_smoke_forward_matches_jax_bf16():
    out, ref = _forward_pair("bfloat16")
    assert out.dtype == torch.bfloat16
    # bf16 keeps 8 significant bits and the two frameworks round their
    # matmuls and casts at different places; over two blocks that leaves
    # differences of a few bf16 ulps of the O(1) activations
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref, rtol=0.05, atol=0.05)


def test_init_laws_match_jax_in_distribution():
    jcfg, cfg = smoke_pair()
    jparams = flatten(jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0))))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    assert list(params) == list(jparams) and len(params) == 13
    assert model.param_count() == sum(v.size for v in jparams.values())
    for k, ref in jparams.items():
        out = params[k].numpy()
        assert out.shape == ref.shape and out.dtype == ref.dtype, k
        if ref.std() == 0:  # ones / zeros
            np.testing.assert_array_equal(out, ref)
            continue
        # n >= 16k draws: the sample std agrees to a few percent, the mean
        # to a few standard errors, and the ±2σ truncation bounds both
        assert abs(out.std() / ref.std() - 1) < 0.03, k
        assert abs(out.mean() - ref.mean()) < 5 * ref.std() / np.sqrt(ref.size), k
        assert np.abs(out).max() <= np.abs(ref).max() * 1.5 + 1e-6, k
    again = model.init(0, "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_bert_large_has_333m_params_in_13_leaves():
    model = build_model(get_config("bert-large").replace(**OFF))
    shapes = {k: p.shape for k, p in flatten(model.defs).items()}
    assert len(shapes) == 13 and model.param_count() == 333_344_768
    assert shapes["blocks/attn/wq"] == (24, 1024, 16, 64)
    assert shapes["embed"] == (30522, 1024)
    masks = model.wd_mask(), model.trust_mask(), model.layer_axes()
    off = {k for k in shapes if "/ln" in k or k.startswith("final_norm")}
    assert len(off) == 6
    for k in shapes:
        assert masks[0][k] == masks[1][k] == (k not in off)
        assert masks[2][k] == (-1 if k == "embed" or k.startswith("final_norm") else 0)
