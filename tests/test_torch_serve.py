"""The port's serving path against the JAX package's on the CPU: the
smollm-360m config, RMSNorm and the gated MLP, prefill and decode over the KV
cache (dense and flash), the static and continuous engines, sampling, the KV
pool, the scheduler and the launcher.

Models are ``tiny_dense`` of ``tests/conftest.py`` (2 layers, d 64, 4 heads
over 2 KV heads, vocab 256) with the JAX weights carried across by path and
caches by ``cache_from_jax``.  Tolerances, relative to the reference
tensor's scale ``max(1, max|ref|)``: 3e-5 in fp32 and 3e-2 in bf16 (a few
bf16 ulps: the two frameworks round bf16 products and sums in another
order), the JAX flash suite's own.  fp32 greedy tokens must be identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jax_serve
import repro_torch.serve as serve
from conftest import tiny_dense
from repro.configs import smollm_360m as jax_smollm
from repro.models import build_model as jax_build_model
from repro.models.layers import mlp as jax_mlp
from repro.models.layers import norms as jax_norms
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.layers import mlp, norms
from repro_torch.nn import cache_from_jax, params_from_jax
from repro_torch.serve import (
    ContinuousEngine,
    Engine,
    KVPool,
    Request,
    RequestStatus,
    ServeRequest,
    sample_tokens,
    top_k_mask,
)
from repro_torch.serve.continuous import make_pool_decode_step, make_pool_prefill
from repro_torch.serve.engine import make_decode_step, make_prefill_step

TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(a, ref, dtype, msg=""):
    ref = _f32(ref)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(a), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=msg)


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _pair(**kw):
    """(jax model, jax params, port model, port params) of tiny_dense(**kw)."""
    jcfg = tiny_dense(**kw)
    jmodel, model = jax_build_model(jcfg), build_model(port_config(jcfg))
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, model, params_from_jax(jparams)


@pytest.fixture(scope="module")
def fp32():
    return _pair(activation_dtype="float32")


@pytest.fixture(scope="module")
def bf16():
    return _pair()


def _prompts(n, s=10, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=s).astype(np.int32) for _ in range(n)]


# ---------------------------------------------------------------------------
# config and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [lambda: jax_smollm.CONFIG, jax_smollm.smoke])
def test_smollm_config_equals_jax(make):
    ref = make()
    port = get_config("smollm-360m") if ref.name == "smollm-360m" else smoke_config(
        "smollm-360m")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.head_dim, port.q_groups, port.norm_type, port.gated_mlp) == (
        ref.head_dim, ref.q_groups, "rmsnorm", True)
    # the model builds (RMSNorm and the gated MLP are ported) with the
    # reference's parameter paths
    jdefs = jax_build_model(ref).defs
    assert build_model(port).param_count() == jax_build_model(ref).param_count()
    assert "wg" in jdefs["blocks"]["mlp"] and "bias" not in jdefs["blocks"]["ln1"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = jax_norms.apply_norm({"scale": jnp.asarray(scale)}, jx, "rmsnorm")
    out = norms.apply_norm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(_f32(jx)).to(getattr(torch, dtype)), "rmsnorm")
    assert out.dtype == getattr(torch, dtype)
    _close(out, ref, dtype)
    assert set(norms.norm_defs(48, "rmsnorm")) == {"scale"}
    assert set(norms.norm_defs(48, "layernorm")) == {"scale", "bias"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True), ("silu", False),
                                       ("relu", False)])
def test_mlp_matches_jax(act, gated, dtype):
    """The gate is ``wg``: h = act(x @ wg) * (x @ wi)."""
    jcfg = tiny_dense(act_fn=act, gated_mlp=gated, activation_dtype=dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    p = {"wi": rng.standard_normal((64, 128)) * 0.1, "wo": rng.standard_normal((128, 64)) * 0.1}
    if gated:
        p["wg"] = rng.standard_normal((64, 128)) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    assert set(mlp.mlp_defs(64, 128, gated, act)) == set(p)
    jx = jnp.asarray(x).astype(dtype)
    ref = jax_mlp.mlp({k: jnp.asarray(v) for k, v in p.items()}, jx, jcfg)
    out = mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(_f32(jx)).to(getattr(torch, dtype)), port_config(jcfg))
    _close(out, ref, dtype)


# ---------------------------------------------------------------------------
# prefill and decode over the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype, flash):
    """Logits and the filled cache (k, v and index) of one prefill; flash
    runs the port's plain K3 and JAX's flash path on the CPU."""
    jmodel, jparams, model, params = _pair(activation_dtype=dtype, use_flash_kernel=flash)
    toks = np.stack(_prompts(3, s=10, seed=2))
    ref, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jmodel.make_cache(3, 24))
    with torch.inference_mode():
        cache = model.make_cache(3, 24, "cpu")
        out, same = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache)
    assert same is cache and out.dtype == getattr(torch, dtype)
    _close(out, ref, dtype, "logits")
    for k in ("k", "v"):
        assert cache["main"][k].shape == (2, 3, 24, 2, 16)
        _close(cache["main"][k], jcache["main"][k], dtype, k)
    np.testing.assert_array_equal(cache["main"]["index"].numpy(),
                                  np.asarray(jcache["main"]["index"]))


def _filled_cache(jmodel, jparams, b=3, s=10, max_len=24):
    toks = np.stack(_prompts(b, s=s, seed=3))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               jmodel.make_cache(b, max_len))
    return jax.tree.map(np.asarray, jcache)


@pytest.mark.parametrize("index", ["scalar", "per-slot"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype, index):
    """One decode step from the same prefilled cache: a scalar index (the
    static engine, two tokens at once) and a (B,) index with an inactive
    slot at 0 and a shorter one (the slot pool)."""
    jmodel, jparams, model, params = _pair(activation_dtype=dtype)
    jcache = _filled_cache(jmodel, jparams)
    if index == "scalar":
        toks = np.array([[5, 6], [9, 10], [200, 201]], np.int32)
        pos = np.broadcast_to(np.arange(10, 12, dtype=np.int32), (3, 2)).copy()
    else:
        idx = np.array([10, 0, 7], np.int32)
        jcache["main"]["index"] = np.broadcast_to(idx, (2, 3)).copy()
        toks = np.array([[5], [9], [200]], np.int32)
        pos = idx[:, None].copy()
    cache = cache_from_jax(jcache)
    ref, jnew = jmodel.decode(jparams, {"tokens": jnp.asarray(toks)},
                              jax.tree.map(jnp.asarray, jcache), jnp.asarray(pos))
    with torch.inference_mode():
        out, _ = model.decode(params, {"tokens": torch.from_numpy(toks)}, cache,
                              torch.from_numpy(pos))
    _close(out, ref, dtype, "logits")
    for k in ("k", "v"):
        _close(cache["main"][k], jnew["main"][k], dtype, k)
    np.testing.assert_array_equal(cache["main"]["index"].numpy(), np.asarray(jnew["main"]["index"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_decode_equals_full_forward(dtype):
    """Prefill then decode gives the full forward's logits at each new
    position (the cache holds what the forward would recompute)."""
    _, _, model, params = _pair(activation_dtype=dtype)
    toks = torch.from_numpy(np.stack(_prompts(2, s=12, seed=4)))
    with torch.inference_mode():
        full, _ = model.apply(params, {"tokens": toks})
        cache = model.make_cache(2, 16, "cpu")
        out, _ = model.prefill(params, {"tokens": toks[:, :8]}, cache)
        steps = [out[:, -1]]
        for t in range(8, 12):
            pos = torch.full((2, 1), t, dtype=torch.int32)
            out, _ = model.decode(params, {"tokens": toks[:, t:t + 1]}, cache, pos)
            steps.append(out[:, -1])
    _close(torch.stack(steps[:-1], 1), full[:, 7:11], dtype)


def test_bf16_teacher_forced_logits_match_jax(bf16):
    """bf16 through the static engine's two steps, both packages fed the
    same tokens (the fp32 greedy continuation), logits compared per step:
    free-running bf16 sequences part where a top-2 margin is within
    rounding, so they are not compared."""
    jmodel, jparams, model, params = bf16
    prompts = np.stack(_prompts(3, s=10, seed=5))
    forced = np.random.default_rng(6).integers(0, 256, (3, 8)).astype(np.int32)
    jpre, jdec = jax.jit(jax_serve.make_prefill_step(jmodel)), jax.jit(
        jax_serve.make_decode_step(jmodel))
    pre, dec = make_prefill_step(model), make_decode_step(model)
    jlast, jcache = jpre(jparams, {"tokens": jnp.asarray(prompts)}, jmodel.make_cache(3, 24))
    with torch.inference_mode():
        cache = model.make_cache(3, 24, "cpu")
        last, cache = pre(params, {"tokens": torch.from_numpy(prompts)}, cache)
        _close(last, jlast, "bfloat16", "prefill")
        for t in range(forced.shape[1]):
            tok = forced[:, t:t + 1]
            pos = np.full((3, 1), 10 + t, np.int32)
            jlast, jcache = jdec(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
            last, cache = dec(params, cache, torch.from_numpy(tok), torch.from_numpy(pos))
            _close(last, jlast, "bfloat16", f"decode step {t}")


# ---------------------------------------------------------------------------
# engines: fp32 greedy tokens identical to the JAX engines'
# ---------------------------------------------------------------------------

NEW = [6, 3, 8, 5, 7]


@pytest.fixture(scope="module")
def jax_greedy(fp32):
    """The JAX engines' fp32 greedy tokens on five prompts: static, and
    continuous over 2 slots (admissions mid-decode)."""
    jmodel, jparams, _, _ = fp32
    prompts = _prompts(5)
    static = jax_serve.Engine(jmodel, jparams, max_len=32).generate_batch(
        [jax_serve.Request(p, max_new_tokens=m) for p, m in zip(prompts, NEW)])
    cont = jax_serve.ContinuousEngine(jmodel, jparams, n_slots=2, max_len=32).generate(
        [jax_serve.ServeRequest(p, max_new_tokens=m) for p, m in zip(prompts, NEW)])
    return ([np.asarray(r.out_tokens) for r in static],
            [np.asarray(r.out_tokens) for r in cont])


def test_static_engine_greedy_tokens_equal_jax(fp32, jax_greedy):
    _, _, model, params = fp32
    out = Engine(model, params, max_len=32).generate_batch(
        [Request(p, max_new_tokens=m) for p, m in zip(_prompts(5), NEW)])
    for r, ref in zip(out, jax_greedy[0]):
        np.testing.assert_array_equal(r.out_tokens, ref)


def test_continuous_engine_greedy_tokens_equal_jax(fp32, jax_greedy):
    _, _, model, params = fp32
    eng = ContinuousEngine(model, params, n_slots=2, max_len=32)
    out = eng.generate([ServeRequest(p, max_new_tokens=m) for p, m in zip(_prompts(5), NEW)])
    for r, ref, static in zip(out, jax_greedy[1], jax_greedy[0]):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), ref)
        np.testing.assert_array_equal(np.asarray(r.out_tokens), static)
        assert r.status is RequestStatus.COMPLETED
    assert eng.pool.n_free == 2  # everything evicted at drain


def test_static_engine_rejects_batch_past_max_len(fp32):
    _, _, model, params = fp32
    with pytest.raises(ValueError, match="max_len"):
        Engine(model, params, max_len=16).generate_batch(
            [Request(np.zeros(10, np.int32), max_new_tokens=7)])


def test_engine_per_request_temperature(fp32, jax_greedy):
    """A greedy row decodes greedily next to a row sampling at a high
    temperature (one generator for the batch)."""
    _, _, model, params = fp32
    prompts = _prompts(5)
    mixed = Engine(model, params, max_len=32, seed=3).generate_batch([
        Request(prompts[0].copy(), max_new_tokens=8, temperature=1.5),
        Request(prompts[2].copy(), max_new_tokens=8, temperature=0.0),
    ])
    np.testing.assert_array_equal(mixed[1].out_tokens, jax_greedy[0][2])
    assert ((mixed[0].out_tokens >= 0) & (mixed[0].out_tokens < 256)).all()


def test_per_request_termination_eos_and_streaming(fp32, jax_greedy):
    _, _, model, params = fp32
    prompts = _prompts(5)
    seen = {}
    new = [1, 4, 8, 2, 6]
    out = ContinuousEngine(model, params, n_slots=3, max_len=32).generate(
        [ServeRequest(p, max_new_tokens=m) for p, m in zip(prompts, new)],
        on_token=lambda r, t: seen.setdefault(r.rid, []).append(t))
    assert [len(r.out_tokens) for r in out] == new
    assert all(np.isfinite(r.finish_s) for r in out)
    assert all(seen[r.rid] == r.out_tokens for r in out)
    ref = [int(t) for t in jax_greedy[1][2]]  # 8 greedy tokens of prompt 2
    k = next(i for i in range(1, 8) if ref[i] not in ref[:i])
    eos = ContinuousEngine(model, params, n_slots=1, max_len=32).generate(
        [ServeRequest(prompts[2], max_new_tokens=8, eos_token=ref[k])])[0]
    assert eos.out_tokens == ref[:k + 1]  # stops at (and keeps) EOS


def test_engine_validates_requests(fp32):
    _, _, model, params = fp32
    ce = ContinuousEngine(model, params, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="cache positions"):
        ce.submit(ServeRequest(np.zeros(10, np.int32), max_new_tokens=10))
    for bad in (float("nan"), float("inf"), -0.5):
        with pytest.raises(ValueError, match="temperature"):
            ce.submit(ServeRequest(np.zeros(4, np.int32), temperature=bad))
    with pytest.raises(ValueError, match="top_k"):
        ce.submit(ServeRequest(np.zeros(4, np.int32), top_k=-1))
    ce.submit(ServeRequest(np.zeros(4, np.int32), max_new_tokens=4, temperature=0.0,
                           top_k=0))


def test_sampled_continuous_run_is_reproducible(fp32):
    """Temperature 0.8, top-k 5 beside greedy rows: one seed twice gives the
    same tokens, another seed others; greedy rows keep their tokens."""
    _, _, model, params = fp32
    prompts = _prompts(4, seed=7)

    def run(seed):
        reqs = [ServeRequest(p, max_new_tokens=8, temperature=0.8 if i % 2 else 0.0,
                             top_k=5 if i % 2 else 0) for i, p in enumerate(prompts)]
        out = ContinuousEngine(model, params, n_slots=4, max_len=32, seed=seed).generate(reqs)
        return [list(r.out_tokens) for r in out]

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert a[0] == c[0] and a[2] == c[2]  # greedy rows


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_top_k_mask_equals_jax():
    logits = np.random.default_rng(0).normal(size=(5, 40)).astype(np.float32)
    logits[1, [3, 9]] = 4.0   # a tie at the threshold keeps both
    k = np.array([1, 2, 0, -3, 40], np.int32)
    ref = jax_serve.top_k_mask(jnp.asarray(logits), jnp.asarray(k))
    out = top_k_mask(torch.from_numpy(logits), torch.from_numpy(k))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sample_tokens_greedy_rows_and_seeds():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 32)).astype(np.float32))
    greedy = torch.argmax(logits, -1).to(torch.int32)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(sample_tokens(gen, logits, torch.zeros(6)), greedy)
    # top_k 1 is argmax whatever the temperature
    assert torch.equal(sample_tokens(gen, logits, torch.full((6,), 5.0),
                                     torch.ones(6, dtype=torch.int32)), greedy)
    temps = torch.tensor([0.0, 2.0, 0.0, 2.0, 0.0, 2.0])
    draws = [sample_tokens(torch.Generator().manual_seed(s), logits, temps)
             for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert all(torch.equal(d[::2], greedy[::2]) for d in draws)
    many = [sample_tokens(torch.Generator().manual_seed(s), logits, temps) for s in range(8)]
    assert len({tuple(d.tolist()) for d in many}) > 1
    assert all(d.dtype == torch.int32 and ((d >= 0) & (d < 32)).all() for d in many)


@pytest.mark.parametrize("top_k", [0, 2])
def test_sample_frequencies_follow_softmax(top_k):
    """20,000 draws over a 5-token vocabulary at temperature 0.7: each
    token's frequency within 0.02 of softmax(logits / 0.7) (renormalised
    over the top-k; ~6 standard deviations of a frequency at this count)."""
    n = 20_000
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0])
    scaled = logits / 0.7
    if top_k:
        scaled = torch.where(scaled >= scaled.topk(top_k).values[-1], scaled, -torch.inf)
    want = torch.softmax(scaled, -1)
    toks = sample_tokens(torch.Generator().manual_seed(0), logits.expand(n, 5),
                         torch.full((n,), 0.7),
                         torch.full((n,), top_k, dtype=torch.int32))
    freq = torch.bincount(toks.long(), minlength=5).double() / n
    np.testing.assert_allclose(freq.numpy(), want.double().numpy(), atol=0.02)
    if top_k:
        assert (freq[want == 0] == 0).all()


# ---------------------------------------------------------------------------
# KV pool
# ---------------------------------------------------------------------------

@torch.inference_mode()
def test_kv_pool_slot_reuse_and_isolation(fp32):
    """Evict → insert reuses the freed slot; the other slot's decode stream
    is bit-identical whatever its neighbour holds."""
    _, _, model, params = fp32
    max_len = 32
    prefill = make_pool_prefill(model, max_len)
    step = make_pool_decode_step(model, greedy=True)
    p0, p1, p2 = _prompts(3, s=8)

    def decode_token(pool, tokens):
        nxt, _, _ = step(params, pool.cache, torch.tensor(tokens, dtype=torch.int32),
                         torch.from_numpy(pool.lengths.copy()),
                         torch.from_numpy(pool.active_mask.copy()),
                         torch.zeros(pool.n_slots), torch.zeros(pool.n_slots, dtype=torch.int32),
                         None)
        return nxt.numpy()

    def fill(pool, prompt, slot):
        last, cache1 = prefill(params, torch.from_numpy(prompt[None].copy()))
        pool.insert(cache1, slot, len(prompt))
        return int(torch.argmax(last, -1)[0])

    pool = KVPool(model, 2, max_len, "cpu")
    assert pool.nbytes == 2 * 2 * (2 * max_len * 2 * 16) * 4 + 2 * 2 * 4
    s0, s1 = pool.acquire(), pool.acquire()
    assert (s0, s1) == (0, 1) and pool.n_free == 0
    t0, t1 = fill(pool, p0, s0), fill(pool, p1, s1)
    before = decode_token(pool, [t0, t1])
    assert pool.cache["main"]["index"].tolist() == [[9, 9]] * 2

    pool.evict(s0)
    assert pool.acquire() == s0
    t2 = fill(pool, p2, s0)
    after = decode_token(pool, [t2, t1])
    assert after[1] == before[1]  # isolation: neighbour swap is invisible
    assert pool.lengths[s0] == len(p2)

    solo = KVPool(model, 2, max_len, "cpu")
    fill(solo, p1, 1)
    ref = decode_token(solo, [0, t1])
    assert ref[1] == before[1] and ref[0] == 0  # an idle slot samples 0
    assert solo.cache["main"]["index"][:, 0].tolist() == [0, 0]  # and stays at 0


def test_kv_pool_rejects_oversized_prompt_and_quarantines(fp32):
    _, _, model, _ = fp32
    pool = KVPool(model, 2, 8, "cpu")
    with pytest.raises(ValueError, match="max_len"):
        pool.insert(model.make_cache(1, 8, "cpu"), slot=0, length=9)
    with pytest.raises(ValueError, match="n_slots"):
        KVPool(model, 0, 8, "cpu")
    slot = pool.acquire()
    pool.insert(model.make_cache(1, 8, "cpu"), slot, 3)
    pool.quarantine(slot)
    assert pool.n_free == 1 and pool.lengths[slot] == 0 and pool.acquire() == 1
    assert int(pool.cache["main"]["index"][:, slot].abs().sum()) == 0
    pool.release(slot)
    with pytest.raises(ValueError, match="not quarantined"):
        pool.release(slot)
    assert pool.acquire() == slot


# ---------------------------------------------------------------------------
# scheduler: the JAX suite's scenarios on both packages' classes
# ---------------------------------------------------------------------------

def _z(mod, **kw):
    return mod.ServeRequest(np.zeros(4, np.int32), **kw)


def _fcfs(mod):
    sched = mod.FCFSScheduler(max_prefills_per_step=2)
    for t in (0.3, 0.1, 0.2):
        sched.submit(_z(mod, arrival_s=t))
    a, d = sched.admit(now=1.0, free_slots=3)
    b, _ = sched.admit(now=1.0, free_slots=3)
    return [r.arrival_s for r in a], len(d), [r.arrival_s for r in b], sched.has_pending()


def _deadline(mod):
    sched = mod.FCFSScheduler()
    kept = sched.submit(_z(mod, arrival_s=0.0))
    late = sched.submit(_z(mod, arrival_s=0.0, deadline_s=0.5))
    a, d = sched.admit(now=1.0, free_slots=2)
    return a == [kept], d == [late], late.dropped, late.status.value, late.shed_reason


def _queue_depth(mod):
    sched = mod.FCFSScheduler(max_prefills_per_step=1)
    for t in (0.3, 0.1, 0.2, 5.0):
        sched.submit(_z(mod, arrival_s=t))
    out = [sched.queue_depth(t) for t in (0.0, 0.15, 0.3, 1.0)]
    a, _ = sched.admit(now=1.0, free_slots=4)
    out += [r.arrival_s for r in a] + [sched.queue_depth(1.0)]
    sched.submit(_z(mod, arrival_s=0.05))
    out.append(sched.queue_depth(1.0))
    a, _ = sched.admit(now=1.0, free_slots=4)
    return out + [r.arrival_s for r in a] + [sched.queue_depth(10.0)]


def _arrivals(mod):
    t = mod.poisson_arrivals(16, rate=10.0, seed=0)
    reqs = mod.assign_arrivals([_z(mod) for _ in range(3)], np.array([0.0, 0.5, 1.0]))
    return (t.tolist(), mod.poisson_arrivals(4, rate=0.0).tolist(),
            [r.arrival_s for r in reqs], mod.trace_arrivals([0.5, 0.1]).tolist())


def _sweep_zero_free(mod):
    sched = mod.FCFSScheduler()
    expired = sched.submit(_z(mod, arrival_s=0.0, deadline_s=0.5))
    kept = sched.submit(_z(mod, arrival_s=0.0))
    a, removed = sched.admit(now=1.0, free_slots=0)
    out = [a == [], removed == [expired], expired.status.value, expired.shed_reason,
           sched.queue_depth(1.0), sched.has_pending()]
    a, _ = sched.admit(now=1.0, free_slots=1)
    return out + [a == [kept]]


def _sweep_timeout(mod):
    sched = mod.FCFSScheduler()
    late = sched.submit(_z(mod, arrival_s=0.0, timeout_s=0.4))
    _, removed = sched.admit(now=1.0, free_slots=0)
    return removed == [late], late.status.value, late.dropped


def _bounded(mod):
    sched = mod.FCFSScheduler(max_prefills_per_step=4, max_queue=2)
    reqs = [sched.submit(_z(mod, arrival_s=t)) for t in (0.0, 0.1, 0.2, 0.3)]
    a, removed = sched.admit(now=1.0, free_slots=0)
    out = [a, sorted(r.arrival_s for r in removed),
           [(r.status.value, r.shed_reason) for r in removed]]
    a, _ = sched.admit(now=1.0, free_slots=4)
    return out + [[r.arrival_s for r in a], all(r is reqs[i] for i, r in enumerate(a))]


def _token_budget(mod):
    sched = mod.FCFSScheduler(max_queue_tokens=24)
    reqs = [sched.submit(mod.ServeRequest(np.zeros(8, np.int32), max_new_tokens=4))
            for _ in range(3)]
    _, removed = sched.admit(now=0.0, free_slots=0)
    return mod.request_tokens(reqs[0]), removed == [reqs[2]], reqs[1].status.value


def _drain(mod):
    sched = mod.FCFSScheduler()
    reqs = [sched.submit(_z(mod, arrival_s=t)) for t in (0.0, 5.0)]
    removed = sched.drain(now=1.0)
    return removed == reqs, sched.has_pending(), [(r.status.value, r.shed_reason) for r in reqs]


SCHEDULER_SCENARIOS = {
    "fcfs order and prefill budget": (_fcfs, ([0.1, 0.2], 0, [0.3], False)),
    "deadline drop": (_deadline, (True, True, True, "shed", "deadline")),
    "queue depth counts arrived": (_queue_depth, [0, 1, 3, 3, 0.1, 2, 3, 0.05, 3]),
    "arrival processes": (_arrivals, None),
    "sweep with zero free slots": (_sweep_zero_free,
                                   [True, True, "shed", "deadline", 1, True, True]),
    "sweep times out queued": (_sweep_timeout, (True, "timed_out", True)),
    "bounded queue sheds newest": (_bounded, [[], [0.2, 0.3], [("shed", "queue_full")] * 2,
                                              [0.0, 0.1], True]),
    "queue token budget": (_token_budget, (12, True, "pending")),
    "drain sheds everything": (_drain, (True, False, [("shed", "drain")] * 2)),
}


@pytest.mark.parametrize("name", list(SCHEDULER_SCENARIOS))
def test_scheduler_scenarios_equal_jax(name):
    scenario, want = SCHEDULER_SCENARIOS[name]
    out = scenario(serve)
    assert out == scenario(jax_serve)
    if want is not None:
        assert out == want


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [[], ["--continuous", "--slots", "2", "--arrival-rate", "50"]])
def test_launch_serve_smoke_on_cpu(mode, capsys):
    from repro_torch.launch import serve as launch_serve

    out = launch_serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                             "--requests", "3", "--prompt-len", "6", "--max-new", "4", *mode])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("done: submitted=3 completed=3"), lines
    assert [len(r.out_tokens) for r in out] == [4, 4, 4]


def test_launch_serve_refuses_encoder_and_missing_card():
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(SystemExit, match="encoder-only"):
        launch_serve.main(["--arch", "bert-large", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.main(["--arch", "smollm-360m", "--smoke"])
