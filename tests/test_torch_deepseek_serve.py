"""deepseek-v3 served by the port against the JAX package at smoke size:
prefill then decode over the two MLA cache segments (a scalar and a
per-slot index, naive and absorbed), the cached decode against the full
forward, both engines' greedy tokens, the slot pool over the two segments,
and the launchers with ``--arch deepseek-v3-671b --smoke`` on the CPU.

Tolerances, relative to the reference tensor's scale ``max(1, max|ref|)``:
3e-5 in fp32 (tests/test_torch_serve.py); the JAX suite's 2e-3 for a
cached decode against the full forward (tests/test_arch_smoke.py).  fp32
greedy tokens must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jax_serve
from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.nn import cache_from_jax, params_from_jax
from repro_torch.serve import ContinuousEngine, Engine, KVPool, Request, RequestStatus, \
    ServeRequest
from repro_torch.serve.continuous import make_pool_decode_step, make_pool_prefill
from repro_torch.serve.kv_pool import reset_inactive

ARCH = "deepseek-v3-671b"
TOL = 3e-5
SEGMENTS = ("dense", "main")
LAYERS = {"dense": 1, "main": 2}   # deepseek-smoke: one dense block, two MoE
LEAVES = ("c_kv", "k_rope", "index")


def _close(a, ref, tol=TOL, msg=""):
    a = a.detach().to(torch.float32).numpy() if isinstance(a, torch.Tensor) else a
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(np.asarray(a, np.float32), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=msg)


def _pair(**kw):
    """(jax model, jax params, port model, port params) of fp32
    deepseek-smoke."""
    kw = dict(activation_dtype="float32", use_flash_kernel=False, use_fused_ce_head=False, **kw)
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(**kw))
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, build_model(smoke_config(ARCH).replace(**kw)), \
        params_from_jax(jparams)


@pytest.fixture(scope="module")
def fp32():
    return _pair()


def _prompts(n, s=10, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=s).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("index", ["scalar", "per-slot"])
def test_prefill_then_decode_matches_jax(index, absorb):
    """A prefill of 3 prompts into a cache of 24, then one decode step (a
    scalar index: two tokens at once; a (layers, B) index with an idle slot
    at 0 and a shorter one): the logits, and both segments' latent caches
    and indices, against the reference's."""
    jmodel, jparams, model, params = _pair(mla_absorb=absorb)
    toks = np.stack(_prompts(3, seed=2))
    ref, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, jmodel.make_cache(3, 24))
    with torch.inference_mode():
        cache = model.make_cache(3, 24, "cpu")
        out, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache)
    _close(out, ref, msg="prefill logits")
    assert sorted(cache) == sorted(jcache) == sorted(SEGMENTS)
    for seg in SEGMENTS:
        assert sorted(cache[seg]) == sorted(LEAVES)
        assert cache[seg]["c_kv"].shape == (LAYERS[seg], 3, 24, model.cfg.kv_lora_rank)
        for k in LEAVES:
            _close(cache[seg][k], jcache[seg][k], msg=f"{seg}/{k}")
    jcache = jax.tree.map(np.asarray, jcache)
    if index == "scalar":
        dtoks = np.array([[5, 6], [9, 10], [200, 201]], np.int32)
        pos = np.broadcast_to(np.arange(10, 12, dtype=np.int32), (3, 2)).copy()
    else:
        idx = np.array([10, 0, 7], np.int32)
        for seg in SEGMENTS:
            jcache[seg]["index"] = np.broadcast_to(idx, (LAYERS[seg], 3)).copy()
        dtoks, pos = np.array([[5], [9], [200]], np.int32), idx[:, None].copy()
    cache = cache_from_jax(jcache)
    ref, jnew = jmodel.decode(jparams, {"tokens": jnp.asarray(dtoks)},
                              jax.tree.map(jnp.asarray, jcache), jnp.asarray(pos))
    with torch.inference_mode():
        out, _ = model.decode(params, {"tokens": torch.from_numpy(dtoks)}, cache,
                              torch.from_numpy(pos))
    _close(out, ref, msg="decode logits")
    for seg in SEGMENTS:
        for k in LEAVES:
            _close(cache[seg][k], jnew[seg][k], msg=f"{seg}/{k} after decode")


@pytest.mark.parametrize("absorb", [False, True])
def test_cached_decode_equals_full_forward(absorb):
    """prefill(s tokens) then decode(token s) gives the forward's logits on
    s + 1 tokens, the capacity raised so that no token drops (the port's
    counterpart of test_arch_smoke's prefill-then-decode): 2e-3."""
    _, _, model, params = _pair(mla_absorb=absorb, capacity_factor=8.0)
    toks = torch.from_numpy(np.stack(_prompts(2, s=13, seed=1)))
    with torch.inference_mode():
        full, _ = model.apply(params, {"tokens": toks})
        cache = model.make_cache(2, 20, "cpu")
        model.prefill(params, {"tokens": toks[:, :12]}, cache)
        out, _ = model.decode(params, {"tokens": toks[:, 12:]}, cache,
                              torch.full((2, 1), 12, dtype=torch.int32))
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


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
    for r, ref in zip(out, jax_greedy[1]):
        np.testing.assert_array_equal(np.asarray(r.out_tokens), ref)
        assert r.status is RequestStatus.COMPLETED
    assert eng.pool.n_free == 2   # everything evicted at drain


@torch.inference_mode()
def test_kv_pool_over_the_two_mla_segments(fp32):
    """Insert widens nothing but the slot: both segments' latents land in
    the slot's rows and both indices at the prompt's length; a decode step
    moves both indices of active slots only; evict and reset zero the slot's
    index in both segments and leave the other slot's state alone."""
    _, _, model, params = fp32
    max_len = 24
    prefill = make_pool_prefill(model, max_len)
    step = make_pool_decode_step(model, greedy=True)
    pool = KVPool(model, 2, max_len, "cpu")
    assert sorted(pool.cache) == sorted(SEGMENTS)
    for seg in SEGMENTS:
        assert pool.cache[seg]["index"].shape == (LAYERS[seg], 2)
    p0, p1 = _prompts(2, s=8, seed=4)
    s0, s1 = pool.acquire(), pool.acquire()
    singles = []
    for slot, p in ((s0, p0), (s1, p1[:5])):
        last, c1 = prefill(params, torch.from_numpy(p[None].copy()))
        pool.insert(c1, slot, len(p))
        singles.append(c1)
    for seg in SEGMENTS:
        assert pool.cache[seg]["index"].tolist() == [[8, 5]] * LAYERS[seg]
        for k in ("c_kv", "k_rope"):
            assert torch.equal(pool.cache[seg][k][:, s0], singles[0][seg][k][:, 0])
            assert torch.equal(pool.cache[seg][k][:, s1], singles[1][seg][k][:, 0])
    toks = torch.tensor([3, 4], dtype=torch.int32)
    active = torch.tensor([True, False])
    step(params, pool.cache, toks, torch.tensor([8, 5], dtype=torch.int32), active,
         torch.zeros(2), torch.zeros(2, dtype=torch.int32), None)
    for seg in SEGMENTS:   # the idle slot's index is clamped back to 0
        assert pool.cache[seg]["index"].tolist() == [[9, 0]] * LAYERS[seg]
    before = {seg: pool.cache[seg]["c_kv"][:, s0].clone() for seg in SEGMENTS}
    pool.evict(s1)
    reset_inactive(pool.cache, torch.tensor([True, False]))
    for seg in SEGMENTS:
        assert pool.cache[seg]["index"].tolist() == [[9, 0]] * LAYERS[seg]
        assert torch.equal(pool.cache[seg]["c_kv"][:, s0], before[seg])
    pool.reset()
    assert pool.n_free == 2
    for seg in SEGMENTS:
        assert pool.cache[seg]["index"].tolist() == [[0, 0]] * LAYERS[seg]


def test_launch_train_deepseek_smoke_on_cpu(capsys):
    """``--arch deepseek-v3-671b --smoke`` through the training launcher,
    fused LAMB and the fused CE head (their plain versions on the CPU)."""
    from repro_torch.launch import train as launch_train

    trainer = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
                                 "--seq", "16", "--accum-steps", "2", "--fused-lamb",
                                 "--fused-ce", "--steps", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-smoke" in out and out.splitlines()[-1].startswith("done: step=2")
    assert all(np.isfinite(h["loss/total"]) and "loss/moe_lb" in h for h in trainer.history)


@pytest.mark.parametrize("mode", [[], ["--continuous", "--slots", "2", "--arrival-rate", "50"]])
def test_launch_serve_deepseek_smoke_on_cpu(mode, capsys):
    from repro_torch.launch import serve as launch_serve

    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                             "--prompt-len", "6", "--max-new", "4", *mode])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("done: submitted=3 completed=3"), lines
    assert [len(r.out_tokens) for r in out] == [4, 4, 4]
