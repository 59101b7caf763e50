"""The recurrent families of the port (xLSTM and Jamba) served against the
JAX package at smoke size: prefill then decode and the prefilled state,
both engines' greedy tokens, the slot pool on caches with no ``index``
leaf, and the two launchers with ``--smoke`` on the CPU (one LAMB step:
tests/test_torch_recurrent_step.py).  Weights move by path through the bridge; inputs are made with
numpy; each test states its tolerance (the layers and the forward:
tests/test_torch_recurrent.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro_torch.models import build_model
from repro_torch.nn import cache_from_jax, params_from_jax
from repro_torch.serve import KVPool
from test_torch_recurrent import ARCHS, _model_pair, _np, _pair


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_consistency(arch):
    """prefill(s tokens) then decode(token s) gives the full forward's logits
    at position s (the reference's test of the same name, 2e-3), and the
    prefilled cache equals the JAX package's (2e-4): the recurrent state is
    the whole cache of an xLSTM."""
    jcfg, cfg, jmodel, model, jparams = _model_pair(arch, activation_dtype="float32",
                                                    capacity_factor=8.0)
    params = params_from_jax(jparams)
    s = 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s + 1)).astype(np.int32)
    with torch.inference_mode():
        full, _ = model.apply(params, {"tokens": torch.from_numpy(toks)})
        cache = model.make_cache(2, s + 8, "cpu")
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :-1])}, cache)
        ref_cache = cache_from_jax(jax.tree.map(np.asarray, jmodel.prefill(
            jparams, {"tokens": jnp.asarray(toks[:, :-1])}, jmodel.make_cache(2, s + 8))[1]))
        for seg, leaves in ref_cache.items():
            assert sorted(cache[seg]) == sorted(leaves), seg
            for k, v in leaves.items():
                assert cache[seg][k].shape == v.shape and cache[seg][k].dtype == v.dtype
                np.testing.assert_allclose(_np(cache[seg][k]), _np(v), rtol=2e-4, atol=2e-4,
                                           err_msg=f"{seg}/{k}")
        pos = torch.full((2, 1), s, dtype=torch.int32)
        out, _ = model.decode(params, {"tokens": torch.from_numpy(toks[:, -1:])}, cache, pos)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)
    if arch == "xlstm-350m":
        assert all("index" not in leaves for leaves in cache.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_greedy_tokens_equal_jax(arch):
    """The static and continuous engines over recurrent state: fp32 greedy
    tokens equal the JAX engines' on the same weights, prompts of unequal
    length included (the static engine's right-padding with token 0 flows
    into the state in both packages); capacity raised so no call drops."""
    import repro.serve as jax_serve
    from repro_torch.serve import ContinuousEngine, Engine, Request, ServeRequest

    jcfg, cfg, jmodel, model, jparams = _model_pair(arch, seed=4, activation_dtype="float32",
                                                    capacity_factor=8.0)
    params = params_from_jax(jparams)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (8, 8, 5)]
    ref = jax_serve.Engine(jmodel, jparams, max_len=24).generate_batch(
        [jax_serve.Request(p, max_new_tokens=6) for p in prompts])
    jcont = jax_serve.ContinuousEngine(jmodel, jparams, n_slots=2, max_len=24).generate(
        [jax_serve.ServeRequest(p, max_new_tokens=6) for p in prompts])
    out = Engine(model, params, max_len=24).generate_batch(
        [Request(p, max_new_tokens=6) for p in prompts])
    cont = ContinuousEngine(model, params, n_slots=2, max_len=24).generate(
        [ServeRequest(p, max_new_tokens=6) for p in prompts])
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a.out_tokens, np.asarray(r.out_tokens))
    for b, r in zip(cont, jcont):
        np.testing.assert_array_equal(np.asarray(b.out_tokens), np.asarray(r.out_tokens))
    # the first two prompts are full length: both engines agree there
    for a, b in zip(out[:2], cont[:2]):
        np.testing.assert_array_equal(a.out_tokens, np.asarray(b.out_tokens))


# ---------------------------------------------------------------------------
# the slot pool on recurrent state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_kv_pool_on_recurrent_state(arch):
    """Insert, evict, quarantine and release on caches whose segments have
    no ``index`` (every xLSTM segment, Jamba's Mamba ones): the state leaves
    keep batch on axis 1 and an insert overwrites the slot's state; evict
    zeroes only index leaves; reset-inactive leaves state alone."""
    from repro_torch.serve.kv_pool import reset_inactive

    _, cfg = _pair(arch, activation_dtype="float32")
    model = build_model(cfg)
    pool = KVPool(model, 3, 16, "cpu")
    segs = {seg: "index" in leaves for seg, leaves in pool.cache.items()}
    assert (not any(segs.values())) if arch == "xlstm-350m" else sum(segs.values()) == 1
    single = model.make_cache(1, 16, "cpu")
    for leaves in single.values():
        for k, v in leaves.items():
            v.fill_(7 if k == "index" else 0.5)
    slot = pool.acquire()
    pool.insert(single, slot, 7)
    for seg, leaves in pool.cache.items():
        for k, v in leaves.items():
            col = v[:, slot]
            assert bool((col == (7 if k == "index" else 0.5)).all()), (seg, k)
            others = torch.cat([v[:, :slot], v[:, slot + 1:]], 1)
            assert not bool((others == 0.5).any()), (seg, k)
    before = {(s, k): v.clone() for s, leaves in pool.cache.items() for k, v in leaves.items()}
    reset_inactive(pool.cache, torch.tensor([False, False, False]))
    pool.quarantine(slot)
    assert pool.n_free == 2 and pool.lengths[slot] == 0
    for seg, leaves in pool.cache.items():
        for k, v in leaves.items():
            if k == "index":
                assert not bool(v.any())
            else:
                assert torch.equal(v, before[(seg, k)]), (seg, k)
    pool.release(slot)
    assert pool.n_free == 3
    slot2 = pool.acquire()
    pool.insert(single, slot2, 3)
    pool.evict(slot2)
    assert pool.n_free == 3 and not pool.active_mask.any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", [[], ["--continuous", "--slots", "2", "--arrival-rate", "50"]])
def test_launch_serve_recurrent_smoke_on_cpu(arch, mode, capsys):
    from repro_torch.launch import serve as launch_serve

    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                             "--prompt-len", "6", "--max-new", "4", *mode])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("done: submitted=3 completed=3"), lines
    assert [len(r.out_tokens) for r in out] == [4, 4, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_recurrent_smoke_on_cpu(arch, capsys):
    """``--arch`` xlstm-350m and jamba-1.5-large-398b with ``--smoke``:
    fused LAMB, bf16, accumulation 2, finite losses (Jamba's MoE terms in
    the history); flash on for Jamba's attention layer (K3–K5's plain
    version on the CPU)."""
    from repro_torch.launch import train as launch_train

    flash = ["--flash"] if arch.startswith("jamba") else []
    trainer = launch_train.main(["--arch", arch, "--smoke", "--batch", "4", "--seq", "16",
                                 "--accum-steps", "2", "--precision", "bf16", "--fused-lamb",
                                 "--steps", "2", "--device", "cpu", "--log-every", "1",
                                 *flash])
    out = capsys.readouterr().out
    assert "done: step=2 " in out and "status=ok" in out and "fused_ce=False" in out
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss/total"]) for h in trainer.history)
    if flash:
        assert "flash=True" in out and all("loss/moe_lb" in h for h in trainer.history)
