"""Serving on a mesh of gloo ranks: the static ``Engine(shard_ctx=)`` held to
the port's single-process Engine and to the JAX package's Engine on the same
weights.

The ranks run in subprocesses (tests/_torch_sharded_harness.py, scenario
``serve``) at ``data=2,model=2`` and ``data=1,model=2``, side by side,
while the JAX package serves here.  Five families, each at smoke size with
fp32 activations and the JAX package's initial weights: smollm-smoke
(dense GQA, 3 heads over one kv head: the kv head whole on every ``model``
rank), granite-moe-smoke (GQA with its kv heads split, expert
parallelism, and over two data ranks the MoE's global capacity),
deepseek-smoke (MLA heads over ``model``, the latent cache whole),
jamba-smoke (Mamba's state whole and gathered, attention, MoE) and
xlstm-smoke (the mLSTM's and sLSTM's state by heads).

* Four ragged prompts, six greedy tokens: every rank's tokens equal the
  single process's and the JAX Engine's.
* The prefill's and the first decode step's logits, gathered over
  ``model`` and the data ranks (the greedy tokens teacher-forced), within
  ``LOGITS_TOL`` 1e-5 of their scale (max |logit|, at least 1) of the
  single process's; jamba-smoke's within ``JAMBA_LOGITS_TOL`` 5e-5
  (measured 1.5e-5 here, 2.2e-5 on the port's seed-0 weights, the other
  families at most 3.9e-6).  The cause is the order of the row-parallel
  sums alone, which its attention sub-layer magnifies
  (:func:`test_jamba_parts_from_one_process_by_its_row_sums_alone`).
* A seeded temperature run (0.8) draws the single process's tokens.
* Over two data ranks, smollm-smoke and jamba-smoke at batch 1 under the
  dry-run's rules (the cache's sequence over ``data``, Mamba's state over
  ``inner``): a 7-token prompt in a 16-position cache, so that the decode
  crosses into rank 1's block; the tokens equal the single process's and
  the JAX Engine's.
* Each rank's cache holds its block's bytes (every rank checks its own),
  fewer than the whole cache's where anything of it splits.

The continuous engine, ``ContinuousEngine(shard_ctx=)`` (harness scenario
``continuous``, in the same worlds), every arrival at 0 so that the slots
alone decide the batch's make-up (the MoE couples rows):

* Six requests through four slots (admissions mid-decode), greedy: every
  rank's tokens equal the single-process port engine's (run once, beside
  the data=2,model=2 world) and the JAX ``ContinuousEngine``'s, on both
  meshes and for the five families.
* Over two data ranks: three slots, which the ranks do not divide (every
  rank holds every slot), for granite-moe-smoke, whose MoE couples the
  rows and counts them once over the ranks; and one
  slot under ``cache_seq=("data",)`` for smollm-smoke and jamba-smoke, two
  requests in turn, the first's decode crossing into rank 1's block.  Their
  tokens equal the single process's and the JAX engine's.
* Each rank's pool is its block (every rank checks its own bytes), its
  rows of slots where the data ranks divide them.
* On smollm-smoke at data=2,model=2: a NaN sample, a corrupted slot and a
  stall past the watchdog's SLO together; a stall on rank 1's injector
  alone inside which a request's latency budget ends (rank 0 runs its
  single process first, so the ranks reach ``generate`` seconds apart);
  and rank 1's drain flag alone.  Every rank's statuses, attempts, reasons
  and tokens are alike (every rank checks) and equal the single process's
  under the same faults; rank 0's lifecycle events, without their wall
  times, equal the single process's, and no other rank wrote a log.
* ``collectives.agree_clock`` over the gloo host group equals its plain
  version.

Budget: 240 s on its xdist worker (about 65 s alone, most of it the JAX
engines' compiles; 182 s in a whole run of the suite with six workers on
a loaded host).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
import repro.serve as jax_serve
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.nn import flatten
from repro_torch.sharding import collectives as C
from test_torch_sharded_train import _harness, _report
from _torch_sharded_harness import (
    CONT_B1_LENS,
    CONT_B1_NEW,
    CONT_ROWS_WHOLE,
    CONT_ROWS_WHOLE_ARCHS,
    CONT_SLOTS,
    SERVE_ARCHS,
    SERVE_B1_LEN,
    SERVE_MAX_LEN,
    SERVE_NEW,
    SERVE_SEQ_SPLIT,
    continuous_specs,
    serve_config,
    serve_prompts,
)

LOGITS_TOL = 1e-5
JAMBA_LOGITS_TOL = 5e-5
MESHES = {"data=2,model=2": 4, "data=1,model=2": 2}


def _jax_continuous(jmodel, jparams, specs, slots):
    eng = jax_serve.ContinuousEngine(jmodel, jparams, n_slots=slots, max_len=SERVE_MAX_LEN)
    out = eng.generate([jax_serve.ServeRequest(p, max_new_tokens=n, rid=i)
                        for i, (p, n) in enumerate(specs)])
    return [[int(t) for t in r.out_tokens] for r in out]


def _jax_tokens(jmodel, jparams, prompts):
    out = jax_serve.Engine(jmodel, jparams, max_len=SERVE_MAX_LEN).generate_batch(
        [jax_serve.Request(p, max_new_tokens=SERVE_NEW) for p in prompts])
    return [np.asarray(r.out_tokens).tolist() for r in out]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_mesh")
    init = root / "init"
    init.mkdir()
    models = {}
    for arch in SERVE_ARCHS:
        jcfg = jax_smoke_config(arch).replace(activation_dtype="float32")
        assert jcfg.name == serve_config(arch).name
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        np.savez(init / f"{jcfg.name}.npz",
                 **{k: np.asarray(v, np.float32) for k, v in flatten(jparams).items()})
        models[arch] = (jmodel, jparams)
    procs = {mesh: _harness(world, root / f"w{world}", "--mesh", mesh, "--init", str(init),
                            "serve", "continuous")
             for mesh, world in MESHES.items()}
    jax_out = {}
    for arch, (jmodel, jparams) in models.items():
        cfg = serve_config(arch)
        jax_out[arch] = {"greedy": _jax_tokens(jmodel, jparams, serve_prompts(cfg)),
                         "continuous": _jax_continuous(jmodel, jparams, continuous_specs(cfg),
                                                       CONT_SLOTS)}
        if arch in SERVE_SEQ_SPLIT:
            jax_out[arch]["batch1_seq_split"] = _jax_tokens(
                jmodel, jparams, serve_prompts(cfg, (SERVE_B1_LEN,), seed=1))
            jax_out[arch]["continuous_seq_split"] = _jax_continuous(
                jmodel, jparams, continuous_specs(cfg, CONT_B1_LENS, CONT_B1_NEW, seed=1), 1)
        if arch in CONT_ROWS_WHOLE_ARCHS:
            jax_out[arch]["continuous_rows_whole"] = _jax_continuous(
                jmodel, jparams, continuous_specs(cfg), CONT_ROWS_WHOLE)
    reports = {mesh: _report(proc, root / f"w{MESHES[mesh]}")
               for mesh, proc in procs.items()}
    return reports, jax_out


@pytest.fixture(scope="module")
def served(worlds):
    """The static Engine's reports by mesh, and the JAX package's tokens."""
    return {m: r["serve"] for m, r in worlds[0].items()}, worlds[1]


@pytest.fixture(scope="module")
def continuous(worlds):
    """The continuous engine's reports by mesh, and the JAX package's
    tokens."""
    return {m: r["continuous"] for m, r in worlds[0].items()}, worlds[1]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_tokens_equal_one_process_and_jax(served, arch, mesh):
    reports, jax_out = served
    row = reports[mesh][arch]["greedy"]
    assert row["mesh"] == row["single"] == jax_out[arch]["greedy"]
    assert all(len(t) == SERVE_NEW for t in row["mesh"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_gathered_logits_equal_one_process(served, arch, mesh):
    tol = JAMBA_LOGITS_TOL if arch.startswith("jamba") else LOGITS_TOL
    assert served[0][mesh][arch]["greedy"]["logits_rel"] <= tol


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_seeded_temperature_draws_one_process_tokens(served, arch, mesh):
    row = served[0][mesh][arch]["temperature"]
    assert row["mesh"] == row["single"]
    assert row["mesh"] != served[0][mesh][arch]["greedy"]["mesh"]


@pytest.mark.parametrize("arch", SERVE_SEQ_SPLIT)
def test_batch_one_with_the_cache_sequence_over_data(served, arch):
    reports, jax_out = served
    row = reports["data=2,model=2"][arch]["batch1_seq_split"]
    assert row["mesh"] == row["single"] == jax_out[arch]["batch1_seq_split"]
    assert "batch1_seq_split" not in reports["data=1,model=2"][arch]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_cache_block(served, mesh):
    """Every rank checked its own cache against its block (the harness
    raises otherwise); here the blocks against the whole cache: smaller
    everywhere over two data ranks (the rows, or at batch 1 the sequence,
    split), and over ``model`` alone smaller but where nothing of the
    cache has a split heads or ``inner`` dimension (smollm's one kv head,
    the MLA's latents)."""
    whole_over_model = {"smollm-360m", "deepseek-v3-671b"}
    for arch, entry in served[0][mesh].items():
        for name, row in entry.items():
            if mesh == "data=1,model=2" and arch in whole_over_model:
                assert row["cache_bytes"] == row["whole_cache_bytes"], (arch, name)
            else:
                assert 0 < row["cache_bytes"] < row["whole_cache_bytes"], (arch, name)


def _tokens_of(rows):
    return [r["tokens"] for r in rows]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_continuous_greedy_tokens_equal_one_process_and_jax(continuous, arch, mesh):
    """Both meshes' tokens against the single process (run once, beside
    the data=2,model=2 world) and the JAX engine."""
    row = continuous[0][mesh][arch]["greedy"]
    single = continuous[0]["data=2,model=2"][arch]["greedy"]["single"]
    assert _tokens_of(row["mesh"]) == _tokens_of(single) == continuous[1][arch]["continuous"]
    assert all(r["status"] == "completed" for r in row["mesh"])
    assert ("single" in row) == (mesh == "data=2,model=2")


@pytest.mark.parametrize("arch", CONT_ROWS_WHOLE_ARCHS)
def test_continuous_slots_the_data_ranks_do_not_divide(continuous, arch):
    """Three slots over two data ranks: every rank holds every slot, and the
    tokens are the single process's and the JAX engine's."""
    row = continuous[0]["data=2,model=2"][arch]["rows_whole"]
    assert row["rows"] == [[0, CONT_ROWS_WHOLE]] * 4
    assert _tokens_of(row["mesh"]) == _tokens_of(row["single"]) \
        == continuous[1][arch]["continuous_rows_whole"]


@pytest.mark.parametrize("arch", SERVE_SEQ_SPLIT)
def test_continuous_one_slot_with_the_cache_sequence_over_data(continuous, arch):
    """One slot under ``cache_seq`` over two data ranks: each rank holds its
    half of the positions (half the k/v bytes), and two requests in turn
    serve the single process's and the JAX engine's tokens."""
    row = continuous[0]["data=2,model=2"][arch]["seq_split"]
    assert row["rows"] == [[0, 1]] * 4
    assert row["pool_bytes"] < row["whole_pool_bytes"]
    assert _tokens_of(row["mesh"]) == _tokens_of(row["single"]) \
        == continuous[1][arch]["continuous_seq_split"]
    assert "seq_split" not in continuous[0]["data=1,model=2"][arch]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_continuous_pool_holds_the_ranks_rows(continuous, mesh):
    """Four slots: over two data ranks each rank holds its two rows (data
    rank 0 slots 0-1, data rank 1 slots 2-3), over one every slot; a
    rank's pool is smaller than the whole where anything of it splits (not
    smollm's one kv head nor the MLA's latents over ``model`` alone)."""
    want = ([[0, 2], [0, 2], [2, 2], [2, 2]] if mesh == "data=2,model=2"
            else [[0, CONT_SLOTS]] * 2)
    for arch, entry in continuous[0][mesh].items():
        if arch not in SERVE_ARCHS:
            continue
        row = entry["greedy"]
        assert row["rows"] == want, arch
        if mesh == "data=1,model=2" and arch in ("smollm-360m", "deepseek-v3-671b"):
            assert row["pool_bytes"] == row["whole_pool_bytes"], arch
        else:
            assert 0 < row["pool_bytes"] < row["whole_pool_bytes"], arch


def test_continuous_faults_decide_alike_and_rank_zero_writes(continuous):
    """The NaN sample, the corrupted slot and the stall: the statuses,
    attempts, reasons and tokens of the single process, a retry of each
    fault and the degraded cap on later admissions; rank 0's lifecycle
    events equal the single process's, and rank 0 alone wrote its log."""
    row = continuous[0]["data=2,model=2"]["faults"]
    assert row["mesh"] == row["single"]
    assert [r["attempts"] for r in row["mesh"][1:3]] == [2, 2]
    assert any(len(r["tokens"]) == 2 for r in row["mesh"][3:])
    assert row["events"] == row["single_events"]
    kinds = {e["event"] for e in row["events"]}
    assert {"serve_retry", "serve_quarantine", "serve_degraded", "serve_stats"} <= kinds
    assert row["wrote"] == [True, False, False, False]


def test_continuous_stall_on_one_rank_decides_alike(continuous):
    """A stall on rank 1's injector alone, with the ranks reaching
    ``generate`` apart: request 0's budget ends inside the stall and it
    times out on every rank, as in the single process with that stall."""
    row = continuous[0]["data=2,model=2"]["skewed"]
    assert row["mesh"] == row["single"]
    assert [r["status"] for r in row["mesh"]] == ["timed_out"] + ["completed"] * 3


def test_continuous_drain_flag_on_one_rank_sheds_alike(continuous):
    """Rank 1's drain flag alone: every rank drains at the same iteration
    and sheds the single process's requests."""
    row = continuous[0]["data=2,model=2"]["drain"]
    assert row["mesh"] == row["single"]
    shed = [i for i, r in enumerate(row["mesh"]) if r["status"] == "shed"]
    assert shed and all(row["mesh"][i]["reason"] == "drain" for i in shed)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_agree_clock_on_gloo_equals_its_plain_version(continuous, mesh):
    assert continuous[0][mesh]["agree_clock"] is True


def test_continuous_engine_over_one_rank_serves_as_without_a_context():
    """``ContinuousEngine(shard_ctx=)`` over a mesh of one rank serves the
    tokens it serves without a context, and agrees over no group; over two
    rank threads its ranks serve them too, agreeing once a reading."""
    import torch

    from repro_torch.launch.mesh import Mesh, run_plain_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine, ServeRequest
    from repro_torch.sharding import ShardCtx

    model = build_model(serve_config("smollm-360m"))
    params = model.init(0, torch.device("cpu"))
    prompts = serve_prompts(model.cfg)

    def tokens(ctx):
        eng = ContinuousEngine(model, params, n_slots=2, max_len=SERVE_MAX_LEN, shard_ctx=ctx)
        out = [list(r.out_tokens) for r in eng.generate(
            [ServeRequest(p, max_new_tokens=SERVE_NEW) for p in prompts])]
        return out, eng.agreements

    whole, none = tokens(None)
    assert none == 0
    assert tokens(ShardCtx(Mesh({"data": 1, "model": 1}))) == (whole, 0)
    ranks = run_plain_mesh(lambda mesh: tokens(ShardCtx(mesh)), {"data": 1, "model": 2},
                           timeout=120)
    assert ranks[0][0] == ranks[1][0] == whole
    assert ranks[0][1] == ranks[1][1] > 0


def _split_rows(h, w, tp):
    """``h @ w`` as two ``model`` ranks sum it: each half of the
    contraction in fp32, the halves added in rank order."""
    assert tp is None
    k = h.shape[-1] // 2
    parts = [h[..., :k].float() @ w[:k].float(), h[..., k:].float() @ w[k:].float()]
    return C.reduce_from_model_plain(parts).to(h.dtype)


def test_jamba_parts_from_one_process_by_its_row_sums_alone(monkeypatch):
    """jamba-smoke's fp32 forward (the port's seed-0 weights, 4 prompts of 8
    tokens) over two plain ``model`` ranks against one process.  The ranks'
    logits part from the one process's by 1.7e-5 of their scale.  Sub-layer
    by sub-layer the parting is 6e-7 to 1.9e-6 through the first Mamba,
    MLP, Mamba and MoE sub-layers, then 5.5e-4 at the attention sub-layer,
    whose output reaches 48 (1.1e-5 of it), and 1.7e-5 to 2.9e-5 after it.
    With Mamba's ``x_proj`` products alone summed as the ranks sum them the
    logits' parting is 1.0e-5.  With every row-parallel product (Mamba's
    ``x_proj`` and ``out_proj``, the attention's and the MLPs' output
    projections) so summed, the one process's logits are bit-equal to the
    ranks': the order of those sums is all of the parting.  (The MoE's
    partials add one gate-weighted row each to zeros: exact.)"""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import attention, mamba, mlp
    from repro_torch.sharding import ShardCtx, leaf_layout, specs_for, use_sharding

    cfg = serve_config("jamba-1.5-large-398b")
    model = build_model(cfg)
    params = model.init(0, torch.device("cpu"))
    tokens = torch.from_numpy(make_batch(cfg, np.random.default_rng(0), 4, 8)["tokens"])
    sizes = {"data": 1, "model": 2}
    specs = specs_for(model.defs, Mesh(sizes))

    def rank(group):
        mesh = Mesh(sizes, rank=group.index, groups={("model",): group})
        block = {k: C.shard_block(v, leaf_layout(specs[k], mesh), mesh)
                 for k, v in params.items()}
        with torch.no_grad(), use_sharding(ShardCtx(mesh, param_specs=specs)):
            return model.apply(block, {"tokens": tokens})[0]

    ranks = torch.cat(C.run_plain_ranks(rank, 2), -1)
    with torch.no_grad():
        whole = model.apply(params, {"tokens": tokens})[0]
        scale = max(1.0, float(whole.abs().max()))
        assert 0 < float((ranks - whole).abs().max()) / scale <= JAMBA_LOGITS_TOL
        for module in (mamba, attention, mlp):
            monkeypatch.setattr(module, "row_matmul", _split_rows)
        assert torch.equal(model.apply(params, {"tokens": tokens})[0], ranks)
