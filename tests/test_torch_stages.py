"""The §4.1 two-stage recipe: the port's ``Trainer.fit_stages`` against the
JAX package's on bert-smoke, from the same weights and the same data (both
``DataPipeline``s give the same bytes from the same seed), and the port's
``--mixed-batch`` launcher.

Bounds: ``tests/test_torch_train.py``'s fp32 bounds (loss and update norm to
1e-4 relative, grad norm to 1e-3; weights to 1e-5 but for the few whose
gradient is small, which LAMB's scale-free direction leaves within 1e-3).
Counters are exact: ``count`` carries over the stage switch, ``sched_count``
restarts at 0 (on a transform chain: every ``ScheduleState.count`` restarts,
the ``ScaleByAdamState`` count carries over).  The base learning rate is
0.002: bert-smoke's attention is saturated at init (ROADMAP.md queue 3), so
over six steps at 0.01 the two frameworks' fp32 rounding of the gradients
grows past these bounds (grad norms 0.75% apart by step 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import mixed_batch as jax_mixed
from repro.models import build_model as jax_build_model
from repro.train import Trainer as JaxTrainer
from repro.train.step import make_optimizer as jax_make_optimizer
from repro.train.trainer import _reset_schedule_counts as jax_reset_schedule_counts
from repro_torch.checkpoint import tree_leaves_with_paths
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.core import make_stage
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax, state_from_jax, train_state_from_jax
from repro_torch.train import Trainer
from repro_torch.train.trainer import _reset_schedule_counts

OFF = dict(use_flash_kernel=False, use_fused_ce_head=False, activation_dtype="float32")
# (name, seq, batch, steps): stage 2 at 2 × seq with half the batch; base
# batch 8 and warmup ratio 1 give stage 1 three warmup steps and stage 2
# two, each starting at lr 0
PLAN = [("stage1", 32, 8, 3), ("stage2_rewarmup", 64, 4, 3)]
BASE = dict(base_lr=0.002, base_batch=8, base_warmup_ratio=1.0)


def _run_both(optimizer="lamb", use_fused_lamb=True):
    kw = dict(optimizer=optimizer, use_fused_lamb=use_fused_lamb, accum_steps=2)
    jtr = JaxTrainer(jax_build_model(jax_bert.smoke().replace(**OFF)),
                     JaxTrainConfig(**kw), log_every=1, log_fn=lambda s: None)
    jtr.init()
    tr = Trainer(build_model(bert_large.smoke().replace(**OFF)), TrainConfig(**kw),
                 device="cpu", log_every=1, log_fn=lambda s: None)
    tr.state = train_state_from_jax(jtr.state)
    jtr.fit_stages([jax_mixed.make_stage(*s, **BASE) for s in PLAN], data_seed=3)
    tr.fit_stages([make_stage(*s, **BASE) for s in PLAN], data_seed=3)
    return tr, jtr


@pytest.fixture(scope="module")
def runs():
    return _run_both()


def test_two_stage_history_matches_jax(runs):
    tr, jtr = runs
    assert len(tr.history) == len(jtr.history) == 6
    for row, ref in zip(tr.history, jtr.history):
        assert (row["step"], row["stage"], row["examples_seen"]) == \
            (ref["step"], ref["stage"], ref["examples_seen"])
        for k in ("loss/total", "loss/ce", "update_norm", "tokens/supervised"):
            np.testing.assert_allclose(row[k], ref[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(row["grad_norm"], ref["grad_norm"], rtol=1e-3)
    # the re-warm-up: stage 2's first step has lr 0 again, because
    # sched_count restarted while count carried on
    assert [r["update_norm"] == 0.0 for r in tr.history] == \
        [True, False, False, True, False, False]
    walls = [r["wall_s"] for r in tr.history]
    assert walls == sorted(walls)   # one clock across the stages


def test_two_stage_counters_and_weights_match_jax(runs):
    tr, jtr = runs
    o, jo = tr.state.opt_state, state_from_jax(jtr.state.opt_state)
    assert int(o.count) == int(jo.count) == 6
    assert int(o.sched_count) == int(jo.sched_count) == 3
    assert int(tr.state.step) == int(jtr.state.step) == 6
    assert int(tr.state.skipped) == int(jtr.state.skipped) == 0
    assert tr.examples_seen == jtr.examples_seen == 3 * 8 + 3 * 4
    for k, v in params_from_jax(jtr.state.params).items():
        diff = (tr.state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


@pytest.fixture(scope="module")
def lans_runs():
    return _run_both("lans", use_fused_lamb=False)


def test_two_stage_lans_chain_matches_jax(lans_runs):
    """The two stages on LANS's transform chain: history at the bounds
    above, the schedule's ``ScheduleState.count`` restarted at the switch
    (3) while ``ScaleByAdamState.count`` carried over (6), as in JAX."""
    tr, jtr = lans_runs
    for row, ref in zip(tr.history, jtr.history):
        assert (row["step"], row["stage"]) == (ref["step"], ref["stage"])
        for k in ("loss/total", "update_norm"):
            np.testing.assert_allclose(row[k], ref[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(row["grad_norm"], ref["grad_norm"], rtol=1e-3)
    assert [r["update_norm"] == 0.0 for r in tr.history] == \
        [True, False, False, True, False, False]
    o, jo = tr.state.opt_state, state_from_jax(jtr.state.opt_state)
    assert [p for p, _ in tree_leaves_with_paths(o)] == [p for p, _ in tree_leaves_with_paths(jo)]
    assert int(o[1].count) == int(jo[1].count) == 6
    assert int(o[2].count) == int(jo[2].count) == 3
    for k, v in params_from_jax(jtr.state.params).items():
        diff = (tr.state.params[k] - v).abs()
        assert float((diff > 1e-5).float().mean()) < 1e-3, k
        assert float(diff.max()) < 1e-3, k


@pytest.mark.parametrize("optimizer", ["lamb", "lans", "lars", "nlamb", "adamw", "adagrad",
                                       "momentum"])
def test_reset_schedule_counts_of_a_chain_matches_jax(optimizer):
    """The stage switch's reset on each optimizer's chain state, against
    JAX's ``_reset_schedule_counts`` from the same state (every counter at
    5): every leaf bit for bit, schedule counters 0, moment counters 5."""
    jmodel = jax_build_model(jax_bert.smoke().replace(**OFF))
    jopt = jax_make_optimizer(jmodel, JaxTrainConfig(optimizer=optimizer))
    jstate = jax.tree.map(lambda x: jnp.full_like(x, 5) if x.dtype == jnp.int32 else x,
                          jopt.init(jmodel.init(jax.random.key(0))))
    state = state_from_jax(jstate)
    _reset_schedule_counts(state)
    got = tree_leaves_with_paths(state)
    want = tree_leaves_with_paths(state_from_jax(jax_reset_schedule_counts(jstate)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), p
    counts = {p: int(v) for p, v in got if v.dtype == torch.int32}
    assert 0 in counts.values()
    assert (5 in counts.values()) == (optimizer not in ("lars", "adagrad", "momentum"))


def test_mixed_batch_launcher_runs_two_stages(capsys):
    argv = ["--arch", "bert-large", "--smoke", "--batch", "8", "--seq", "16",
            "--accum-steps", "2", "--fused-lamb", "--steps", "5", "--mixed-batch",
            "--skip-nonfinite", "--device", "cpu", "--log-every", "1"]
    trainer = launch_train.main(argv)
    out = capsys.readouterr().out
    assert "done: step=5 " in out and "status=ok" in out
    assert "stage 1: stage2_rewarmup seq=64 batch=2 steps=1" in out
    assert [h["stage"] for h in trainer.history] == [0, 0, 0, 0, 1]
    assert all(np.isfinite(h["loss/total"]) and h["nonfinite/skip"] == 0.0
               for h in trainer.history)
    o = trainer.state.opt_state
    assert (int(o.count), int(o.sched_count), int(trainer.state.step)) == (5, 1, 5)


def test_mixed_batch_launcher_checks_every_stage_batch():
    argv = ["--arch", "bert-large", "--smoke", "--batch", "8", "--seq", "16",
            "--accum-steps", "4", "--fused-lamb", "--steps", "5", "--mixed-batch",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="stage 'stage2_rewarmup' batch 2"):
        launch_train.main(argv)
