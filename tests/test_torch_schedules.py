"""The port's schedules, scaling rules and mixed-batch plan against
``repro.core`` on the same steps.

Both sides compute in fp32 from the same int32 steps; the formulas are the
same but the two libraries may round a division or a power differently, so
values agree to 1e-6 relative (plus 1e-12 absolute for values at 0).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import mixed_batch as jmixed
from repro_torch import core
from repro_torch.core import mixed_batch

STEPS = np.array([0, 1, 2, 3, 7, 10, 49, 50, 51, 99, 100, 101, 150, 1000, 7038, 8599, 20000],
                 np.int32)
TOL = dict(rtol=1e-6, atol=1e-12)


def _both(port_sched, jax_sched):
    port = port_sched(torch.from_numpy(STEPS)).numpy()
    ref = np.asarray(jax_sched(jnp.asarray(STEPS)))
    return np.broadcast_to(port, STEPS.shape), np.broadcast_to(ref, STEPS.shape)


def _stage_pieces(mod):
    return ([mod.warmup_poly_decay(0.01, 50, 5), mod.linear_warmup(0.002, 10),
             mod.constant(3e-4)], [50, 30, 20])


SCHEDULES = {
    "constant": lambda m: m.constant(4e-3),
    "polynomial_decay": lambda m: m.polynomial_decay(0.01, 100, power=2.0, end_lr=1e-4),
    "linear_warmup": lambda m: m.linear_warmup(0.01, 50),
    "linear_warmup, none": lambda m: m.linear_warmup(0.01, 0),
    "warmup_poly_decay": lambda m: m.warmup_poly_decay(0.01, 100, 10),
    "warmup_poly_decay, no warmup": lambda m: m.warmup_poly_decay(0.01, 100, 0),
    "untuned_lamb_schedule": lambda m: m.untuned_lamb_schedule(32768, 150)[0],
    "piecewise_stage_schedule": lambda m: m.piecewise_stage_schedule(*_stage_pieces(m)),
    "goyal_step_schedule": lambda m: m.goyal_step_schedule(0.1, 1, warmup_epochs=5.0,
                                                           milestones=(30, 60, 80)),
    "adam_correction_equivalent_lr": lambda m: m.adam_correction_equivalent_lr,
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    port, ref = _both(SCHEDULES[name](core), SCHEDULES[name](jcore))
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, ref, **TOL)


@pytest.mark.parametrize("name", ["warmup_poly_decay", "constant", "goyal_step_schedule"])
def test_schedule_stays_on_the_steps_device(name):
    out = SCHEDULES[name](core)(torch.tensor(3, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.device.type == "cpu" and out.dim() == 0


@pytest.mark.parametrize("batch", [512, 1024, 4096, 32768, 65536])
def test_scaling_rules_match_jax(batch):
    assert core.sqrt_scaled_lr(5e-3 / 8, 512, batch) == jcore.sqrt_scaled_lr(5e-3 / 8, 512, batch)
    assert core.linear_epoch_warmup_ratio(1 / 320, 512, batch) == \
        jcore.linear_epoch_warmup_ratio(1 / 320, 512, batch)
    _, info = core.untuned_lamb_schedule(batch, 1000)
    _, jinfo = jcore.untuned_lamb_schedule(batch, 1000)
    assert info == jinfo


def _fields(stage):
    return {f.name: getattr(stage, f.name) for f in dataclasses.fields(stage)
            if f.name != "schedule"}


def _same_stages(port, ref):
    assert len(port) == len(ref)
    for s, r in zip(port, ref):
        assert _fields(s) == _fields(r)
        np.testing.assert_allclose(*_both(s.schedule, r.schedule), **TOL)


@pytest.mark.parametrize("args", [
    ("stage1", 128, 64, 4), ("stage2_rewarmup", 512, 16, 2), ("big", 128, 65536, 7038),
])
def test_make_stage_matches_jax(args):
    kw = dict(base_lr=2.5e-3, base_batch=16, base_warmup_ratio=1 / 40)
    _same_stages([mixed_batch.make_stage(*args, **kw), mixed_batch.make_stage(*args)],
                 [jmixed.make_stage(*args, **kw), jmixed.make_stage(*args)])


def test_bert_mixed_batch_plan_matches_jax():
    _same_stages(mixed_batch.bert_mixed_batch_plan(), jmixed.bert_mixed_batch_plan())
    kw = dict(batch1=1024, batch2=256, steps1=40, steps2=10, base_lr=1e-3, base_batch=64)
    _same_stages(mixed_batch.bert_mixed_batch_plan(**kw), jmixed.bert_mixed_batch_plan(**kw))


def test_scaled_plan_matches_jax_with_the_reference_defaults():
    """``scaled_plan`` remakes each stage with ``make_stage``'s default base
    lr, batch and warmup ratio, as the reference does, not the plan's."""
    kw = dict(base_lr=1e-3, base_batch=64, base_warmup_ratio=1 / 10)
    port = mixed_batch.scaled_plan(mixed_batch.bert_mixed_batch_plan(**kw),
                                   batch_divisor=1024, step_divisor=100)
    ref = jmixed.scaled_plan(jmixed.bert_mixed_batch_plan(**kw),
                             batch_divisor=1024, step_divisor=100)
    _same_stages(port, ref)
    assert port[0].learning_rate == mixed_batch.make_stage("x", 128, 64, 70).learning_rate
