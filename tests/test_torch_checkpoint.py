"""The port's checkpoints: the JAX package's on-disk format, crash
consistency, the async checkpointer, the trainer's full-state saves and
resume, and checkpoints crossing between the two packages.

Round trips and cross-package restores are held bit for bit.  One train
step from a crossed checkpoint is held at ``tests/test_torch_train.py``'s
fp32 bounds (loss and update norm to 1e-4 relative; weights to 1e-5 but
for the few whose gradient is small, within 1e-3).
"""
import itertools
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import bert_large as jax_bert
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    checkpoint_step,
    discard_checkpoints_after,
    gc_tmp_dirs,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves_with_paths,
)
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import bert_large
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.nn import train_state_from_jax, train_state_to_numpy
from repro_torch.train import Trainer, make_train_step


@pytest.fixture(autouse=True)
def _reset_fault_hook():
    yield
    ckpt_io.after_leaf_write = None


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_bitwise_equal(a, b):
    la, lb = tree_leaves_with_paths(a), tree_leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape), p
        assert _bits(x) == _bits(y), p


# ---------------------------------------------------------------------------
# round trips over dtypes, shapes and structures
# ---------------------------------------------------------------------------

_DTYPES = ["float32", "bfloat16", "int32"]
_SHAPES = [(), (3,), (2, 4), (1, 2, 3)]   # incl. 0-d scalars


def _leaf(rng, dtype, shape):
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-1000, 1000, size=shape).astype(np.int32))
    x = torch.from_numpy(np.asarray(rng.standard_normal(shape), np.float32))
    return x.to(torch.bfloat16) if dtype == "bfloat16" else x


@pytest.mark.parametrize("dtype,shape", list(itertools.product(_DTYPES, _SHAPES)),
                         ids=lambda v: str(v).replace(" ", ""))
def test_roundtrip_dtype_shape_grid(tmp_path, dtype, shape):
    """Every dtype × shape (bf16 through its uint16 bits) round-trips bit
    for bit, nested one level deep, beside a 0-d leaf."""
    rng = np.random.default_rng(0)
    tree = {"outer": {"leaf": _leaf(rng, dtype, shape)}, "top": _leaf(rng, dtype, ())}
    path = save_checkpoint(str(tmp_path), 7, tree)
    assert checkpoint_step(path) == 7 and latest_checkpoint(str(tmp_path)) == path
    _assert_bitwise_equal(tree, restore_checkpoint(path, tree))


def test_structures_and_numpy_leaves_roundtrip(tmp_path):
    tree = {"w": torch.ones((4, 2), dtype=torch.bfloat16) * 1.5,
            "seq": [torch.arange(3, dtype=torch.int32), (np.float32(2.5) * np.ones(2),)],
            "s/1": np.arange(6, dtype=np.float32).reshape(2, 3)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    restored = restore_checkpoint(path, tree)
    assert isinstance(restored["seq"], list) and isinstance(restored["seq"][1], tuple)
    assert isinstance(restored["s/1"], np.ndarray)
    _assert_bitwise_equal(tree, restored)
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert [e["path"] for e in manifest["leaves"]] == ["s/1", "seq/0", "seq/1/0", "w"]
    assert {e["file"] for e in manifest["leaves"]} >= {"s__1.npy", "seq__1__0.npy"}
    assert np.load(os.path.join(path, "w.npy")).dtype == np.uint16


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.ones(4, 4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(latest_checkpoint(str(tmp_path)), {"w": torch.ones(2, 2)})


def test_restore_dtype_mismatch_raises_unless_cast(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.ones(3)})
    bad = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    path = latest_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(path, bad)
    assert restore_checkpoint(path, bad, cast=True)["w"].dtype == torch.bfloat16


def test_restore_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(latest_checkpoint(str(tmp_path)),
                           {"w": torch.ones(3), "extra": torch.zeros(2)})


# ---------------------------------------------------------------------------
# the LATEST pointer, partial and stale checkpoints
# ---------------------------------------------------------------------------

def test_latest_checkpoint_empty_missing_and_ordered(tmp_path):
    assert latest_checkpoint(str(tmp_path)) is None
    assert latest_checkpoint(str(tmp_path / "nope")) is None
    for step in (1, 2, 10):
        save_checkpoint(str(tmp_path), step, {"w": torch.ones(2)})
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 10
    assert checkpoint_step(latest_checkpoint(str(tmp_path), max_step=5)) == 2


def test_stale_pointer_falls_back_to_newest_complete(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    shutil.rmtree(save_checkpoint(str(tmp_path), 2, {"w": torch.ones(2)}))
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 1


def test_pointer_to_partial_checkpoint_is_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000009")   # no manifest: never complete
    (tmp_path / "LATEST").write_text("step_00000009")
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 1


def test_stale_pointer_with_no_complete_checkpoint(tmp_path):
    (tmp_path / "LATEST").write_text("step_00000004")
    assert latest_checkpoint(str(tmp_path)) is None


def test_discard_checkpoints_after_repoints_latest(tmp_path):
    for step in (2, 4, 6):
        save_checkpoint(str(tmp_path), step, {"w": torch.ones(2)})
    assert sorted(discard_checkpoints_after(str(tmp_path), 3)) == [
        "step_00000004", "step_00000006"]
    assert (tmp_path / "LATEST").read_text() == "step_00000002"
    discard_checkpoints_after(str(tmp_path), 0)
    assert not (tmp_path / "LATEST").exists()


# ---------------------------------------------------------------------------
# crash consistency: failures injected into the save path
# ---------------------------------------------------------------------------

def test_np_save_failure_keeps_previous_checkpoint(tmp_path, monkeypatch):
    tree = {"w": torch.ones(2), "b": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 1, tree)
    real_save, calls = np.save, {"n": 0}

    def flaky_save(path, arr, **kw):
        if calls["n"] >= 1:
            raise OSError("disk full")
        calls["n"] += 1
        return real_save(path, arr, **kw)

    monkeypatch.setattr(np, "save", flaky_save)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(str(tmp_path), 2, tree)
    monkeypatch.undo()
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 1
    assert not any(n.startswith(".tmp_ckpt_") for n in os.listdir(tmp_path))


def test_rename_failure_keeps_previous_checkpoint(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})

    def bad_rename(src, dst):
        raise OSError("rename EIO")

    monkeypatch.setattr(ckpt_io.os, "rename", bad_rename)
    with pytest.raises(OSError, match="rename"):
        save_checkpoint(str(tmp_path), 2, {"w": torch.ones(2)})
    monkeypatch.undo()
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 1
    assert not any(n.startswith(".tmp_ckpt_") for n in os.listdir(tmp_path))


class _HardCrash(BaseException):
    """Not an Exception: skips the save's cleanup, like a SIGKILL."""


def test_mid_save_hard_crash_then_gc_on_next_save(tmp_path):
    tree = {"w": torch.ones(2), "b": torch.zeros(3)}
    save_checkpoint(str(tmp_path), 1, tree)

    def die_after_first_leaf(i, _tmp):
        if i == 0:
            raise _HardCrash

    ckpt_io.after_leaf_write = die_after_first_leaf
    with pytest.raises(_HardCrash):
        save_checkpoint(str(tmp_path), 2, tree)
    ckpt_io.after_leaf_write = None
    assert any(n.startswith(".tmp_ckpt_") for n in os.listdir(tmp_path))
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 1
    save_checkpoint(str(tmp_path), 3, tree)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_ckpt_")]
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 3


def test_gc_tmp_dirs_removes_manual_debris(tmp_path):
    os.makedirs(tmp_path / ".tmp_ckpt_dead")
    (tmp_path / ".tmp_latest_dead").write_text("x")
    (tmp_path / "keep.txt").write_text("x")
    assert sorted(gc_tmp_dirs(str(tmp_path))) == [".tmp_ckpt_dead", ".tmp_latest_dead"]
    assert (tmp_path / "keep.txt").exists()


def test_latest_pointer_written_atomically(tmp_path, monkeypatch):
    renames, real_rename = [], os.rename

    def spy_rename(src, dst):
        renames.append((os.path.basename(src), os.path.basename(dst)))
        return real_rename(src, dst)

    monkeypatch.setattr(ckpt_io.os, "rename", spy_rename)
    save_checkpoint(str(tmp_path), 5, {"w": torch.ones(2)})
    assert any(s.startswith(".tmp_latest_") and d == "LATEST" for s, d in renames), renames


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------

def _tiny_state():
    return {"params": {"w": torch.ones(8, 4) * 2.0}, "mu": {"w": torch.zeros(8, 4)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _slow_np_save(monkeypatch, seconds):
    real_save = np.save

    def slow_save(path, arr, **kw):
        time.sleep(seconds)
        return real_save(path, arr, **kw)

    monkeypatch.setattr(np, "save", slow_save)


def test_async_save_roundtrip_snapshot_and_latest_persisted(tmp_path):
    """The snapshot is taken at ``save``: changing the state in place
    afterwards (as the next step does) does not reach the checkpoint."""
    state = _tiny_state()
    with AsyncCheckpointer(str(tmp_path)) as ck:
        assert ck.latest_persisted_step() is None
        ck.save(3, state)
        expect = {k: {kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                  else v.clone() for k, v in state.items()}
        state["params"]["w"].add_(1.0)
        path = ck.wait()
        assert ck.latest_persisted_step() == 3
    _assert_bitwise_equal(expect, restore_checkpoint(path, expect))


def test_async_write_overlaps_caller(tmp_path, monkeypatch):
    _slow_np_save(monkeypatch, 0.15)   # 3 leaves: >= 0.45 s of "disk" time
    with AsyncCheckpointer(str(tmp_path)) as ck:
        t0 = time.perf_counter()
        ck.save(3, _tiny_state())
        assert time.perf_counter() - t0 < 0.4
        assert ck.latest_persisted_step() is None   # not durable yet
        ck.wait()
        assert ck.latest_persisted_step() == 3
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 3


def test_async_at_most_one_write_in_flight(tmp_path, monkeypatch):
    """A second save snapshots into the other host buffer, then waits out
    the first write (``blocked_s``); writes publish in order."""
    _slow_np_save(monkeypatch, 0.05)
    with AsyncCheckpointer(str(tmp_path)) as ck:
        ck.save(1, _tiny_state())
        ck.save(2, _tiny_state())
        ck.wait()
        ck.save(3, _tiny_state())   # back in the first buffer
        ck.wait()
        assert len({id(b["params/w"]) for b in ck._buffers}) == 2
    assert [t["step"] for t in ck.timings] == [1, 2, 3]
    for key in ("snapshot_s", "blocked_s", "copy_s", "copy_wait_s", "write_s"):
        assert all(key in t for t in ck.timings)
    assert ck.timings[1]["blocked_s"] > 0.0
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 3


def test_async_background_failure_surfaces_on_wait(tmp_path, monkeypatch):
    def bad_save(path, arr, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(np, "save", bad_save)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, _tiny_state())
    with pytest.raises(OSError, match="disk gone"):
        ck.wait()
    monkeypatch.undo()
    assert ck.latest_persisted_step() is None and latest_checkpoint(str(tmp_path)) is None
    ck.close()


def test_async_resumes_latest_persisted_from_disk(tmp_path):
    save_checkpoint(str(tmp_path), 4, {"w": torch.ones(2)})
    ck = AsyncCheckpointer(str(tmp_path))
    assert ck.latest_persisted_step() == 4
    ck.close()


# ---------------------------------------------------------------------------
# Trainer: full-state saves and resume
# ---------------------------------------------------------------------------

def _trainer(ckpt_dir=None, **kw):
    tc = TrainConfig(optimizer="lamb", use_fused_lamb=True, learning_rate=1e-3,
                     skip_nonfinite=True)
    return Trainer(build_model(bert_large.smoke()), tc, device="cpu",
                   checkpoint_dir=ckpt_dir, log_every=1, log_fn=lambda s: None, **kw)


def _data(seed=0):
    return DataPipeline(bert_large.smoke(), 8, 16, device="cpu", seed=seed)


def test_trainer_saves_full_train_state(tmp_path):
    tr = _trainer(str(tmp_path), checkpoint_every=2)
    tr.fit(_data(), 2)
    path = latest_checkpoint(str(tmp_path))
    paths = [e["path"] for e in json.loads(open(os.path.join(path, "manifest.json")).read())[
        "leaves"]]
    assert paths == list(train_state_to_numpy(tr.state))
    assert checkpoint_step(path) == 2
    for k, v in train_state_to_numpy(tr.state).items():
        assert np.load(os.path.join(path, k.replace("/", "__") + ".npy")).tobytes() \
            == v.tobytes(), k


@pytest.mark.parametrize("use_async", [False, True])
def test_trainer_resume_continues_bit_exact(tmp_path, use_async):
    ref = _trainer()
    ref.fit(_data(), 5)
    tr1 = _trainer(str(tmp_path), checkpoint_every=3, async_checkpoint=use_async)
    tr1.fit(_data(), 3)
    tr2 = _trainer(str(tmp_path), checkpoint_every=3, async_checkpoint=use_async,
                   resume=True)
    tr2.fit(_data(), 5)

    def rows(tr, after):
        return [{k: v for k, v in r.items() if k != "wall_s"}
                for r in tr.history if r["step"] > after]

    assert rows(tr2, 3) == rows(ref, 3)
    assert tr2.examples_seen == ref.examples_seen
    assert int(tr2.state.step) == 5
    a, b = train_state_to_numpy(tr2.state), train_state_to_numpy(ref.state)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_trainer_resume_with_no_checkpoint_starts_fresh(tmp_path):
    tr = _trainer(str(tmp_path), checkpoint_every=0, resume=True)
    tr.fit(_data(), 2)
    assert int(tr.state.step) == 2


def test_trainer_resume_past_target_runs_nothing(tmp_path):
    _trainer(str(tmp_path), checkpoint_every=2).fit(_data(), 4)
    tr2 = _trainer(str(tmp_path), checkpoint_every=2, resume=True)
    tr2.fit(_data(), 3)
    assert tr2.history == [] and int(tr2.state.step) == 4


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

OFF = dict(use_flash_kernel=False, use_fused_ce_head=False, activation_dtype="float32")


def _pair():
    """JAX's and the port's fused-LAMB train steps on bert-smoke, a batch,
    and each package's initial state (the port's made by its own init)."""
    kw = dict(optimizer="lamb", use_fused_lamb=True, learning_rate=0.01)
    jinit, jstep = jax_make_train_step(jax_build_model(jax_bert.smoke().replace(**OFF)),
                                       JaxTrainConfig(**kw))
    init, step = make_train_step(build_model(bert_large.smoke().replace(**OFF)),
                                 TrainConfig(**kw))
    batch = next(jax_synthetic.batch_iterator(jax_bert.smoke(), 8, 32, seed=1))
    jstate = jax.jit(jinit)(jax.random.key(0))
    return (jinit, jax.jit(jstep), jstate), (step, init(0, "cpu")), batch


def _step_both(jstep, jstate, step, state, batch):
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss/total", "update_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    for k, v in train_state_to_numpy(train_state_from_jax(jstate)).items():
        if k.startswith("params/"):
            diff = np.abs(train_state_to_numpy(state)[k] - v)
            assert (diff > 1e-5).mean() < 1e-3 and diff.max() < 1e-3, k
    assert int(state.step) == int(jstate.step)


def test_jax_written_train_state_restores_in_the_port(tmp_path):
    (_, jstep, jstate), (step, state), batch = _pair()
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    path = jax_save_checkpoint(str(tmp_path), 1, jstate)
    restored = restore_checkpoint(path, state)
    port = train_state_to_numpy(restored)
    ref = train_state_to_numpy(train_state_from_jax(jstate))
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].tobytes() == ref[k].tobytes(), k
    assert int(restored.step) == 1 and int(restored.opt_state.count) == 1
    _step_both(jstep, jstate, step, restored, batch)


def test_port_written_train_state_restores_in_jax(tmp_path):
    (jinit, jstep, _), (step, state), batch = _pair()
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    path = save_checkpoint(str(tmp_path), 1, state)
    jrestored = jax_restore_checkpoint(path, jax.eval_shape(jinit, jax.random.key(0)))
    ref = train_state_to_numpy(state)
    got = train_state_to_numpy(train_state_from_jax(jrestored))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].tobytes() == ref[k].tobytes(), k
    _step_both(jstep, jax.tree.map(jnp.asarray, jrestored), step, state, batch)


def test_bf16_leaves_cross_between_the_packages(tmp_path):
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x, jnp.bfloat16)
    port_path = save_checkpoint(str(tmp_path / "port"), 1, {"w": tx, "s": tx[0, 0]})
    back = jax_restore_checkpoint(port_path, {"w": jax.ShapeDtypeStruct((3, 5), jnp.bfloat16),
                                              "s": jax.ShapeDtypeStruct((), jnp.bfloat16)})
    assert np.asarray(back["w"]).tobytes() == np.asarray(jx).tobytes()
    jax_path = jax_save_checkpoint(str(tmp_path / "jax"), 1, {"w": jx})
    got = restore_checkpoint(jax_path, {"w": torch.zeros((3, 5), dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and _bits(got["w"]) == _bits(tx)
