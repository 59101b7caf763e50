"""Checkpointing in the JAX package's on-disk format (port of
``repro.checkpoint.io``): a directory of ``.npy`` leaves and a JSON manifest.

A tree (nested dicts, lists, tuples and dataclasses such as ``TrainState``,
with tensors, numpy arrays or Python numbers as leaves) is written one
``.npy`` per leaf, named by its path (``"opt_state/mu/blocks/attn/wq"``, the
reference's ``path_str`` of the same leaf) with ``/`` turned into ``__``,
plus a ``manifest.json`` of ``{path, file, dtype, shape}``.  bf16 is stored
as its ``uint16`` bits with ``"bfloat16"`` in the manifest, as the reference
stores it, and read back by a view: no ``ml_dtypes`` needed.  So a
checkpoint written by either package restores in the other.

Crash consistency, as in the reference:

* a checkpoint directory becomes visible only via ``os.rename`` of a fully
  written tmp dir, so ``step_*`` either has a complete manifest or does not
  exist;
* the ``LATEST`` pointer is written tmp-file-then-rename, never torn;
* ``latest_checkpoint`` trusts the pointer only if it names a complete
  checkpoint, else takes the newest complete ``step_*`` dir;
* stray ``.tmp_ckpt_*`` / ``.tmp_latest_*`` debris from a killed writer is
  removed at the start of the next save.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

# Test-only fault-injection hook: when set, called as ``hook(i, tmp_dir)``
# after the i-th leaf file of a checkpoint is written (before the atomic
# rename).  Tests raise from it to simulate a write failure.  Never set in
# production.
after_leaf_write: Optional[Callable[[int, str], None]] = None

_TMP_PREFIXES = (".tmp_ckpt_", ".tmp_latest_")

Leaf = Union[torch.Tensor, np.ndarray, int, float]


# ---------------------------------------------------------------------------
# trees: leaves by path, and rebuilding a tree from its leaves
# ---------------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(key, child)]`` of a container in the reference's leaf order
    (dict keys sorted, sequences by index, dataclass fields in order), or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def tree_leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Leaf]]:
    """``[(path, leaf)]`` in the reference's order, paths as ``"a/b/0/c"``."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Leaf]] = []
    for key, child in kids:
        out += tree_leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def tree_map_with_paths(fn: Callable[[str, Leaf], Any], tree: Any, prefix: str = "") -> Any:
    """A tree of the same structure with each leaf replaced by ``fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = {key: tree_map_with_paths(fn, child, f"{prefix}/{key}" if prefix else key)
           for key, child in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **new)


# ---------------------------------------------------------------------------
# leaves on disk
# ---------------------------------------------------------------------------

def _sanitize(path: str) -> str:
    return path.replace("/", "__")


def _dtype_name(dtype) -> str:
    """Manifest name of a torch or numpy dtype (``"float32"``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def to_savable(leaf: Leaf) -> Tuple[np.ndarray, str]:
    """``(array np.save can write, manifest dtype)`` for a host leaf.

    bf16 (a torch tensor, or a numpy extension dtype of kind ``'V'``) goes
    as its ``uint16`` bits, as the reference writes it.
    """
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(leaf)
    dtype = str(arr.dtype)
    if arr.dtype.kind == "V":   # ml_dtypes extension type (bf16, fp8, ...)
        arr = arr.view(np.dtype(f"uint{arr.dtype.itemsize * 8}"))
    return arr, dtype


def _contiguous(arr: np.ndarray) -> np.ndarray:
    """``arr`` in C order, keeping 0-d arrays 0-d (``ascontiguousarray`` does not)."""
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _load_leaf(arr: np.ndarray, dtype: str) -> Union[torch.Tensor, np.ndarray]:
    """The stored array with its manifest dtype: a torch tensor for bf16
    (from its uint16 bits), else the numpy array viewed as ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(_contiguous(arr).view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return arr


def gc_tmp_dirs(directory: str) -> List[str]:
    """Remove stray ``.tmp_ckpt_*`` dirs / ``.tmp_latest_*`` files left by a
    crashed writer.  Called at the start of every save; safe because at most
    one save is ever in flight per directory."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for name in os.listdir(directory):
        if not name.startswith(_TMP_PREFIXES):
            continue
        path = os.path.join(directory, name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.remove(path)
            except OSError:
                continue
        removed.append(name)
    return removed


def _write_latest(directory: str, name: str) -> None:
    """Atomically point LATEST at ``name`` (tmp file + rename, never torn)."""
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_latest_")
    with os.fdopen(fd, "w") as f:
        f.write(name)
    os.rename(tmp, os.path.join(directory, "LATEST"))


def write_checkpoint_dir(directory: str, step: int, leaves: List[Tuple[str, Leaf]]) -> str:
    """Atomically publish host-side ``(path, leaf)`` pairs as ``step_<N>``.

    The write path shared by :func:`save_checkpoint` and the background
    thread of :class:`~repro_torch.checkpoint.async_io.AsyncCheckpointer`;
    the caller owns getting the leaves to the host.
    """
    os.makedirs(directory, exist_ok=True)
    gc_tmp_dirs(directory)
    final = checkpoint_path(directory, step)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(leaves):
            fname = _sanitize(path) + ".npy"
            savable, dtype = to_savable(leaf)
            np.save(os.path.join(tmp, fname), savable)
            if after_leaf_write is not None:
                after_leaf_write(i, tmp)
            manifest["leaves"].append(
                {"path": path, "file": fname, "dtype": dtype, "shape": list(savable.shape)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _write_latest(directory, os.path.basename(final))
    return final


def checkpoint_path(directory: str, step: int) -> str:
    """The path of step ``step``'s checkpoint under ``directory``."""
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` under ``directory/step_<N>/`` atomically; returns the path.

    Device tensors are copied to the host here, one leaf at a time.
    """
    return write_checkpoint_dir(directory, step, tree_leaves_with_paths(tree))


def _is_complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "manifest.json"))


def _step_of(name: str) -> Optional[int]:
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def latest_checkpoint(directory: str, max_step: Optional[int] = None) -> Optional[str]:
    """Path of the newest *complete* checkpoint, or None.

    The LATEST pointer is authoritative when it names a complete checkpoint;
    otherwise the newest ``step_*`` dir that has a manifest.  ``max_step``
    bounds the search to ``step <= max_step`` (and skips the pointer).
    """
    if not os.path.isdir(directory):
        return None
    if max_step is None:
        pointer = os.path.join(directory, "LATEST")
        if os.path.exists(pointer):
            with open(pointer) as f:
                name = f.read().strip()
            path = os.path.join(directory, name)
            if os.path.isdir(path) and _is_complete(path):
                return path
    for name in sorted(os.listdir(directory), reverse=True):
        if not name.startswith("step_"):
            continue
        step = _step_of(name)
        if step is None or (max_step is not None and step > max_step):
            continue
        path = os.path.join(directory, name)
        if os.path.isdir(path) and _is_complete(path):
            return path
    return None


def discard_checkpoints_after(directory: str, step: int) -> List[str]:
    """Remove every checkpoint with a step past ``step`` and re-point LATEST
    at the newest complete one left (or remove it).  Returns the removed
    directory names."""
    removed: List[str] = []
    if not os.path.isdir(directory):
        return removed
    keep_newest: Optional[int] = None
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        s = _step_of(name)
        if s is None:
            continue
        if s > step:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            removed.append(name)
        elif _is_complete(os.path.join(directory, name)):
            keep_newest = s if keep_newest is None else max(keep_newest, s)
    if keep_newest is not None:
        _write_latest(directory, f"step_{keep_newest:08d}")
    else:
        try:
            os.remove(os.path.join(directory, "LATEST"))
        except OSError:
            pass
    return removed


def restore_checkpoint(path: str, target: Any, *, cast: bool = False,
                       shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                       ) -> Any:
    """Restore into the structure of ``target``.

    Each leaf of ``target`` (a tensor, or anything with ``shape`` and
    ``dtype``) names the path, shape and dtype to read.  Tensor leaves come
    back as new tensors on that leaf's device, other leaves as host numpy
    arrays (bf16 always as a tensor).  With ``shard``, each tensor leaf is
    read whole and ``shard(path, leaf)`` keeps what this process holds (a
    data-parallel rank's slice: the mesh layout lives in the target, never
    in the file).  Shape mismatches raise; dtype mismatches raise unless
    ``cast=True``.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(p: str, tgt):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        entry = by_path[p]
        arr = _load_leaf(np.load(os.path.join(path, entry["file"])), entry["dtype"])
        if shard is not None and isinstance(tgt, torch.Tensor):
            arr = shard(p, arr if isinstance(arr, torch.Tensor)
                        else torch.from_numpy(_contiguous(arr)))
        tgt_shape = tuple(tgt.shape)
        if tuple(arr.shape) != tgt_shape:
            raise ValueError(f"{p}: shape {tuple(arr.shape)} != target {tgt_shape}")
        want = _dtype_name(tgt.dtype)
        if entry["dtype"] != want:
            if not cast:
                raise ValueError(f"{p}: dtype {entry['dtype']} != target {want} "
                                 f"(pass cast=True to convert)")
        if isinstance(tgt, torch.Tensor):
            t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(_contiguous(arr))
            return t.to(device=tgt.device, dtype=tgt.dtype)
        if isinstance(arr, torch.Tensor):
            return arr
        return arr.astype(np.dtype(want)) if entry["dtype"] != want else arr

    return tree_map_with_paths(load, target)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return int(json.load(f)["step"])
