"""Weight bridge to and from the JAX package: identity by path.

The port keeps the JAX dotted paths, layouts and stacked leaves, so a JAX
parameter tree (or optimizer state: fused LAMB's, or a transform chain's)
maps onto the port's flat dicts with no reshaping.  Inputs are array-likes
(numpy arrays, or anything ``np.asarray`` accepts); nothing here imports
JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.nn.module import Params, flatten


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(
    tree, device: Optional[Union[str, torch.device]] = "cpu"
) -> Params:
    """Nested dict of arrays (a JAX ``model.init`` tree) → flat ``{path: Tensor}``."""
    dev = torch.device(device)
    return {k: _to_tensor(v, dev) for k, v in flatten(tree).items()}


def cache_from_jax(tree, device: Optional[Union[str, torch.device]] = "cpu"
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``make_cache`` tree (``{"main": {"k", "v", "index"}}``, as
    arrays) → the port's cache of the same nesting, layouts and dtypes."""
    dev = torch.device(device)
    return {seg: {k: _to_tensor(v, dev) for k, v in leaves.items()}
            for seg, leaves in tree.items()}


def state_from_jax(state, device: Optional[Union[str, torch.device]] = "cpu"):
    """A JAX optimizer state → the port's: a ``FusedLambState``, or any
    transform chain's tuple of ``EmptyState`` / ``TraceState`` /
    ``ScaleByAdamState`` / ``ScaleByAdagradState`` / ``ScheduleState``
    (matched by class name and field: nested param trees become flat
    dicts, scalars int32 device tensors)."""
    from repro_torch.kernels.ops import FusedLambState
    from repro_torch.optim import base

    dev = torch.device(device)
    classes = {c.__name__: c for c in (
        FusedLambState, base.EmptyState, base.TraceState, base.ScaleByAdamState,
        base.ScaleByAdagradState, base.ScheduleState)}
    cls = classes.get(type(state).__name__)
    if cls is None:
        if isinstance(state, tuple):
            return tuple(state_from_jax(s, dev) for s in state)
        raise TypeError(f"no port state for {type(state).__name__}")

    def leaf(v):
        if isinstance(v, dict):
            return params_from_jax(v, dev)
        return _to_tensor(v, dev).to(torch.int32)

    return cls(**{f.name: leaf(getattr(state, f.name)) for f in dataclasses.fields(cls)})


def train_state_from_jax(state, device: Optional[Union[str, torch.device]] = "cpu"):
    """A JAX ``TrainState`` (params, opt state, ``step``, ``skipped``) → the
    port's :class:`~repro_torch.train.step.TrainState`."""
    from repro_torch.train.step import TrainState

    dev = torch.device(device)
    return TrainState(
        params_from_jax(state.params, dev),
        state_from_jax(state.opt_state, dev),
        _to_tensor(state.step, dev).to(torch.int32),
        _to_tensor(state.skipped, dev).to(torch.int32),
    )


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:   # numpy has no bf16: exact through float32
        return t.to(torch.float32).numpy()
    return t.numpy()


def train_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The port's ``TrainState`` as ``{path: array}`` under the reference's
    leaf paths and in its leaf order (``params/<path>``, ``opt_state/...``
    as the reference names its optimizer state, e.g. ``opt_state/count`` or
    ``opt_state/1/mu/<path>``, ``step``, ``skipped``)."""
    from repro_torch.checkpoint.io import tree_leaves_with_paths

    return {k: _to_numpy(v) for k, v in tree_leaves_with_paths(state)}
