"""Weight bridge to and from the JAX package: identity by path.

The port keeps the JAX dotted paths, layouts and stacked leaves, so a JAX
parameter tree (or fused-LAMB state) maps onto the port's flat dicts with no
reshaping.  Inputs are array-likes (numpy arrays, or anything
``np.asarray`` accepts); nothing here imports JAX.
"""
from __future__ import annotations

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


def state_from_jax(state, device: Optional[Union[str, torch.device]] = "cpu"):
    """A JAX ``FusedLambState`` (``count``, ``sched_count``, ``mu``, ``nu``)
    → the port's :class:`~repro_torch.kernels.ops.FusedLambState`."""
    from repro_torch.kernels.ops import FusedLambState

    dev = torch.device(device)
    return FusedLambState(
        count=_to_tensor(state.count, dev).to(torch.int32),
        sched_count=_to_tensor(state.sched_count, dev).to(torch.int32),
        mu=params_from_jax(state.mu, dev),
        nu=params_from_jax(state.nu, dev),
    )


def train_state_from_jax(state, device: Optional[Union[str, torch.device]] = "cpu"):
    """A JAX fused-LAMB ``TrainState`` (params, opt state, ``step``,
    ``skipped``) → the port's :class:`~repro_torch.train.step.TrainState`."""
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
    leaf paths (``params/<path>``, ``opt_state/count``,
    ``opt_state/sched_count``, ``opt_state/mu/<path>``,
    ``opt_state/nu/<path>``, ``step``, ``skipped``), in its leaf order."""
    o = state.opt_state
    out = {f"params/{k}": _to_numpy(v) for k, v in state.params.items()}
    out["opt_state/count"] = _to_numpy(o.count)
    out["opt_state/sched_count"] = _to_numpy(o.sched_count)
    out.update({f"opt_state/mu/{k}": _to_numpy(v) for k, v in o.mu.items()})
    out.update({f"opt_state/nu/{k}": _to_numpy(v) for k, v in o.nu.items()})
    out["step"] = _to_numpy(state.step)
    out["skipped"] = _to_numpy(state.skipped)
    return out
