"""Weight bridge from the JAX package: identity by path.

The port keeps the JAX dotted paths, layouts and stacked leaves, so a JAX
parameter tree (or fused-LAMB state) maps onto the port's flat dicts with no
reshaping.  Inputs are array-likes (numpy arrays, or anything
``np.asarray`` accepts); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional, Union

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
