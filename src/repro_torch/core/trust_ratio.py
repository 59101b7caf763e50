"""Trust-ratio diagnostics (paper App. H, Figures 9-14); port of
``repro.core.trust_ratio``.  Device tensors throughout, no host sync."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.strategy import _slice_norm, layer_axis, trust_ratio
from repro_torch.optim.base import Tensors


def trust_ratio_tree(
    params: Tensors,
    updates: Tensors,
    *,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
) -> Tensors:
    """Per-leaf phi(||x||)/||u|| (one per layer slice on a stacked leaf),
    squeezed to vectors; 1 where either norm is 0."""
    return {k: torch.squeeze(trust_ratio(p, updates[k], layer_axis=layer_axis(layer_axes, k),
                                         phi_bounds=phi_bounds, path=k))
            for k, p in params.items()}


def trust_records(
    params: Tensors,
    updates: Tensors,
    *,
    layer_axes: Optional[Dict[str, Optional[int]]] = None,
    phi_bounds: Optional[Tuple[float, float]] = None,
    trust_ratio: Optional[Tensors] = None,
) -> Dict[str, Tensors]:
    """``{"trust_ratio", "param_norm", "update_norm"}``: three trees over
    the params' paths of per-layer-slice vectors (scalars on unstacked
    leaves).  ``trust_ratio`` passes the applied ratios (the fused kernels'
    aux output) in place of the post-hoc ``phi(||x||)/||Δx||``."""
    if trust_ratio is None:
        trust_ratio = trust_ratio_tree(params, updates, layer_axes=layer_axes,
                                       phi_bounds=phi_bounds)

    def norm(tree):
        return {k: torch.squeeze(_slice_norm(x, layer_axis(layer_axes, k), path=k))
                for k, x in tree.items()}

    return {
        "trust_ratio": {k: torch.squeeze(r) for k, r in trust_ratio.items()},
        "param_norm": norm(params),
        "update_norm": norm(updates),
    }


def summarize_trust_ratios(tree: Tensors) -> Dict[str, torch.Tensor]:
    """``trust_ratio/{min,max,mean}`` over every ratio of ``tree``."""
    leaves = [torch.atleast_1d(x).reshape(-1) for x in tree.values()]
    flat = torch.cat(leaves) if leaves else torch.zeros((1,))
    return {
        "trust_ratio/min": flat.min(),
        "trust_ratio/max": flat.max(),
        "trust_ratio/mean": flat.mean(),
    }
