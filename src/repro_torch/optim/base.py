"""Gradient clipping by global norm (port of ``repro.optim.base``)."""
from __future__ import annotations

from typing import Dict

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every leaf, reduced in fp32."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square() for x in tree.values()]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_tree_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Rescale ``tree`` in place so its global L2 norm is at most ``max_norm``.

    Factor ``min(1, max_norm / (norm + 1e-12))``, norm reduced in fp32; leaf
    dtypes are kept.
    """
    factor = torch.clamp(max_norm / (global_norm(tree) + 1e-12), max=1.0)
    for x in tree.values():
        x.mul_(factor)
