"""Launch counts of the port's CUDA kernels, one shared registry.

Each kernel module registers its names here and its wrapper adds one where
it launches the kernel, and nowhere else; a run resets the counts, drives
its path and reads them to show that the path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {}


def register(*names: str) -> None:
    for name in names:
        LAUNCHES.setdefault(name, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
