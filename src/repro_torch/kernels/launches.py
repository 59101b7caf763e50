"""Launch counts of the port's CUDA kernels, one shared registry.

Each kernel module registers its names here and its wrapper adds one where
it launches the kernel, and nowhere else; a run resets the counts, drives
its path and reads them to show that the path went through the kernels.
A kernel with more than one design (flash attention: tensor-core or FMA)
also counts its launches by the design that ran, and a wrapper that had to
copy an input before a launch counts that copy.  Every wrapper adds
through :func:`count_launch`, under :data:`LOCK`, so that the ranks that
one process runs as threads (``collectives.run_plain_ranks``) lose no
addition.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

LAUNCHES: Dict[str, int] = {}
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {}   # kernel -> design -> launches
COPIES: Dict[str, int] = {}                         # input a wrapper copied -> times
LOCK = threading.Lock()


def register(*names: str, variants: tuple = ()) -> None:
    for name in names:
        LAUNCHES.setdefault(name, 0)
        if variants:
            VARIANT_LAUNCHES.setdefault(name, dict.fromkeys(variants, 0))


def count_launch(name: str, variant: Optional[str] = None) -> None:
    """One launch of ``name`` (under its design ``variant``, if given)."""
    with LOCK:
        LAUNCHES[name] += 1
        if variant is not None:
            VARIANT_LAUNCHES[name][variant] += 1


def count_copy(name: str) -> None:
    """One copy of the input ``name`` that a wrapper made before a launch."""
    with LOCK:
        COPIES[name] += 1


def register_copies(*names: str) -> None:
    for name in names:
        COPIES.setdefault(name, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_variant in VARIANT_LAUNCHES.values():
        for k in by_variant:
            by_variant[k] = 0
    for k in COPIES:
        COPIES[k] = 0
