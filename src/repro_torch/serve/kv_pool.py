"""Slot-based KV cache pool for continuous batching (port of
``repro.serve.kv_pool``).

The pool holds one ``Model.make_cache`` tree whose batch axis is the slot
axis.  Two representation rules, as in the reference:

* every non-``index`` leaf keeps the stacked layout ``(n_layers, B, ...)``
  produced by ``make_cache`` — batch (slot) axis is always axis 1;
* ``index`` leaves, which ``make_cache`` emits as one scalar length per layer
  ``(n_layers,)``, are widened to per-slot lengths ``(n_layers, B)``.  The
  attention decode path accepts this vector form and scatters each row at
  its own position.

Recurrent state (the xLSTM cells', Mamba's ssm state and conv ring) has no
``index``: evict and reset-inactive leave such segments alone, an idle slot
steps its state on token 0, and the next ``insert`` overwrites it, as in
the reference.

Every device op (insert, evict, reset-inactive) writes the pool's tensors
in place with a host-side slot id, so swapping requests between decode
steps allocates nothing and reads nothing back.  The free-list and a host
mirror of per-slot lengths live on the host — the scheduler reads those,
never the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model

Cache = Dict[str, Dict[str, torch.Tensor]]


def _map(fn: Callable[[str, torch.Tensor], Any], cache: Cache) -> Cache:
    """Apply ``fn(leaf_name, leaf)`` to every leaf of a two-level cache tree."""
    return {seg: {k: fn(k, v) for k, v in leaves.items()} for seg, leaves in cache.items()}


def widen_index(cache: Cache, n_slots: int) -> Cache:
    """(n_layers,) scalar-per-layer index leaves → (n_layers, n_slots) zeros."""
    return _map(lambda k, leaf: torch.zeros(leaf.shape + (n_slots,), dtype=leaf.dtype,
                                            device=leaf.device)
                if k == "index" else leaf, cache)


def expand_index(cache: Cache) -> Cache:
    """Single-request cache: index leaves (n_layers,) → (n_layers, 1) so the
    tree matches the pool layout (batch axis on every leaf)."""
    return _map(lambda k, leaf: leaf[..., None] if k == "index" else leaf, cache)


def reset_inactive(cache: Cache, active: torch.Tensor) -> Cache:
    """Clamp index leaves of inactive slots back to 0 (active: (B,) bool),
    in place.

    Called inside the decode step so empty slots never walk their write
    position past position 0 while idling.
    """
    for leaves in cache.values():
        if "index" in leaves:
            leaves["index"].mul_(active[None, :])
    return cache


class KVPool:
    """Fixed-capacity slot pool over a model's cache tree.

    Args: the model (for ``make_cache``), ``n_slots`` concurrent requests,
    ``max_len`` cache positions per slot, and the ``device`` the cache lives
    on.  Invariant: ``lengths[s] > 0`` iff slot ``s`` is occupied, and the
    host free-list / lengths mirror is the single source of truth the
    scheduler reads — no device sync needed for admission decisions.
    """

    def __init__(self, model: Model, n_slots: int, max_len: int, device):
        if n_slots < 1 or max_len < 1:
            raise ValueError(
                f"pool needs n_slots >= 1 and max_len >= 1, got "
                f"{n_slots=} {max_len=}"
            )
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.cache = widen_index(model.make_cache(n_slots, max_len, self.device), n_slots)
        self.lengths = np.zeros(n_slots, np.int32)  # host mirror of index
        self._free: List[int] = list(range(n_slots - 1, -1, -1))

    # ---- host-side slot bookkeeping ----
    @property
    def n_free(self) -> int:
        """Free slots right now (host-side, O(1))."""
        return len(self._free)

    @property
    def active_mask(self) -> np.ndarray:
        """(n_slots,) bool host array: True where a request occupies a slot."""
        return self.lengths > 0

    def acquire(self) -> Optional[int]:
        """Pop a free slot id (lowest first), or None when full."""
        return self._free.pop() if self._free else None

    @property
    def nbytes(self) -> int:
        """Device bytes the pool's cache holds."""
        return sum(v.numel() * v.element_size()
                   for leaves in self.cache.values() for v in leaves.values())

    # ---- device ops ----
    def insert(self, single_cache: Cache, slot: int, length: int) -> None:
        """Install a prefilled batch-1 cache (built at this pool's max_len)
        into `slot`.  `length` is the prompt length already written."""
        if length > self.max_len:
            raise ValueError(f"prompt length {length} exceeds pool max_len "
                             f"{self.max_len}")
        single = expand_index(single_cache)
        for seg, leaves in self.cache.items():
            for k, leaf in leaves.items():
                leaf.narrow(1, slot, 1).copy_(single[seg][k])
        self.lengths[slot] = length

    def evict(self, slot: int) -> None:
        """Free `slot` and zero its length on device.  Stale K/V stay in
        memory but are masked out (valid < 1) and fully overwritten by the
        next insert."""
        if self.lengths[slot] == 0 and slot in self._free:
            return
        for leaves in self.cache.values():
            if "index" in leaves:
                leaves["index"][:, slot].zero_()
        self.lengths[slot] = 0
        self._free.append(slot)

    def quarantine(self, slot: int) -> None:
        """Evict `slot` *without* returning it to the free list (suspected
        state corruption).  The slot is unschedulable until `release`."""
        self.evict(slot)
        self._free.remove(slot)

    def release(self, slot: int) -> None:
        """Return a quarantined slot to the free list (its device state was
        already zeroed by `quarantine`; the next insert overwrites it)."""
        if slot in self._free or self.lengths[slot] > 0:
            raise ValueError(f"slot {slot} is not quarantined")
        self._free.append(slot)

    def reset(self) -> None:
        """Evict everything (used between benchmark phases)."""
        for slot in range(self.n_slots):
            if self.lengths[slot] > 0:
                self.evict(slot)
