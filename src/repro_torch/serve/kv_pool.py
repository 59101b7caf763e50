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

On a mesh (``shard_ctx``, one pool a rank) the pool is the rank's block of
the reference's one ``make_cache(n_slots, max_len)`` tree under the
context's rules (``placement.cache_block``): its rows of slots where the
rules split the slots over the data-parallel ranks
(``placement.serving_rows``), its kv heads, ``inner`` slice and cell heads
over ``model``, and under the ``cache_seq`` rule, where the slots stay
whole, its block of positions.  The widened ``(n_layers, n_slots)`` index
is whole on every rank, as the reference's rule gives ``index`` no split
axis, and so is the host mirror: every rank keeps every slot's length,
free list and quarantine alike.  Only the rank whose rows hold a slot
copies a prefilled cache into it (:meth:`KVPool.insert`); a prefill's cache
is one row of the pool's block (:meth:`KVPool.row_cache`), so nothing is
gathered.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.sharding.context import ShardCtx
from repro_torch.sharding.placement import CACHE_FILL, cache_block, serving_ctx, serving_rows

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
    ``max_len`` cache positions per slot, the ``device`` the cache lives
    on, and ``shard_ctx`` for this rank's block of the pool on a mesh (see
    the module docstring; its ``param_specs`` are kept in :attr:`ctx`).
    Invariant: ``lengths[s] > 0`` iff slot ``s`` is occupied, and the
    host free-list / lengths mirror is the single source of truth the
    scheduler reads — no device sync needed for admission decisions.

    On a mesh, :attr:`ctx` is the context a decode step over the pool runs
    under (its rows and sequence split), :attr:`row_ctx` the one a prefill
    into :meth:`row_cache` runs under (every row on every data rank, the
    pool's sequence split), and :attr:`rows` the ``(first slot, slots)``
    this rank's block holds.
    """

    def __init__(self, model: Model, n_slots: int, max_len: int, device,
                 shard_ctx: Optional[ShardCtx] = None):
        if n_slots < 1 or max_len < 1:
            raise ValueError(
                f"pool needs n_slots >= 1 and max_len >= 1, got "
                f"{n_slots=} {max_len=}"
            )
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.ctx = self.row_ctx = None
        self.rows = (0, n_slots)
        if shard_ctx is None:
            cache = model.make_cache(n_slots, max_len, self.device)
        else:
            meta = model.make_cache(n_slots, max_len, "meta")
            self.ctx = serving_ctx(shard_ctx, shard_ctx.param_specs, meta, n_slots)
            mesh, rules = self.ctx.mesh, self.ctx.act_rules
            self.row_ctx = ShardCtx(mesh, rules, self.ctx.param_specs,
                                    cache_seq_split=self.ctx.cache_seq_split, rows_split=False)
            self.rows = serving_rows(n_slots, mesh, rules)[:2]
            cache = cache_block(meta, mesh, rules, self.device)
        self.cache = widen_index(cache, n_slots)
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
        """Device bytes the pool's cache holds (on a mesh, this rank's
        block and the whole index)."""
        return sum(v.numel() * v.element_size()
                   for leaves in self.cache.values() for v in leaves.values())

    # ---- device ops ----
    def row_cache(self) -> Cache:
        """A fresh batch-1 cache in this pool's layout, one row of its block
        (each leaf filled as ``placement.CACHE_FILL`` says, the index a
        scalar a layer): what a prefill fills for :meth:`insert`."""
        def row(k, leaf):
            if k == "index":
                return torch.zeros(leaf.shape[:1], dtype=leaf.dtype, device=leaf.device)
            return torch.full((leaf.shape[0], 1, *leaf.shape[2:]), CACHE_FILL.get(k, 0),
                              dtype=leaf.dtype, device=leaf.device)
        return _map(row, self.cache)

    def insert(self, single_cache: Cache, slot: int, length: int) -> None:
        """Install a prefilled batch-1 cache (built at this pool's max_len,
        in its layout) into `slot`.  `length` is the prompt length already
        written.  On a mesh only the rank whose rows hold `slot` copies its
        state; every rank sets the slot's index."""
        if length > self.max_len:
            raise ValueError(f"prompt length {length} exceeds pool max_len "
                             f"{self.max_len}")
        single = expand_index(single_cache)
        start, n = self.rows
        for seg, leaves in self.cache.items():
            for k, leaf in leaves.items():
                if k == "index":
                    leaf.narrow(1, slot, 1).copy_(single[seg][k])
                elif start <= slot < start + n:
                    leaf.narrow(1, slot - start, 1).copy_(single[seg][k])
        self.lengths[slot] = length

    def decode_view(self) -> Cache:
        """The tree a decode step over this rank's rows takes: the pool's
        own where the block holds every row (the step moves the index in
        place), else the pool's leaves with each index leaf a copy of this
        rank's rows of it (the step writes that copy; :meth:`advance` then
        moves the whole index)."""
        start, n = self.rows
        if n == self.n_slots:
            return self.cache
        return _map(lambda k, leaf: leaf[:, start:start + n].clone() if k == "index" else leaf,
                    self.cache)

    def advance(self, active: torch.Tensor) -> None:
        """Every slot's index after a decode step over :meth:`decode_view`:
        one further where ``active`` ((n_slots,) bool), 0 elsewhere, as each
        rank's rows step it."""
        if self.rows[1] < self.n_slots:
            for leaves in self.cache.values():
                if "index" in leaves:
                    leaves["index"].add_(1)
        reset_inactive(self.cache, active)

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
