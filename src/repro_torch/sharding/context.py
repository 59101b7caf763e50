"""Ambient sharding context (port of ``repro.sharding.context``).

A train step built on a mesh installs a :class:`ShardCtx` with
:func:`use_sharding`.  :func:`shard_act` is the reference's activation
annotation; on a data-only mesh activations are rank-local (each rank holds
its rows) and it is the identity, so no model code calls it yet: the model
axis (ROADMAP.md queue 1, item 11 (b)) is where it starts to act.

Beyond the reference, the context carries the parameters' specs: where
GSPMD keeps every reduction over a sharded array global by itself, the port
asks the context which leaves are split over the data-parallel ranks
(:meth:`ShardCtx.reduce_group`), and the norms of ``core.strategy`` and
``optim.base`` all-reduce their partial sums over that group.  Without a
context (single-process runs and unit tests) nothing changes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence

from repro_torch.sharding.axes import Spec, batch_axes, default_act_rules, mesh_sizes

_state = threading.local()


def shard_dim(spec: Spec, mesh) -> Optional[int]:
    """The dimension a spec splits over the data-parallel ranks, or None
    when the leaf is whole on every rank.  Model-axis entries of size 1 do
    not split; a split over ``model`` (> 1), or over only part of the
    data-parallel axes, is not ported and raises."""
    sizes = mesh_sizes(mesh)
    dp = batch_axes(mesh)
    dim = None
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        split = tuple(a for a in axes if sizes[a] > 1 or a in dp)
        if not split:
            continue
        if split != dp:
            raise NotImplementedError(
                f"spec {spec} splits over {split}: only the data-parallel axes "
                f"{dp} are ported (the model axis is ROADMAP.md queue 1, item 11 (b))")
        dim = i
    return dim


class ShardCtx:
    """A mesh, the activation rule set annotations resolve against, and the
    parameters' specs (``{path: spec}``, optional).

    Install with :func:`use_sharding`; the norms see it through
    :meth:`reduce_group`, :func:`shard_act` through ``act_rules``.
    """

    def __init__(self, mesh, act_rules: Optional[Mapping] = None,
                 param_specs: Optional[Mapping[str, Spec]] = None):
        self.mesh = mesh
        self.act_rules = dict(
            act_rules if act_rules is not None
            else default_act_rules(multi_pod="pod" in mesh_sizes(mesh)))
        self.param_specs: Dict[str, Spec] = dict(param_specs or {})
        self._dims = {k: shard_dim(s, mesh) for k, s in self.param_specs.items()}

    def shard_dim(self, path: Optional[str]) -> Optional[int]:
        """The split dimension of parameter ``path`` (None: whole)."""
        return None if path is None else self._dims.get(path)

    @property
    def dp_group(self):
        """The process group over the data-parallel axes."""
        return self.mesh.group(batch_axes(self.mesh))

    def reduce_group(self, path: Optional[str]):
        """The group a reduction over leaf ``path`` must be all-reduced over
        (the data-parallel one when the leaf is split), else None."""
        if self.shard_dim(path) is None or self.mesh.abstract:
            return None
        return self.dp_group


def current() -> Optional[ShardCtx]:
    """The ambient :class:`ShardCtx` of this thread, or ``None``."""
    return getattr(_state, "ctx", None)


def reduce_group(path: Optional[str]):
    """:meth:`ShardCtx.reduce_group` of the ambient context (None without one)."""
    ctx = current()
    return None if ctx is None else ctx.reduce_group(path)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardCtx]):
    """Install ``ctx`` as the ambient sharding context for the block.

    Passing ``None`` explicitly disables it inside the block (restoring the
    previous context on exit either way).
    """
    prev = current()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def shard_act(x, axes: Sequence[Optional[str]]):
    """Annotate activation ``x`` with logical axis names.

    The identity: with no ambient context (single-process runs), and on a
    data-only mesh, where each rank holds its own rows whole.  A context
    whose activation rules would split ``x`` over a ``model`` axis of more
    than one rank raises (tensor parallelism is not ported).
    """
    ctx = current()
    if ctx is None:
        return x
    if x.ndim != len(axes):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs logical axes {axes}")
    from repro_torch.sharding.axes import resolve_spec

    sizes = mesh_sizes(ctx.mesh)
    dp = set(batch_axes(ctx.mesh))
    for entry in resolve_spec(x.shape, axes, ctx.act_rules, ctx.mesh):
        names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        if any(sizes[a] > 1 and a not in dp for a in names):
            raise NotImplementedError(
                "activations split over the model axis are not ported "
                "(ROADMAP.md queue 1, item 11 (b))")
    return x
