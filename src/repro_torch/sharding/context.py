"""Ambient sharding context (port of ``repro.sharding.context``).

A train step built on a mesh installs a :class:`ShardCtx` with
:func:`use_sharding`.  :func:`shard_act` is the reference's activation
annotation, the identity here: over the data-parallel axes each rank
already holds its own rows, and a layer split over ``model`` takes its
slice through :func:`model_parallel`.

Beyond the reference, the context carries the parameters' specs: where
GSPMD keeps every reduction over a sharded array global by itself, the port
asks the context how each leaf is laid out (:meth:`ShardCtx.layout`: each
dimension it is cut along and the mesh axes that cut it), and
the norms of ``core.strategy``, ``optim.base`` and ``kernels.ops`` sum the
partials of every split leaf over the whole world in one collective, each
counted once (:meth:`ShardCtx.counts`).  The model's layers ask it for the
``model`` axis (:func:`model_parallel`), and the MoE router for the
data-parallel axes (:func:`data_parallel`).  Without a context (single-process
runs and unit tests) nothing changes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

from repro_torch.sharding.axes import Spec, batch_axes, default_act_rules, mesh_sizes

_state = threading.local()

Split = Tuple[int, Tuple[str, ...]]


class Layout(NamedTuple):
    """How a leaf lies over the mesh: ``splits``, each dimension it is cut
    along with the mesh axes that cut it, in the spec's order (the block
    index along a dimension is mixed-radix over those axes' coordinates,
    the first the most significant, as GSPMD lays it out), and ``dp``, the
    mesh's data-parallel axes.  The leaf is replicated over every axis it
    is not cut along.

    Two properties name the dimensions of the layouts the reference's
    default rules give: ``data``, the dimension the data-parallel axes
    split together (FSDP, ``embed``), and ``model``, the one ``model``
    splits alone (tensor and expert parallelism: ``heads``, ``kv_heads``,
    ``ff``, ``vocab``, ``experts``, ``inner``); None where no dimension is
    so split."""

    splits: Tuple[Split, ...] = ()
    dp: Tuple[str, ...] = ()

    @property
    def data(self) -> Optional[int]:
        return next((d for d, axes in self.splits if axes == self.dp and axes), None)

    @property
    def model(self) -> Optional[int]:
        return next((d for d, axes in self.splits if axes == ("model",)), None)

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the leaf is cut over."""
        return tuple(a for _, axes in self.splits for a in axes)

    @property
    def split(self) -> bool:
        return bool(self.splits)


WHOLE = Layout()


class ModelAxis(NamedTuple):
    """The ``model`` axis of the ambient mesh (or its data-parallel axes,
    :func:`data_parallel`): its process group, this rank's index along it
    and its size (> 1)."""

    group: object
    index: int
    size: int


def leaf_layout(spec: Spec, mesh) -> Layout:
    """The :class:`Layout` of a leaf with ``spec`` on ``mesh``: any spec
    ``resolve_spec`` gives, a dimension cut over one axis or an ordered
    tuple of them.

    Data-parallel axes cut a dimension even at size 1 (the slice is then
    the whole leaf); every other axis only at more than one rank."""
    sizes = mesh_sizes(mesh)
    dp = batch_axes(mesh)
    splits = []
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        cut = tuple(a for a in axes if sizes[a] > 1 or a in dp)
        if cut:
            splits.append((i, cut))
    return Layout(tuple(splits), dp)


def compute_layout(spec: Spec, mesh) -> Layout:
    """The layout a leaf computes in, whatever layout stores it: ``spec``'s
    (the default rules') ``model`` split, whole over every other axis (the
    data-parallel gather of FSDP done).  The layers run on these blocks."""
    lay = leaf_layout(spec, mesh)
    return Layout(tuple(s for s in lay.splits if s[1] == ("model",)), lay.dp)


class ShardCtx:
    """A mesh, the activation rule set annotations resolve against, and the
    parameters' specs (``{path: spec}``, optional).  Two flags describe a
    serving call's batch and cache (``placement.serving_ctx`` sets
    them from the specs): ``cache_seq_split``, the cache's sequence is
    split over the data-parallel axes (``placement.cache_seq_split``:
    each rank holds one block of positions, :func:`cache_seq_axis`), and
    ``rows_split``, each data-parallel rank holds its own block of the
    batch's rows (a training step's batch, a serving batch the ranks
    divide); where it is False every rank holds every row (a serving batch
    of one) and :func:`data_parallel` is None, so that a layer counting
    the global batch (the MoE router) counts its rows once.

    Install with :func:`use_sharding`; the norms see it through
    :meth:`split` and :meth:`counts`, the layers through
    :func:`model_parallel`, :func:`shard_act` through ``act_rules``.
    """

    def __init__(self, mesh, act_rules: Optional[Mapping] = None,
                 param_specs: Optional[Mapping[str, Spec]] = None, *,
                 cache_seq_split: bool = False, rows_split: bool = True):
        self.mesh = mesh
        self.cache_seq_split = bool(cache_seq_split)
        self.rows_split = bool(rows_split)
        self.act_rules = dict(
            act_rules if act_rules is not None
            else default_act_rules(multi_pod="pod" in mesh_sizes(mesh)))
        self.param_specs: Dict[str, Spec] = dict(param_specs or {})
        self._layouts = {k: leaf_layout(s, mesh) for k, s in self.param_specs.items()}

    def with_rules(self, **overrides) -> "ShardCtx":
        """A new context with the given activation rules replaced (e.g.
        ``cache_seq=("data",)`` for long-context decode at batch 1), as the
        reference's; the specs and flags are kept."""
        rules = dict(self.act_rules)
        rules.update(overrides)
        return ShardCtx(self.mesh, rules, self.param_specs,
                        cache_seq_split=self.cache_seq_split, rows_split=self.rows_split)

    def layout(self, path: Optional[str]) -> Layout:
        """The layout of parameter ``path`` (whole when unknown)."""
        return WHOLE if path is None else self._layouts.get(path, WHOLE)

    @property
    def dp_group(self):
        """The process group over the data-parallel axes: the ranks that
        share this rank's coordinates on every other axis (None on a mesh
        without one)."""
        axes = batch_axes(self.mesh)
        return self.mesh.group(axes) if axes else None

    @property
    def world_group(self):
        """The process group over every rank of the mesh."""
        return self.mesh.group(self.mesh.axis_names)

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The ``model`` axis when the mesh is concrete and it has more
        than one rank, else None."""
        n = mesh_sizes(self.mesh).get("model", 1)
        if n == 1 or self.mesh.abstract:
            return None
        return ModelAxis(self.mesh.group(("model",)), self.mesh.coords()["model"], n)

    def _dp_axis(self) -> Optional[ModelAxis]:
        axes = batch_axes(self.mesh)
        n = self.mesh.extent(axes)
        if n == 1 or self.mesh.abstract:
            return None
        return ModelAxis(self.dp_group, self.mesh.index(axes), n)

    @property
    def data_axis(self) -> Optional[ModelAxis]:
        """The data-parallel axes when the mesh is concrete, they hold more
        than one rank and each holds its own rows (``rows_split``), else
        None."""
        return self._dp_axis() if self.rows_split else None

    @property
    def seq_axis(self) -> Optional[ModelAxis]:
        """The data-parallel axes over which the serving cache's sequence
        is split (``cache_seq_split``), when the mesh is concrete and they
        hold more than one rank, else None."""
        return self._dp_axis() if self.cache_seq_split else None

    def split(self, path: Optional[str]) -> bool:
        """Whether a reduction over leaf ``path`` must be summed over the
        ranks: the leaf is split along some axis of a concrete mesh."""
        return not self.mesh.abstract and self.layout(path).split

    def counts(self, path: Optional[str]) -> bool:
        """Whether this rank's partial of leaf ``path`` counts in a sum
        over the world: only on the ranks whose coordinate is 0 along every
        axis the leaf is not cut over, so each block is counted once (a
        layer-norm scale, split over ``data`` alone, on model rank 0; ``bq``,
        split over ``model`` alone, on data rank 0; a leaf whole over a
        ``pipe`` axis on its rank 0)."""
        cut = self.layout(path).axes
        return all(c == 0 for a, c in self.mesh.coords().items() if a not in cut)


def current() -> Optional[ShardCtx]:
    """The ambient :class:`ShardCtx` of this thread, or ``None``."""
    return getattr(_state, "ctx", None)


def model_parallel() -> Optional[ModelAxis]:
    """The ambient context's ``model`` axis (None without one, or at one
    rank: every tensor-parallel operator is then the identity)."""
    ctx = current()
    return None if ctx is None else ctx.model_axis


def data_parallel() -> Optional[ModelAxis]:
    """The ambient context's data-parallel axes (None without one, at one
    rank, or where every rank holds every row): what a layer that counts
    the global batch's tokens (the MoE router) reduces over."""
    ctx = current()
    return None if ctx is None else ctx.data_axis


def cache_seq_axis() -> Optional[ModelAxis]:
    """The data-parallel axes the ambient context splits the serving
    cache's sequence over (None without one, or at one rank): rank ``i``
    of ``n`` holds positions ``[i·T/n, (i+1)·T/n)``."""
    ctx = current()
    return None if ctx is None else ctx.seq_axis


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
    """Annotate activation ``x`` with logical axis names: the identity, as
    the reference's ``with_sharding_constraint`` leaves the logical array
    whole.  With an ambient context ``axes`` must name every dimension of
    ``x`` and resolve through the context's activation rules.  A layer that
    splits its work over ``model`` asks :func:`model_parallel` instead."""
    ctx = current()
    if ctx is None:
        return x
    if x.ndim != len(axes):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs logical axes {axes}")
    from repro_torch.sharding.axes import resolve_spec

    resolve_spec(x.shape, axes, ctx.act_rules, ctx.mesh)
    return x
