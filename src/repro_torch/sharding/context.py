"""Ambient sharding context (port of ``repro.sharding.context``).

A train step built on a mesh installs a :class:`ShardCtx` with
:func:`use_sharding`.  :func:`shard_act` is the reference's activation
annotation, the identity here: over the data-parallel axes each rank
already holds its own rows, and a layer split over ``model`` takes its
slice through :func:`model_parallel`.

Beyond the reference, the context carries the parameters' specs: where
GSPMD keeps every reduction over a sharded array global by itself, the port
asks the context how each leaf is laid out (:meth:`ShardCtx.layout`: the
dimension the data-parallel axes split, and the one ``model`` splits), and
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
from typing import Dict, Mapping, NamedTuple, Optional, Sequence

from repro_torch.sharding.axes import Spec, batch_axes, default_act_rules, mesh_sizes

_state = threading.local()

# what a mesh still does not run (ROADMAP.md queue 1): mesh axes besides
# pod, data and model, and a dimension split over both data and model
UNPORTED = "ROADMAP.md queue 1, item 11 (b2)"


class Layout(NamedTuple):
    """How a leaf lies over the mesh: the dimension the data-parallel axes
    split (FSDP, ``embed``) and the one ``model`` splits (tensor and
    expert parallelism: ``heads``, ``kv_heads``, ``ff``, ``vocab``,
    ``experts``, ``inner``); None where the leaf is whole along that
    axis."""

    data: Optional[int] = None
    model: Optional[int] = None

    @property
    def split(self) -> bool:
        return self.data is not None or self.model is not None


WHOLE = Layout()


class ModelAxis(NamedTuple):
    """The ``model`` axis of the ambient mesh (or its data-parallel axes,
    :func:`data_parallel`): its process group, this rank's index along it
    and its size (> 1)."""

    group: object
    index: int
    size: int


def leaf_layout(spec: Spec, mesh) -> Layout:
    """The :class:`Layout` of a leaf with ``spec`` on ``mesh``.

    Data-parallel axes split a dimension even at size 1 (the slice is then
    the whole leaf); a ``model`` entry splits only at more than one rank.
    A dimension split over both, or over only part of the data-parallel
    axes, is not ported and raises."""
    sizes = mesh_sizes(mesh)
    dp = batch_axes(mesh)
    data = model = None
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        split = tuple(a for a in axes if sizes[a] > 1 or a in dp)
        if not split:
            continue
        if split == dp:
            data = i
        elif split == ("model",):
            model = i
        else:
            raise NotImplementedError(
                f"spec {spec} splits dimension {i} over {split}: a dimension splits "
                f"over the data-parallel axes {dp} or over 'model' alone ({UNPORTED})")
    return Layout(data, model)


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
        share this rank's ``model`` coordinate."""
        return self.mesh.group(batch_axes(self.mesh))

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
        axis the leaf is not split over, so each block is counted once (a
        layer-norm scale, split over ``data`` alone, on model rank 0; ``bq``,
        split over ``model`` alone, on data rank 0)."""
        lay = self.layout(path)
        if lay.data is None and self.mesh.index(batch_axes(self.mesh)) != 0:
            return False
        return lay.model is not None or self.mesh.coords().get("model", 0) == 0


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
