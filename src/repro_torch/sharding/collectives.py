"""The collectives of FSDP and tensor parallelism, which GSPMD inserts by
itself in the reference and the port calls by hand.

A leaf split over a group of ``N`` ranks along dimension ``dim`` lives on
each rank as one contiguous slice of ``dim``: rank ``i`` holds rows
``[i·n, (i+1)·n)``, ``n = size/N``.  A leaf may be split along two
dimensions, ``embed`` over the data-parallel ranks and a head, ff or vocab
dimension over ``model``, or along one dimension over an ordered tuple of
axes (its :class:`~repro_torch.sharding.context.Layout`, any spec
``resolve_spec`` gives): each rank then holds one block.

* :func:`shard_leaf` keeps the rank's slice of a whole leaf (no traffic),
  :func:`shard_block` its block;
* :func:`gather_leaf` rebuilds the whole leaf along one dimension on every
  rank of a group (``all_gather_into_tensor``), :func:`gather_block` along
  every split;
* :func:`to_compute` takes a parameter's block from the layout that stores
  it to the one the layers compute in, and :func:`to_storage` its gradient
  back, summed over the data-parallel ranks;
* :func:`scatter_grad` sums every rank's whole gradient and leaves each
  rank its slice (``reduce_scatter_tensor``); a leaf that is not split
  is all-reduced whole instead;
* :func:`all_reduce` sums, maxes or mins over a group; :func:`sum_over`
  sums into a new tensor;
* :func:`copy_to_model` and :func:`reduce_from_model` are Megatron's two
  operators at the edges of a tensor-parallel region: the identity forward
  with a sum over ``model`` backward (the input of a column-parallel
  product), and the sum forward with the identity backward (the output of
  a row-parallel one).  16-bit operands are summed in fp32 and rounded
  once;
* :func:`sum_across` sums over a group with the sum's adjoint, a sum, as
  its backward: a global quantity every rank computes from its own rows
  (the MoE router's global means) whose gradient reaches every rank's rows;
* :func:`gather_from_model` gathers an activation's slices over ``model``
  with the gather's adjoint, each rank's own slice of the gradient, as its
  backward: the input of work every rank repeats on the whole (the MoE
  router's logits, the sLSTM's heads before its norm);
* :func:`agree_any`, :func:`broadcast_int` and :func:`barrier` carry
  control flags and small integers over the mesh's host group (gloo, CPU
  tensors): no device launch and no device synchronisation.  They are
  never a route for device tensors.  :func:`agree_clock` gives a serving
  loop's ranks one clock, one drain flag and one step time in one of them.

Each has a plain single-process version (``*_plain``) that takes every
rank's operand at once: what the tests hold the collectives to.

A :class:`CountingGroup` stands for a group of a mesh that is not there
(the dry-run's, ``launch/dryrun.py``): every collective on it allocates
rank 0's result as the real one does (on the meta device, nothing) and
adds its operand bytes, by kind and by the mesh axes the group spans, to a
:class:`CollectiveTally`, under the reference's rule for what each kind
moves (:func:`operand_bytes`).  Nothing calls ``torch.distributed``; the
host-side flags raise on such a group.

:func:`run_plain_ranks` runs ``M`` ranks of one process as threads whose
group is a :class:`PlainGroup`: each collective meets the other ranks at a
barrier and returns its plain version over every rank's operand, built from
differentiable ops.  A layer then runs its own code on each rank's block
with the cross-rank sums and gathers done by the plain collectives, and one
backward pass over the joined graph gives every rank's gradients: the
exact gradients of the joined forward, with each replicated output counted
once by the caller.  The adjoints the real collectives apply by hand (a sum
over ``model`` in a backward) are autograd's own sums there, so a
backward's collective is the identity on a :class:`PlainGroup`.
"""
from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

OPS = ("sum", "max", "min")


def _dist():
    import torch.distributed as dist

    return dist


def _op(op: str):
    dist = _dist()
    if op not in OPS:
        raise ValueError(f"unknown reduction {op!r}; one of {OPS}")
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


def _collective(name: str, older: str):
    """``torch.distributed``'s ``name``, or its older spelling ``older``
    where that release lacks it."""
    dist = _dist()
    return getattr(dist, name, None) or getattr(dist, older)


class PlainRanks:
    """``size`` ranks of one process, a thread each, that meet at a barrier
    to swap operands (:func:`run_plain_ranks`); with a ``tally``, rank 0's
    collectives count into it through ``counter``, a :class:`CountingGroup`
    over ``model``."""

    def __init__(self, size: int, timeout: float, tally=None):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: list = [None] * size
        self.counter = None if tally is None else CountingGroup(("model",), size, tally)


class PlainGroup(NamedTuple):
    """Rank ``index``'s handle on :class:`PlainRanks`: the ``group`` the
    collectives take in place of a process group."""

    ranks: PlainRanks
    index: int

    @property
    def size(self) -> int:
        return self.ranks.size

    def record(self, kind: str, result: torch.Tensor) -> None:
        """Count rank 0's collective of ``kind`` with ``result`` (see
        :class:`PlainRanks`)."""
        if self.index == 0 and self.ranks.counter is not None:
            self.ranks.counter.record(kind, result)

    def exchange(self, x) -> list:
        """Every rank's ``x``, in rank order (each rank's own tensor)."""
        r = self.ranks
        r.slots[self.index] = x
        r.barrier.wait()
        out = list(r.slots)
        r.barrier.wait()   # every rank has read before the next swap writes
        return out


# the collective kinds the reference's roofline counts (its HLO op names)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def operand_bytes(kind: str, result_bytes: int, group: int) -> int:
    """The operand bytes of one collective of ``kind`` over ``group`` ranks
    whose result holds ``result_bytes``: the reference's rule
    (``repro.launch.roofline.collective_bytes``): an all-gather's operand
    is its result over the group, a reduce-scatter's its result times the
    group, the others' their result."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}; one of {KINDS}")
    if kind == "all-gather":
        return result_bytes // group
    if kind == "reduce-scatter":
        return result_bytes * group
    return result_bytes


class CollectiveTally:
    """Operand bytes of the collectives a dry-run's step made: by kind
    (``by_kind``), their number (``count``), and by the mesh axes each
    group spans (``by_axis``: ``"pod,data"`` → ``{"bytes", "count"}``)."""

    def __init__(self):
        self.by_kind = dict.fromkeys(KINDS, 0)
        self.count = 0
        self.by_axis: dict = {}

    def add(self, kind: str, nbytes: int, axes: Sequence[str]) -> None:
        self.by_kind[kind] += int(nbytes)
        self.count += 1
        entry = self.by_axis.setdefault(",".join(axes), {"bytes": 0, "count": 0})
        entry["bytes"] += int(nbytes)
        entry["count"] += 1


class CountingGroup(NamedTuple):
    """A group of ``size`` ranks over the mesh ``axes`` that no process
    forms: its collectives count into ``tally`` (rank 0's view)."""

    axes: Tuple[str, ...]
    size: int
    tally: CollectiveTally

    def record(self, kind: str, result: torch.Tensor) -> None:
        self.tally.add(kind, operand_bytes(kind, result.numel() * result.element_size(),
                                           self.size), self.axes)


def is_plain(group) -> bool:
    """Whether ``group`` is a :class:`PlainGroup` (a rank of
    :func:`run_plain_ranks`)."""
    return isinstance(group, PlainGroup)


def is_counting(group) -> bool:
    """Whether ``group`` is a :class:`CountingGroup` (a dry-run's)."""
    return isinstance(group, CountingGroup)


def group_size(group) -> int:
    if is_plain(group) or is_counting(group):
        return group.size
    return _dist().get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 on a dry-run's)."""
    if is_plain(group):
        return group.index
    return 0 if is_counting(group) else _dist().get_rank(group)


def shard_leaf(x: torch.Tensor, dim: Optional[int], parts: int, index: int) -> torch.Tensor:
    """Rank ``index`` of ``parts``'s contiguous slice of ``x`` along ``dim``
    (a new tensor, so the whole leaf can be freed); ``dim`` None: ``x``."""
    if dim is None:
        return x
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {parts}")
    n = size // parts
    return x.narrow(dim, index * n, n).clone(memory_format=torch.contiguous_format)


def _blocks(shape, dim: int) -> int:
    """Rows of the ``(rows, rest)`` view of a leaf split along ``dim``:
    the product of the dims before it.  Each rank's slice is one contiguous
    run of every row, so a slice is contiguous as ``(rows, rest / N)``."""
    a = 1
    for d in shape[:dim]:
        a *= d
    return a


def gather_leaf(x: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """The whole leaf, contiguous, from each rank's slice along ``dim``.

    The slices are stacked rank after rank (``all_gather_into_tensor``
    moves them as they lie), then one copy interleaves them row by row, the
    ``(ranks, rows, rest)`` stack read as ``(rows, ranks, rest)``; over one
    rank, or split along dim 0, that is a view and nothing is copied.
    """
    if dim is None:
        return x
    if is_plain(group):
        out = gather_leaf_plain(group.exchange(x), dim)
        group.record("all-gather", out)
        return out
    n = group_size(group)
    flat = x.reshape(-1)
    # a gather moves bits and does no arithmetic: 16-bit floats travel as
    # bytes, which every backend carries (gloo has no bf16)
    bits = flat.view(torch.uint8) if flat.element_size() == 2 else flat
    out = torch.empty(n * bits.numel(), dtype=bits.dtype, device=x.device)
    if is_counting(group):
        group.record("all-gather", out)
    else:
        _collective("all_gather_single", "all_gather_into_tensor")(out, bits, group=group)
    whole = list(x.shape)
    whole[dim] *= n
    rows = _blocks(x.shape, dim)
    return out.view(x.dtype).view(n, rows, -1).transpose(0, 1).reshape(whole)


def scatter_grad(g: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """Σ over the ranks of their whole gradients ``g``; each rank keeps its
    slice along ``dim`` (``dim`` None: the whole sum, all-reduced).  The
    slices are laid rank after rank for ``reduce_scatter_tensor`` by one
    copy, none over one rank or along dim 0; the result is the rank's slice
    as it lies."""
    if dim is None:
        return all_reduce(g, "sum", group)
    if is_plain(group):
        out = scatter_grad_plain(group.exchange(g), dim)[group.index]
        group.record("reduce-scatter", out)
        return out
    n = group_size(group)
    rows = _blocks(g.shape, dim)
    src = g.reshape(rows, n, -1).transpose(0, 1).contiguous()
    part = list(g.shape)
    part[dim] //= n
    out = torch.empty(part, dtype=g.dtype, device=g.device)
    if is_counting(group):
        group.record("reduce-scatter", out)
    else:
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(
            out.view(-1), src.view(-1), op=_op("sum"), group=group)
    return out


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` by ``op`` (sum, max or min), in place
    where ``x`` is contiguous; returns the result.  ``group`` None: ``x``."""
    if group is None:
        return x
    if is_plain(group):
        group.record("all-reduce", x)
        return all_reduce_plain(group.exchange(x), op)
    out = x if x.is_contiguous() else x.contiguous()
    if is_counting(group):
        if op not in OPS:
            raise ValueError(f"unknown reduction {op!r}; one of {OPS}")
        group.record("all-reduce", out)
    else:
        _dist().all_reduce(out, op=_op(op), group=group)
    return out


def _axes_group(mesh, axes: Sequence[str]):
    """The mesh's group over ``axes`` where it holds one whose rank order is
    the tuple's mixed radix (the axes in mesh order), else None."""
    key = tuple(axes)
    groups = mesh.groups or {}
    if key in groups and key == tuple(a for a in mesh.axis_names if a in key):
        return groups[key]
    return None


def _gather_axes(x: torch.Tensor, dim: int, axes: Sequence[str], mesh) -> torch.Tensor:
    """``x`` gathered along ``dim`` over ``axes`` (mixed radix, the first
    the most significant): over their group where the mesh has one, else
    axis by axis from the least significant."""
    group = _axes_group(mesh, axes)
    if group is not None:
        return gather_leaf(x, dim, group)
    for a in reversed(tuple(axes)):
        x = gather_leaf(x, dim, mesh.group((a,)))
    return x


def _dp_first(layout) -> list:
    """``layout``'s splits, the data-parallel one first (FSDP's gather
    before the others, as the reference's two-axis layouts ran)."""
    return sorted(layout.splits, key=lambda s: s[1] != layout.dp)


def shard_block(x: torch.Tensor, layout, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf with ``layout`` on ``mesh``: along
    each split dimension its slice by its mixed-radix index over the
    split's axes; no traffic."""
    for dim, axes in layout.splits:
        x = shard_leaf(x, dim, mesh.extent(axes), mesh.index(axes))
    return x


def gather_block(x: torch.Tensor, layout, mesh) -> torch.Tensor:
    """The whole leaf on every rank from this rank's block: gathered along
    each split dimension over its axes, the data-parallel split first."""
    for dim, axes in _dp_first(layout):
        x = _gather_axes(x, dim, axes, mesh)
    return x


def _kept(storage, compute):
    """The ``model`` split that storage and compute share, if any."""
    return next((s for s in compute.splits if s in storage.splits), None)


def to_compute(x: torch.Tensor, storage, compute, mesh) -> torch.Tensor:
    """This rank's compute block of a leaf (``compute``: its ``model``
    split alone, :func:`~repro_torch.sharding.context.compute_layout`) from
    its block under ``storage`` (any layout of the parameter rules): every
    storage split the compute layout does not share gathered, then the
    compute block cut, which moves nothing.  Under the default rules that
    is FSDP's one gather over the data-parallel group."""
    keep = _kept(storage, compute)
    for dim, axes in _dp_first(storage):
        if (dim, axes) != keep:
            x = _gather_axes(x, dim, axes, mesh)
    for dim, axes in compute.splits:
        if (dim, axes) != keep:
            x = shard_leaf(x, dim, mesh.extent(axes), mesh.index(axes))
    return x


def to_storage(g: torch.Tensor, storage, compute, mesh) -> torch.Tensor:
    """The storage block of a gradient from this rank's compute block of
    it, summed over the data-parallel ranks (each holds its rows' sum; the
    ranks of one data-parallel coordinate hold the same one).

    The compute block is gathered over ``model`` into the whole leaf where
    storage does not keep its split, then reduce-scattered over the
    data-parallel axes along the storage dimension they cut (all-reduced
    over those that cut none) and cut to the rank's part along every other
    storage axis.  Under the default rules that is one reduce-scatter over
    the data-parallel group (:func:`scatter_grad`)."""
    dp = storage.dp
    keep = _kept(storage, compute)
    for dim, axes in compute.splits:
        if (dim, axes) != keep:
            g = _gather_axes(g, dim, axes, mesh)
    coords = mesh.coords()
    for dim, axes in storage.splits:
        if (dim, axes) == keep:
            continue
        if axes == dp:   # FSDP's one reduce-scatter over the data-parallel group
            g = scatter_grad(g, dim, mesh.group(dp))
            continue
        for a in axes:   # the most significant first: each a contiguous part
            g = (scatter_grad(g, dim, mesh.group((a,))) if a in dp
                 else shard_leaf(g, dim, mesh.shape[a], coords[a]))
    whole = tuple(a for a in dp if a not in storage.axes)
    if whole:   # summed over the data-parallel axes that cut no dimension
        group = _axes_group(mesh, whole)
        for grp in ([group] if group is not None else [mesh.group((a,)) for a in whole]):
            g = all_reduce(g, "sum", grp)
    return g


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in a new tensor of ``x``'s dtype;
    16-bit floats are summed in fp32 and rounded once (gloo carries no
    bf16)."""
    if x.element_size() == 2 and x.is_floating_point():
        return all_reduce(x.to(torch.float32), "sum", group).to(x.dtype)
    return all_reduce(x.clone(memory_format=torch.contiguous_format), "sum", group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group`` (the ``model``
    ranks, each of which holds the gradient's partial from its heads, ff
    columns or vocab rows).  ``group`` None, or a :class:`PlainGroup`
    (whose ranks' uses of ``x`` autograd sums): ``x``."""
    return x if group is None or is_plain(group) else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (each ``model`` rank's partial product);
    its gradient passes to every rank unchanged.  ``group`` None: ``x``."""
    if group is None:
        return x
    if is_plain(group):   # counted as sum_over moves it: 16-bit floats in fp32
        wide = x.element_size() == 2 and x.is_floating_point()
        group.record("all-reduce", torch.empty(x.shape, dtype=torch.float32, device="meta")
                     if wide else x)
        return reduce_from_model_plain(group.exchange(x))
    return _ReduceFromModel.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, which every rank of ``group`` holds alike from a combine that
    its graph does not show (a custom Function's forward that reduces over
    the ranks).  Over plain ranks, whose graphs are one, its gradient then
    reaches every rank's ``x``, as the sum of the ranks' partials in the
    backward does on real ranks; elsewhere it is ``x``."""
    if group is None or not is_plain(group):
        return x
    return x.detach() + sum(p - p.detach() for p in group.exchange(x))


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(memory_format=torch.contiguous_format), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), "sum",
                          ctx.group), None


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable on every rank:
    the gradient each rank receives is the sum of every rank's gradient of
    the result, so a loss that each rank weights by its own share reaches
    each rank's operand at the whole weight.  ``group`` None: ``x``."""
    if group is None:
        return x
    if is_plain(group):
        group.record("all-reduce", x)
        return sum_across_plain(group.exchange(x))
    return _SumAcross.apply(x, group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.index, ctx.n = dim, group_rank(group), group_size(group)
        return gather_leaf(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return shard_leaf(g, ctx.dim, ctx.n, ctx.index), None, None


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every ``model`` rank's slice of ``x`` along ``dim``, concatenated in
    rank order, on every rank; the gradient is this rank's slice of the
    result's, unsummed: the whole that every rank computes from the gathered
    tensor gives every rank the whole gradient, so a sum would count it once
    a rank.  ``group`` None: ``x``."""
    if group is None:
        return x
    dim = dim % x.dim()
    if is_plain(group):
        return gather_leaf(x, dim, group)
    return _GatherFromModel.apply(x, dim, group)


# ---------------------------------------------------------------------------
# host-side control: flags and small integers over the host group
# ---------------------------------------------------------------------------

def _host_int(x: int) -> torch.Tensor:
    return torch.tensor([int(x)], dtype=torch.int64)


def _host_group(group):
    if is_counting(group):
        raise ValueError("a dry-run's counting group has no host side: the flags are "
                         "not on a step's path")
    return group


def agree_any(flag: int, group) -> int:
    """The MAX of ``flag`` over ``group`` (a CPU all-reduce): nonzero on
    every rank once any rank's is, and the largest value itself (a signal
    number, say).  ``group`` None: ``flag``."""
    if group is None:
        return int(flag)
    t = _host_int(flag)
    _dist().all_reduce(t, op=_op("max"), group=_host_group(group))
    return int(t.item())


def broadcast_int(x: int, group, src: int = 0) -> int:
    """Rank ``src``'s ``x`` on every rank of ``group`` (``src`` is a rank
    of the run's world).  ``group`` None: ``x``."""
    if group is None:
        return int(x)
    t = _host_int(x)
    _dist().broadcast(t, src=src, group=_host_group(group))
    return int(t.item())


def barrier(group) -> None:
    """Wait until every rank of ``group`` has arrived.  ``group`` None:
    return at once."""
    if group is not None:
        _dist().barrier(group=_host_group(group))


# below any reading: the MAX over the ranks keeps rank 0's
_UNSET = -(2 ** 62)


def _ns(seconds: float) -> int:
    return int(round(seconds * 1e9))


def agree_clock(now: float, drain: bool, step_wall: float, group
                ) -> Tuple[float, bool, float]:
    """One reading of a serving loop's host state that every rank of
    ``group`` shares: rank 0's clock ``now``, whether any rank's ``drain``
    flag is up, and rank 0's ``step_wall`` (seconds).  The times travel as
    integer nanoseconds, so every rank reads the same float.  One int64
    all-reduce (MAX) of three entries over the host group, each rank but 0
    sending a floor under its clock; on a :class:`PlainGroup` its plain
    version over the ranks' readings.  ``group`` None, or a group of one
    rank: the arguments, and no collective."""
    if group is None or group_size(group) == 1:
        return now, bool(drain), step_wall
    if is_plain(group):
        return agree_clock_plain(group.exchange((now, drain, step_wall)))[group.index]
    first = group_rank(group) == 0
    t = torch.tensor([_ns(now) if first else _UNSET, int(bool(drain)),
                      _ns(step_wall) if first else _UNSET], dtype=torch.int64)
    _dist().all_reduce(t, op=_op("max"), group=_host_group(group))
    now_ns, flag, wall_ns = t.tolist()
    return now_ns / 1e9, bool(flag), wall_ns / 1e9


# ---------------------------------------------------------------------------
# plain versions: every rank's operand at once, in one process
# ---------------------------------------------------------------------------

def gather_leaf_plain(shards: Sequence[torch.Tensor], dim: Optional[int]) -> torch.Tensor:
    """Rank order's slices concatenated along ``dim``."""
    if dim is None:
        return shards[0]
    return torch.cat(list(shards), dim=dim)


def scatter_grad_plain(grads: Sequence[torch.Tensor], dim: Optional[int]
                       ) -> List[torch.Tensor]:
    """Each rank's share of the sum of ``grads``, in rank order."""
    total = torch.stack(list(grads)).sum(0)
    n = len(grads)
    return [shard_leaf(total, dim, n, i) for i in range(n)]


def copy_to_model_plain(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Every one of ``n`` ranks' operand: ``x`` itself, so that autograd
    sums their gradients into ``x``'s, as :func:`copy_to_model` does."""
    return [x] * n


def reduce_from_model_plain(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every rank's partial (in fp32 for 16-bit floats, rounded
    once); autograd gives each partial the sum's gradient unchanged."""
    stacked = torch.stack(list(xs))
    if stacked.element_size() == 2 and stacked.is_floating_point():
        return stacked.to(torch.float32).sum(0).to(stacked.dtype)
    return stacked.sum(0)


def all_reduce_plain(xs: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """The reduction of every rank's ``x`` by ``op``."""
    stacked = torch.stack(list(xs))
    if op == "sum":
        return stacked.sum(0)
    if op == "max":
        return stacked.amax(0)
    if op == "min":
        return stacked.amin(0)
    raise ValueError(f"unknown reduction {op!r}; one of {OPS}")


def sum_across_plain(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of every rank's operand; autograd gives each operand the
    sum's gradient, which every rank's share of a loss of the sum adds to."""
    return torch.stack(list(xs)).sum(0)


def agree_any_plain(flags: Sequence[int]) -> List[int]:
    """Every rank's agreed flag: the largest of ``flags``."""
    return [max(int(f) for f in flags)] * len(flags)


def broadcast_int_plain(xs: Sequence[int], src: int = 0) -> List[int]:
    """Every rank's copy of rank ``src``'s value."""
    return [int(xs[src])] * len(xs)


def barrier_plain(arrived: Sequence[bool]) -> bool:
    """Whether a barrier over ranks that ``arrived`` would return: all did."""
    return all(arrived)


def agree_clock_plain(readings: Sequence[Tuple[float, bool, float]]
                      ) -> List[Tuple[float, bool, float]]:
    """Every rank's agreed ``(now, drain, step_wall)`` from each rank's
    reading: rank 0's clock and wall time to the nanosecond, any rank's
    flag."""
    now, _, wall = readings[0]
    agreed = (_ns(now) / 1e9, any(bool(r[1]) for r in readings), _ns(wall) / 1e9)
    return [agreed] * len(readings)


def run_rank_threads(fns: Sequence[Callable[[], object]], barriers: Sequence[threading.Barrier],
                     timeout: float = 600.0) -> list:
    """``[fn() for fn in fns]``, each call on a thread of its own; a call
    that raises breaks every one of ``barriers`` (the plain groups' the
    ranks meet at) so that no other waits, and the first error (not a
    broken barrier) is raised."""
    out: list = [None] * len(fns)
    errors: list = []

    def abort() -> None:
        for b in barriers:
            b.abort()

    def one(r: int) -> None:
        try:
            out[r] = fns[r]()
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
            abort()

    threads = [threading.Thread(target=one, args=(r,), daemon=True) for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        abort()
        raise TimeoutError(f"plain ranks still running after {timeout} s")
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return out


def run_plain_ranks(fn: Callable[[PlainGroup], object], size: int,
                    timeout: float = 600.0, tally: Optional[CollectiveTally] = None) -> list:
    """``[fn(group) for each of size ranks]``, each call on a thread of its
    own with its :class:`PlainGroup`, in rank order.  A rank that raises
    breaks the barrier so that no other waits; the first error (not a
    broken barrier) is raised.  Only the forward belongs on the threads:
    the caller runs one backward pass over the joined graph (on the card,
    autograd runs every graph's device work on one thread, where ranks
    meeting at a barrier would wait for each other forever).  With
    ``tally``, rank 0's collectives count into it (:class:`PlainRanks`)."""
    ranks = PlainRanks(size, timeout, tally)
    return run_rank_threads([lambda r=r: fn(PlainGroup(ranks, r)) for r in range(size)],
                            [ranks.barrier], timeout)
