"""Meshes over the processes of a ``torch.distributed`` run (port of
``repro.launch.mesh``).

A :class:`Mesh` names its axes and their sizes in order (``data=4,model=1``)
and, once :func:`init_distributed` has made it from a process group, holds
this process's rank and one process group per axis (ranks laid out
row-major over the axes, as ``jax.make_mesh`` lays out devices).  Without
groups it is abstract: names and sizes only, enough for ``resolve_spec`` /
``specs_for`` to plan a layout on one machine for any number of ranks.

One rank drives one device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU over
gloo when the caller asked for ``--device cpu``.  Nothing falls back from one
backend to the other.

:func:`make_production_mesh` is the reference's paper-scale mesh
(``data=16,model=16``, or ``pod=2,data=16,model=16``), abstract;
:func:`counting_mesh` gives a mesh rank 0's groups of
:class:`~repro_torch.sharding.collectives.CountingGroup`, which count what
a step would move and call nothing (the dry-run's mesh);
:func:`run_plain_mesh` runs every rank of a mesh as a thread of one
process, its groups plain groups (one card, or the CPU in a test).
"""
from __future__ import annotations

import itertools
import os
import socket
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import torch


class Mesh:
    """Axis names and sizes, and (when concrete) this rank and its groups.

    ``shape`` maps each axis name to its size, in mesh order.  ``groups``
    maps an axis name, or a tuple of axis names, to the process group of the
    ranks that share this rank's coordinates on every other axis; ``None``
    makes the mesh abstract.  ``host_group`` (concrete meshes) spans every
    rank over gloo: control flags and small integers on CPU tensors, never
    a device tensor.
    """

    def __init__(self, shape: Mapping[str, int], *, rank: int = 0,
                 groups: Optional[Dict] = None):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in shape.items()}
        self.rank = int(rank)
        self.groups = groups
        self.host_group = None
        n = self.size
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {rank} is outside a mesh of {n} ranks")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def abstract(self) -> bool:
        return self.groups is None

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Row-major coordinates of ``rank`` (default: this rank) per axis."""
        r = self.rank if rank is None else rank
        out: Dict[str, int] = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position along the combined ``axes`` (row-major)."""
        c = self.coords()
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def extent(self, axes: Sequence[str]) -> int:
        """Number of ranks along the combined ``axes``."""
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank along ``axes`` (a name or a tuple)."""
        if self.groups is None:
            raise ValueError("an abstract mesh has no process groups")
        key = _key(axes)
        if key not in self.groups:
            raise KeyError(f"no process group over axes {key} (mesh {self.shape})")
        return self.groups[key]

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else f"rank={self.rank}"
        return f"Mesh({self.shape}, {kind})"


def _key(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def abstract_mesh(shape: Sequence[int], names: Sequence[str]) -> Mesh:
    """A mesh of names and sizes only (no ranks, no groups)."""
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} sizes for {len(names)} axis names")
    return Mesh(dict(zip(names, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The paper-scale mesh, abstract: ``data=16,model=16`` (256 ranks),
    or ``pod=2,data=16,model=16`` (512) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def counting_mesh(mesh: Mesh, tally) -> Mesh:
    """Rank 0 of ``mesh`` with the groups a run would make
    (:func:`init_distributed`'s: one per axis, one over the data-parallel
    axes, one over every axis), each a ``CountingGroup`` that adds what
    its collectives move to ``tally``.  No process group is made."""
    from repro_torch.sharding.axes import batch_axes
    from repro_torch.sharding.collectives import CountingGroup

    out = Mesh(mesh.shape)
    axes_list = [(a,) for a in out.axis_names] + [batch_axes(out), out.axis_names]
    out.groups = {axes: CountingGroup(axes, out.extent(axes), tally)
                  for axes in axes_list if axes}
    return out


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse a ``--mesh`` string like ``"data=4,model=2"`` into axis sizes.

    Axis order in the string is preserved (it becomes the mesh axis order);
    sizes must be positive integers.
    """
    out: Dict[str, int] = {}
    for item in spec.split(","):
        name, eq, val = item.strip().partition("=")
        if not eq or not name:
            raise ValueError(
                f"bad mesh axis {item!r} in {spec!r}; expected name=size"
            )
        try:
            size = int(val)
        except ValueError:
            raise ValueError(f"mesh axis {name!r} size {val!r} is not an int")
        if size < 1:
            raise ValueError(f"mesh axis {name!r} size must be >= 1, got {size}")
        if name in out:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        out[name] = size
    return out


def _world() -> Tuple[int, int, int]:
    """``(rank, world size, local rank)``: the process group's when one is
    up, else torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (a
    process started alone is rank 0 of 1)."""
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1")), local


def make_mesh_from_spec(spec: str, *, world_size: Optional[int] = None) -> Mesh:
    """An abstract mesh from a ``--mesh`` string, checked against the ranks
    there are (``world_size``, default the run's): asking for more raises a
    ``ValueError`` naming the count, as the reference does for devices."""
    axes = parse_mesh_spec(spec)
    mesh = Mesh(axes)
    n = _world()[1] if world_size is None else world_size
    if mesh.size > n:
        raise ValueError(
            f"mesh {spec!r} needs {mesh.size} devices but only {n} are available"
        )
    return mesh


def make_host_mesh(model_parallel: int = 1, *, world_size: Optional[int] = None) -> Mesh:
    """``(data, model)`` mesh over every rank of the run: ``model_parallel``
    of them form the ``model`` axis and the rest fan out over ``data``."""
    n = _world()[1] if world_size is None else world_size
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must be a positive divisor of "
            f"the device count ({n} available)"
        )
    return Mesh({"data": n // model_parallel, "model": model_parallel})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _axis_groups(mesh: Mesh, axes_list: Iterable[Tuple[str, ...]]) -> Dict:
    """One group per entry of ``axes_list`` holding this rank: every rank
    makes every group, in the same order (``new_group`` is collective); a
    group that spans the whole world is the default group."""
    import torch.distributed as dist

    names = mesh.axis_names
    out: Dict = {}
    for axes in axes_list:
        if axes in out:
            continue
        if mesh.extent(axes) == mesh.size:
            out[axes] = dist.group.WORLD
            continue
        others = [a for a in names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
            ranks = [r for r in range(mesh.size)
                     if all(mesh.coords(r)[a] == v for a, v in zip(others, fixed))]
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                mine = g
        out[axes] = mine
    return out


def init_distributed(device, spec: str = "", *, model_parallel: int = 1
                     ) -> Tuple[Mesh, torch.device]:
    """Join (or start) the run's process group and build its mesh.

    Reads torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; a process
    started alone is rank 0 of a group of one on a free ``localhost`` port.
    ``device`` of type ``cuda`` takes NCCL on ``cuda:LOCAL_RANK``; ``cpu``
    takes gloo; nothing else is accepted, and nothing falls back.  ``spec``
    is a ``--mesh`` string (default: :func:`make_host_mesh` of
    ``model_parallel`` over every rank); it must use every rank of the run
    and raises ``ValueError`` when it needs more.  Returns the concrete mesh
    (one process group per axis, and one over the data-parallel axes) and
    this rank's device.  Beside the device world it makes one host group
    over every rank (gloo, CPU tensors; over gloo ranks the world itself),
    through which the ranks agree on flags without a device launch.
    """
    import torch.distributed as dist

    from repro_torch.sharding.axes import batch_axes

    dev = torch.device(device)
    if dev.type == "cuda":
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    rank, world, local = _world()
    mesh = (make_mesh_from_spec(spec, world_size=world) if spec
            else make_host_mesh(model_parallel, world_size=world))
    if mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} uses {mesh.size} of the run's {world} "
                         "ranks; every rank must be in the mesh")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to "
                               "run on the CPU over gloo")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "MASTER_ADDR" in os.environ:
            init = "env://"
        elif world == 1:
            init = f"tcp://localhost:{_free_port()}"
        else:
            raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR: start the "
                               "run with torch.distributed.run (torchrun)")
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, device "
                           f"{dev} needs {backend}")
    mesh = Mesh(mesh.shape, rank=dist.get_rank())
    axes_list = [(a,) for a in mesh.axis_names] + [batch_axes(mesh), mesh.axis_names]
    mesh.groups = _axis_groups(mesh, [a for a in axes_list if a])
    mesh.host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return mesh, dev


def run_plain_mesh(fn, shape: Mapping[str, int], timeout: float = 600.0) -> list:
    """``[fn(mesh) for each rank of a mesh of shape]``, the ranks threads of
    one process (``collectives.run_rank_threads``), in rank order.  Each
    rank's mesh holds the groups :func:`init_distributed` makes, one over
    each axis, one over the data-parallel axes and one over every axis, each
    a :class:`~repro_torch.sharding.collectives.PlainGroup` (every
    collective is its plain version over the ranks' tensors); the one over
    every axis is also its ``host_group``.  A rank that raises breaks every
    group's barrier, and the first error is raised."""
    from repro_torch.sharding.axes import batch_axes
    from repro_torch.sharding.collectives import PlainGroup, PlainRanks, run_rank_threads

    meshes = [Mesh(shape, rank=r) for r in range(Mesh(shape).size)]
    names = meshes[0].axis_names
    axes_list = [(a,) for a in names] + [batch_axes(meshes[0]), names]
    shared: Dict = {}
    for mesh in meshes:
        mesh.groups = {}
        for axes in (a for a in axes_list if a):
            fixed = tuple(mesh.coords()[a] for a in names if a not in axes)
            ranks = shared.setdefault((axes, fixed), PlainRanks(mesh.extent(axes), timeout))
            mesh.groups[axes] = PlainGroup(ranks, mesh.index(axes))
        mesh.host_group = mesh.groups[names]
    return run_rank_threads([lambda m=m: fn(m) for m in meshes],
                            [g.barrier for g in shared.values()], timeout)


def shutdown_distributed() -> None:
    """Tear down the default process group, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
