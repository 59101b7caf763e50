"""Logical-axis → mesh-axis resolution (port of ``repro.sharding.axes``).

Every Param carries logical axis names ("embed", "heads", "ff", "experts",
...).  A *rule set* maps logical names to mesh axes; :func:`resolve_spec`
turns a (shape, axes) pair into a spec, enforcing the reference's rules:

  * a mesh axis may appear at most once per spec,
  * a dimension must be divisible by the product of its mesh-axis sizes
    (otherwise mesh axes are dropped from the end, down to replication).

A spec is a tuple with one entry per leading dimension (trailing
replicated dimensions trimmed), each ``None``, a mesh-axis name or a tuple
of them: the entries of the reference's ``PartitionSpec``.  Only the mesh's
axis sizes are read, so an abstract mesh (or a plain ``{name: size}``
mapping) plans a layout for any number of ranks.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch import nn

MeshAxes = Optional[Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def default_param_rules(multi_pod: bool = False) -> dict:
    """Default logical→mesh rules for *parameters*.

    FSDP: the ``embed`` axis (present in every matmul weight) shards over
    the data axes — ``("data",)``, or ``("pod", "data")`` when
    ``multi_pod`` — so each data-parallel rank holds ``1/N`` of the params
    and optimizer moments.  Tensor/expert parallelism: head, ff and expert
    axes shard over ``model``.  Axes mapped to ``None`` always replicate.
    """
    fsdp = ("pod", "data") if multi_pod else ("data",)
    return {
        "vocab": ("model",),
        "embed": fsdp,
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "expert_ff": None,
        "head_dim": None,
        "qk_dim": None,
        "v_dim": None,
        "kv_lora": None,
        "q_lora": None,
        "inner": ("model",),   # mamba/xlstm expanded inner dim
        "state": None,
        "conv": None,
        "mtp": None,
        nn.LAYERS_AXIS: None,
    }


def override_rules(rules: Mapping, overrides: Sequence[str]) -> dict:
    """``rules`` with each ``name=a,b`` of ``overrides`` replacing its entry
    (an empty value replicates that logical axis), as the reference's
    dry-run reads ``--act-rule`` and ``--param-rule``."""
    out = dict(rules)
    for item in overrides:
        k, _, v = item.partition("=")
        out[k] = tuple(x for x in v.split(",") if x) or None
    return out


def default_act_rules(multi_pod: bool = False) -> dict:
    """Default logical→mesh rules for *activations* (data parallel over
    ``batch``, tensor parallel over head/ff/expert/vocab axes)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": None,
        "cache_seq": None,      # overridden to ("data",) for long-context decode
        "embed": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
    }


def _normalize(rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def mesh_sizes(mesh) -> Mapping[str, int]:
    """``{axis: size}`` of a :class:`~repro_torch.launch.mesh.Mesh` (its
    ``shape``) or of a plain mapping."""
    return mesh.shape if hasattr(mesh, "shape") else mesh


def resolve_spec(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    rules: Mapping[str, MeshAxes],
    mesh,
) -> Spec:
    """Resolve one tensor's logical axes into a spec.

    ``shape`` and ``axes`` run in parallel (one logical name — or ``None``
    — per dimension); ``rules`` maps logical names to mesh-axis tuples and
    ``mesh`` supplies the axis sizes.  No mesh axis appears twice, and a
    dimension not divisible by its mesh-axis product drops trailing axes
    (down to full replication).
    """
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        mesh_axes = _normalize(rules.get(name)) if name is not None else ()
        # drop axes not in the mesh (e.g. "pod" on a single-pod mesh), and
        # axes an earlier dimension already took
        mesh_axes = tuple(a for a in mesh_axes if a in sizes and a not in used)
        # drop trailing axes until the dim is divisible
        while mesh_axes:
            total = 1
            for a in mesh_axes:
                total *= sizes[a]
            if dim % total == 0 and dim > 0:
                break
            mesh_axes = mesh_axes[:-1]
        if mesh_axes:
            used.update(mesh_axes)
            out.append(mesh_axes[0] if len(mesh_axes) == 1 else tuple(mesh_axes))
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def specs_for(defs, mesh, rules: Optional[Mapping] = None) -> Dict[str, Spec]:
    """``{path: spec}`` over every Param of a definition tree, by its
    declared logical axes; ``rules`` defaults to :func:`default_param_rules`
    (FSDP + TP) for the mesh's pod structure."""
    if rules is None:
        rules = default_param_rules(multi_pod="pod" in mesh_sizes(mesh))
    return {path: resolve_spec(p.shape, p.axes, rules, mesh)
            for path, p in nn.flatten(defs).items()}


def batch_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes present on ``mesh`` (``pod`` before ``data``):
    the axes the batch dimension splits over."""
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def dp_size(mesh) -> int:
    """Data-parallel way count: the product of the :func:`batch_axes`
    sizes, the divisor every global batch must be a multiple of."""
    sizes = mesh_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n
