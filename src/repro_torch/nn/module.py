"""Functional parameter definitions (port of ``repro.nn.module``).

Models declare parameters as nested dicts of :class:`Param`.  Concrete
parameters live in a flat ``dict[str, Tensor]`` keyed by the JAX package's
dotted paths (``"blocks/attn/wq"``), in the JAX leaf order (sorted keys),
with the JAX layouts and stacked ``(layers, ...)`` leaves — so weights move
between the two packages by path alone (see :mod:`repro_torch.nn.bridge`)
and the per-layer LAMB trust ratios carry over unchanged.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

LAYERS_AXIS = "layers"

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: Any) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (torch dtypes pass through)."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of a single weight tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed | uniform_scalar
    dtype: str = "float32"
    scale: float = 1.0
    no_weight_decay: bool = False
    no_trust_ratio: bool = False

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"Param shape {self.shape} and axes {self.axes} rank mismatch"
            )


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict → flat ``{"a/b/c": leaf}`` in JAX leaf order (sorted keys)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def subtree(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """``{"ln1/scale": ...}`` view of the ``prefix/``-paths of a flat dict."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def _map_params(fn: Callable[[str, Param], Any], defs) -> Dict[str, Any]:
    return {path: fn(path, p) for path, p in flatten(defs).items()}


def stack(defs, n_layers: int):
    """Prepend a stacked-layers axis to every Param in ``defs`` (nested)."""
    if isinstance(defs, Param):
        return dataclasses.replace(
            defs, shape=(n_layers,) + tuple(defs.shape),
            axes=(LAYERS_AXIS,) + tuple(defs.axes),
        )
    return {k: stack(v, n_layers) for k, v in defs.items()}


def _path_seed(seed: int, path: str) -> int:
    # same path hash as the JAX package's _fold_path: each leaf's draw
    # depends on (seed, path) only, never on the order leaves are made in
    h = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "little")
    return (seed * 0x9E3779B1 + h) % (2**63)


def _initialize(p: Param, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """The init laws of ``repro.nn.module._initialize`` on a torch Generator.

    Same distributions as JAX, not the same bits: normal × scale, a ±2σ
    truncated normal scaled by 1/sqrt(fan_in) with the fan-in taken from the
    second-to-last non-layer dim, and U(1e-3, 1) × scale.
    """
    shape = tuple(p.shape)
    dtype = torch_dtype(p.dtype)
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if p.init in ("embed", "normal"):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(p.scale).to(dtype)
    if p.init == "uniform_scalar":
        # SSM dt / A params: U(1e-3, 1) x scale, as the reference draws them
        u = 1e-3 + (1.0 - 1e-3) * torch.rand(shape, generator=gen, device=device,
                                              dtype=torch.float32)
        return u.mul_(p.scale).to(dtype)
    if p.init == "fan_in":
        dims = [d for d, a in zip(shape, p.axes) if a != LAYERS_AXIS]
        fan_in = dims[-2] if len(dims) >= 2 else dims[-1]
        std = p.scale / max(fan_in, 1) ** 0.5
        x = torch.empty(shape, device=device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        # in place: the largest leaves (deepseek-v3's experts, 15 GB in fp32)
        # leave no room for a second fp32 copy beside the model
        return x.mul_(std).to(dtype)
    raise ValueError(f"unknown init {p.init!r}")


def init_params(defs, seed: int, device: torch.device, dtype=None,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> Params:
    """Materialize a definition tree into a flat dict of tensors on ``device``.

    With ``dtype``, each floating leaf is cast to it as soon as it is drawn,
    before the next leaf is: the values are those of :func:`cast_tree` over
    the fp32 tree, and the peak is the cast tree plus one fp32 leaf.  With
    ``keep``, ``keep(path, leaf)`` replaces each leaf as soon as it is drawn
    (a data-parallel rank keeps its slice): the values are the whole
    tree's, and the peak is what is kept plus one whole leaf.  On the meta
    device nothing is drawn: each leaf is :func:`abstract_params`' (the
    dry-run's parameters).
    """
    dt = None if dtype is None else torch_dtype(dtype)
    abstract = torch.device(device).type == "meta"

    def make(path: str, p: Param) -> torch.Tensor:
        if abstract:
            x = _abstract(p)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(_path_seed(seed, path))
            x = _initialize(p, gen, device)
        x = x if dt is None or not x.is_floating_point() else x.to(dt)
        return x if keep is None else keep(path, x)

    return _map_params(make, defs)


def _abstract(p: Param) -> torch.Tensor:
    return torch.empty(tuple(p.shape), dtype=torch_dtype(p.dtype), device="meta")


def abstract_params(defs) -> Params:
    """Meta tensors of every leaf's shape and dtype: a dry-run's parameters,
    with no storage on any device and no draw (a generator cannot live on
    the meta device)."""
    return _map_params(lambda _, p: _abstract(p), defs)


def layer_axis_tree(defs) -> Dict[str, int]:
    """Index of the stacked-layers axis per leaf, -1 if unstacked."""
    return _map_params(
        lambda _, p: p.axes.index(LAYERS_AXIS) if LAYERS_AXIS in p.axes else -1,
        defs,
    )


def weight_decay_mask(defs) -> Dict[str, bool]:
    """True where weight decay applies (norm scales / biases skip it)."""
    return _map_params(lambda _, p: not p.no_weight_decay, defs)


def trust_ratio_mask(defs) -> Dict[str, bool]:
    """True where the layerwise trust ratio applies."""
    return _map_params(lambda _, p: not p.no_trust_ratio, defs)


def param_count(defs) -> int:
    total = 0
    for p in flatten(defs).values():
        n = 1
        for d in p.shape:
            n *= d
        total += n
    return total


def cast_tree(params: Params, dtype) -> Params:
    """Cast every floating leaf to ``dtype`` (others pass through)."""
    dt = torch_dtype(dtype)
    return {k: v.to(dt) if v.is_floating_point() else v for k, v in params.items()}
