"""Concrete placement: specs for whole train states, the rank's rows of a
batch, and per-rank state bytes (port of ``repro.sharding.placement``).

Conventions, as in the reference:

  * optimizer moment trees (``mu``/``nu``/``momentum``/``accum``) mirror
    their parameter's spec leaf for leaf (FSDP shards the whole optimizer,
    the O(N) win for LAMB's two extra moment buffers);
  * scalar state (schedule counts, the step counters) is replicated;
  * batches split their leading (batch) dimension over the data axes: each
    micro-batch of the step's accumulation is one contiguous run of the
    global batch's rows, and each rank holds one contiguous block of each
    (:func:`rank_rows`), as GSPMD shards each of the reference's
    micro-batches;
  * a batch's fields and a cache's leaves resolve their logical axes
    through the activation rules (:func:`batch_shardings`,
    :func:`cache_shardings`: the dry-run's placement); a serving batch's
    rows split over the data-parallel ranks where the rules split them and
    are every rank's where they do not (:func:`serving_rows`, GSPMD's
    replication of a batch of one), and a rank's cache is the block its
    specs give it, allocated at the block's shapes (:func:`cache_block`).

States are the port's trees (flat parameter dicts inside dataclasses);
specs come back as ``{path: spec}`` under the checkpoint's leaf paths
(``params/<p>``, ``opt_state/mu/<p>``, ``opt_state/1/count``, ``step``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import tree_leaves_with_paths, tree_map_with_paths
from repro_torch.sharding.axes import Spec, batch_axes, dp_size, resolve_spec, specs_for
from repro_torch.sharding.collectives import all_reduce, gather_block, shard_block
from repro_torch.sharding.context import Layout, ShardCtx, leaf_layout

# Logical axes of every named model input, keyed by batch-dict field.
BATCH_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "frame_embeds": ("batch", "seq", None),
    "image_embeds": ("batch", None, None),
}


def batch_shardings(batch: Mapping[str, torch.Tensor], mesh, rules) -> Dict[str, Spec]:
    """``{field: spec}`` of a model input dict: each field's logical axes
    (:data:`BATCH_AXES`) resolved through the activation rules ``rules``,
    so a rule override can split ``seq`` too."""
    return {k: resolve_spec(v.shape, BATCH_AXES[k], rules, mesh) for k, v in batch.items()}


def _cache_leaf_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of a KV / SSM cache leaf, keyed by its trailing name
    (every leaf leads with its stacked layers or groups).  The reference's
    table keys the cells' ``c`` and ``m`` by the mLSTM's shapes, so its
    sLSTM ``c`` and ``m`` (B, H, Dh) fall back to replicated; the port
    splits every cell leaf (B, H, …) by its heads, as its cell runs on the
    rank's heads."""
    name = path.rsplit("/", 1)[-1]
    lead = (None,)
    if name in ("c", "n", "m", "h") and ndim >= 3:
        return lead + ("batch", "heads") + (None,) * (ndim - 3)
    table = {
        "k": lead + ("batch", "cache_seq", "kv_heads", None),
        "v": lead + ("batch", "cache_seq", "kv_heads", None),
        "c_kv": lead + ("batch", "cache_seq", None),
        "k_rope": lead + ("batch", "cache_seq", None),
        "index": lead,
        "ssm": lead + ("batch", "inner", None),
        "conv": lead + ("batch", None, "inner"),
    }
    axes = table.get(name)
    if axes is None or len(axes) != ndim:
        return tuple([None] * ndim)
    return axes


def cache_shardings(cache, mesh, rules) -> Dict[str, Spec]:
    """``{path: spec}`` of every leaf of a ``make_cache`` tree (the
    reference's NamedSharding tree): each leaf's logical axes
    (:func:`_cache_leaf_axes`) resolved through the activation rules.
    :func:`leaf_dims` gives their layouts."""
    return {p: resolve_spec(x.shape, _cache_leaf_axes(p, x.dim()), rules, mesh)
            for p, x in tree_leaves_with_paths(cache)}


# the value every element of a fresh cache leaf holds, by its trailing name:
# the xLSTM cells' stabiliser ``m`` starts at the reference's -1e9, every
# other leaf (k/v, latents, SSM and cell state, the index) at 0
CACHE_FILL: Dict[str, float] = {"m": -1e9}


def cache_block(cache, mesh, rules, device):
    """This rank's block of ``cache`` (a whole ``make_cache`` tree, meta
    tensors enough) under :func:`cache_shardings`: on the meta device its
    block's shapes, else a fresh cache allocated at them on ``device``
    (each leaf filled as :data:`CACHE_FILL` says).  The whole cache is
    never allocated."""
    layouts = leaf_dims(cache_shardings(cache, mesh, rules), mesh)
    device = torch.device(device)

    def block(path, x):
        shape = shard_block(x.to("meta"), layouts[path], mesh).shape
        if device.type == "meta":
            return torch.empty(shape, dtype=x.dtype, device=device)
        fill = CACHE_FILL.get(path.rsplit("/", 1)[-1], 0)
        return torch.full(shape, fill, dtype=x.dtype, device=device)

    return tree_map_with_paths(block, cache)


def serving_rows(n: int, mesh, rules) -> Tuple[int, int, bool]:
    """``(first row, rows, split)`` of this rank's share of an ``n``-row
    serving batch: its block where the activation rules split ``batch``
    over every data-parallel axis (``split`` True), every row where they
    split it over none (a batch the ranks do not divide, as GSPMD
    replicates it).  A batch the rules split over only some of those axes
    raises ``ValueError``."""
    spec = resolve_spec((n, 1), BATCH_AXES["tokens"], rules, mesh)
    entry = spec[0] if spec else None
    axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    if not axes:
        return 0, n, False
    if axes != batch_axes(mesh):
        raise ValueError(f"a batch of {n} rows splits over {axes} but not over every "
                         f"data-parallel axis {batch_axes(mesh)}")
    start, rows = batch_rows(n, mesh)
    return start, rows, True


def cache_seq_split(cache, specs: Mapping[str, Spec]) -> bool:
    """Whether ``specs`` split any leaf of ``cache`` along its
    ``cache_seq`` dimension (long-context decode at batch 1)."""
    for p, x in tree_leaves_with_paths(cache):
        axes = _cache_leaf_axes(p, x.dim())
        if "cache_seq" in axes:
            i = axes.index("cache_seq")
            if i < len(specs[p]) and specs[p][i] is not None:
                return True
    return False


def serving_ctx(ctx: ShardCtx, param_specs, cache, batch: int) -> ShardCtx:
    """The context a prefill or decode of ``batch`` rows over ``cache`` (the
    whole ``make_cache`` tree, meta tensors enough) runs under on ``ctx``'s
    mesh and rules: the parameters' ``param_specs``, ``rows_split`` where
    the rules split the batch's rows over the data-parallel ranks, and
    ``cache_seq_split`` where the cache's specs split its sequence."""
    mesh, rules = ctx.mesh, ctx.act_rules
    split = serving_rows(batch, mesh, rules)[2]
    seq = cache_seq_split(cache, cache_shardings(cache, mesh, rules))
    return ShardCtx(mesh, rules, param_specs, cache_seq_split=seq, rows_split=split)


def batch_rows(n: int, mesh) -> Tuple[int, int]:
    """``(first row, rows)`` of this rank's block of an ``n``-row global
    batch (the counterpart of the reference's ``batch_sharding``); raises
    ``ValueError`` when ``n`` does not divide over the data-parallel ranks."""
    dp = dp_size(mesh)
    if n % dp:
        raise ValueError(
            f"global batch {n} is not divisible by the mesh's data-parallel "
            f"size {dp} (axes {batch_axes(mesh)}); examples would be dropped")
    rows = n // dp
    return mesh.index(batch_axes(mesh)) * rows, rows


def rank_rows(n: int, mesh, accum_steps: int = 1) -> np.ndarray:
    """The row indices of this rank's share of an ``n``-row global batch
    that the step cuts into ``accum_steps`` micro-batches: the rank's block
    of each micro-batch in turn, so that its i-th micro-batch holds global
    rows ``[i·n/a + r·n/(a·dp), …)``, rank r's block of the reference's
    i-th micro-batch.  Raises ``ValueError`` when ``n`` does not divide
    into the micro-batches and over the data-parallel ranks."""
    if n % accum_steps:
        raise ValueError(f"global batch {n} is not divisible by accum_steps "
                         f"{accum_steps}; remainder examples would be dropped")
    micro = n // accum_steps
    start, rows = batch_rows(micro, mesh)
    return np.concatenate([np.arange(i * micro + start, i * micro + start + rows)
                           for i in range(accum_steps)])


def opt_state_shardings(opt_state, param_specs: Mapping[str, Spec], mesh=None
                        ) -> Dict[str, Spec]:
    """Specs of every optimizer-state leaf, by path suffix.

    Moment trees reuse their parameter's spec; scalars (schedule counts)
    replicate.  The suffix match is component-boundary aware:
    ``mu/mask_embed`` must not hit the ``embed`` parameter.
    """
    by_path = list(param_specs.items())

    def match(path: str, leaf) -> Spec:
        if getattr(leaf, "ndim", 0) == 0:
            return ()
        for ppath, spec in by_path:
            if path == ppath or path.endswith("/" + ppath):
                return spec
        return ()

    return {p: match(p, leaf) for p, leaf in tree_leaves_with_paths(opt_state)}


def train_state_shardings(defs, state, mesh, rules: Optional[Mapping] = None
                          ) -> Dict[str, Spec]:
    """Specs of every leaf of a ``TrainState`` (params, opt_state, the
    counters), under the checkpoint's paths.  Works for any optimizer state
    layout (fused ``FusedLambState`` or a transform chain): moment leaves
    match their parameters by path suffix, not by structure."""
    pspecs = specs_for(defs, mesh, rules)
    out: Dict[str, Spec] = {}
    for path, _ in tree_leaves_with_paths(state):
        head, _, rest = path.partition("/")
        if head == "params":
            out[path] = pspecs[rest]
    out.update({f"opt_state/{p}": s
                for p, s in opt_state_shardings(state.opt_state, pspecs, mesh).items()})
    for path, _ in tree_leaves_with_paths(state):
        out.setdefault(path, ())
    return out


def leaf_dims(specs: Mapping[str, Spec], mesh) -> Dict[str, Layout]:
    """``{path: layout}``: the dimensions each leaf splits over the
    data-parallel ranks and over ``model`` (see
    :func:`~repro_torch.sharding.context.leaf_layout`)."""
    return {p: leaf_layout(s, mesh) for p, s in specs.items()}


def shard_tree(tree, layouts: Mapping[str, Layout], mesh):
    """A whole tree cut to this rank's blocks (no traffic; on an abstract
    mesh, rank 0's)."""
    return tree_map_with_paths(
        lambda p, x: shard_block(x, layouts.get(p, Layout()), mesh)
        if isinstance(x, torch.Tensor) else x, tree)


def gather_tree(tree, layouts: Mapping[str, Layout], mesh):
    """The whole tree on every rank, gathered leaf by leaf over both axes."""
    return tree_map_with_paths(
        lambda p, x: gather_block(x, layouts.get(p, Layout()), mesh)
        if isinstance(x, torch.Tensor) else x, tree)


def per_device_state_bytes(tree, mesh=None) -> int:
    """Resident bytes of a tree's tensors on this rank, and with a concrete
    ``mesh`` the largest over its ranks (the FSDP win: the reference's
    suite asks at least 4× at ``data=8``).  Meta tensors count their size,
    so a layout is measured without allocating it; other leaves count 0."""
    total = sum(x.numel() * x.element_size() for _, x in tree_leaves_with_paths(tree)
                if isinstance(x, torch.Tensor))
    if mesh is None or mesh.abstract or mesh.size == 1:
        return int(total)
    t = torch.tensor([total], dtype=torch.int64,
                     device=_group_device(mesh))
    return int(all_reduce(t, "max", mesh.group(mesh.axis_names)).item())


def _group_device(mesh) -> torch.device:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
