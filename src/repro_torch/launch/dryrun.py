"""The production dry-run: one rank's step on meta tensors over the paper's
mesh, counted (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k [--multi-pod] [--optimizer lamb] [--set remat=full] \\
        [--act-rule name=a,b] [--param-rule name=a,b] [--moment-dtype bfloat16] \\
        [--tag x] [--out results.jsonl]

The reference lowers and compiles each (architecture × input shape) on a
faked 256- or 512-device mesh and reads XLA's cost and memory analyses.  The
port runs rank 0 of the production mesh (coordinate 0 on every axis): its
parameters, optimizer state, batch and cache are meta tensors cut to rank
0's blocks by the port's layouts, and the port's own step runs once on them
under four counters:

  * ``torch.utils.flop_counter.FlopCounterMode``: the aten ops' flops,
    each op's also under the type of its first floating operand
    (``kernels.cost.rate_of``), so that fp32 work meets fp32's peak;
  * a dispatch mode adding each aten op's operand and result bytes ("bytes
    accessed": views and allocation-only ops add none, an in-place op reads
    its operand once and writes it once) and tracking the storages made
    under it until they die, each rounded up to the caching allocator's
    512-byte block: the live bytes on top of the arguments give the peak;
  * each kernel's ``kernels/cost.py`` count, which the kernels' meta routes
    add in place of a launch (K1–K8);
  * the collectives of the mesh's counting groups
    (``sharding/collectives.CountingGroup``): operand bytes by kind and by
    the mesh axes each group spans.

A loop over time (``models/layers/scan.scan``, the xLSTM cells'
``lax.scan``) is counted from three of its steps, scaled to its length
(:class:`LoopCounter`): every count and the peak equal the unrolled
trace's, at a cost that does not grow with the loop.

Nothing is allocated on any device, no process group is made, and nothing
of JAX runs.  ``launch/roofline.py`` turns the counts into the H100's
compute, memory and collective terms.  A prefill or decode runs as one
rank of the static ``Engine`` on the mesh does (``placement.serving_ctx``):
its rows of the batch, its block of the cache (its kv heads, its ``inner``
slice, its block of positions under the ``cache_seq`` rule) and its
parameter blocks, stored as the parameter rules say (``--param-rule``)
and taken to the layers' layout.  Any error fails the record.
"""
from __future__ import annotations

import argparse
import json
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.io import tree_leaves_with_paths
from repro_torch.configs import get_config, get_shape, plan
from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch.mesh import counting_mesh, make_production_mesh
from repro_torch.launch.roofline import PEAK_OPS, analyze, model_flops
from repro_torch.models.api import build_model
from repro_torch.models.layers.scan import counted_by
from repro_torch.serve.engine import RankParams, make_decode_step, make_prefill_step
from repro_torch.sharding import (
    ShardCtx,
    batch_shardings,
    cache_block,
    default_act_rules,
    default_param_rules,
    leaf_dims,
    override_rules,
    serving_ctx,
    shard_tree,
    specs_for,
    use_sharding,
)
from repro_torch.sharding.collectives import CollectiveTally
from repro_torch.train.step import make_train_step

# the CUDA caching allocator's block: every allocation is rounded up to it
BLOCK = 512
# ops that only allocate: no bytes accessed
_ALLOCATING = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros",
})
# views whose schema does not say so: no bytes accessed
_VIEWS = frozenset({"_unsafe_view", "_reshape_alias", "lift_fresh"})
# ops that write their first operand without reading it
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_"})
# in-place ops that write only the rows their index names: the index and
# the source are read and the source's extent written, not the whole operand
_INDEXED_WRITE = frozenset({"index_copy_", "index_put_", "_index_put_impl_", "index_add_",
                            "scatter_", "scatter_add_", "scatter_reduce_"})


def _rounded(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaCounter(TorchDispatchMode):
    """Bytes accessed by the aten ops run under it, and the live and peak
    bytes of the storages they make (each rounded up to :data:`BLOCK`).
    Storages that exist before (the arguments, :meth:`known`) are not
    counted as made.  Entered inside ``flops`` (a ``FlopCounterMode``), it
    also sums each op's flops by the rate of its type (``flops_by_rate``)."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.flops_by_rate: Dict[str, int] = {}
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        # the storages alive: key -> (weak reference, rounded size, serial)
        self._tracked: Dict[int, Any] = {}
        self.serial = 0   # the storages made so far

    def known(self, tensors) -> None:
        for t in tensors:
            self._tracked.setdefault(t.untyped_storage()._cdata, None)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        size = _rounded(st.nbytes())

        def dead(_, key=key, size=size):
            self._tracked.pop(key, None)
            self.live -= size

        self._tracked[key] = (weakref.ref(st, dead), size, self.serial)
        self.serial += 1
        self.live += size
        self.peak = max(self.peak, self.live)

    def alive_made(self, first: int, end: int) -> int:
        """The rounded bytes of the storages made from serial ``first`` to
        ``end`` (exclusive) that are still alive."""
        return sum(e[1] for e in self._tracked.values()
                   if e is not None and first <= e[2] < end)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self.flops.get_total_flops()
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        added = self.flops.get_total_flops() - before
        accessed = not (func.is_view or name in _VIEWS or name in _ALLOCATING)
        if added or accessed:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if added:
            dtype = next((t.dtype for t in ins + outs if t.is_floating_point()), torch.float32)
            rate = kernel_cost.rate_of(dtype)
            self.flops_by_rate[rate] = self.flops_by_rate.get(rate, 0) + added
        if accessed:
            written = outs
            if name in _WRITE_ONLY:
                ins = ins[1:]
            elif name in _INDEXED_WRITE:
                ins, written = ins[1:], ins[-1:]
            seen = {id(t): t for t in ins}
            self.bytes_accessed += sum(_nbytes(t) for t in seen.values())
            self.bytes_accessed += sum(_nbytes(t) for t in written)
        for t in outs:
            self._track(t)
        return out


def _tensors(tree) -> list:
    return [x for _, x in tree_leaves_with_paths(tree) if isinstance(x, torch.Tensor)]


def _unique_bytes(tensors, rounded: bool = False) -> int:
    """Bytes of the distinct storages behind ``tensors`` (each tensor's own
    extent; with ``rounded``, each storage rounded up to :data:`BLOCK`)."""
    seen: Dict[int, int] = {}
    for t in tensors:
        key = t.untyped_storage()._cdata
        n = _rounded(t.untyped_storage().nbytes()) if rounded else _nbytes(t)
        seen[key] = max(seen.get(key, 0), n)
    return sum(seen.values())


class _Counts:
    """Every count of :func:`count` at once: the aten ops' flops (by module
    and op) and their flops by rate, the bytes accessed, the kernels'
    tallies and rates and the collectives' tally.  :meth:`snapshot` reads
    them as ``{path: number}``; :meth:`add` adds a difference of two
    snapshots ``n`` times."""

    def __init__(self, flops: FlopCounterMode, meta: MetaCounter, kernels: dict,
                 k_by_rate: dict, tally: Optional[CollectiveTally]):
        self.flops, self.meta, self.tally = flops, meta, tally
        self._dicts = {"by_rate": meta.flops_by_rate, "kernels": kernels,
                       "k_by_rate": k_by_rate}
        if tally is not None:
            self._dicts.update(kinds=tally.by_kind, axes=tally.by_axis)

    def snapshot(self) -> Dict[tuple, int]:
        out = {("bytes",): self.meta.bytes_accessed}
        for mod, ops in self.flops.flop_counts.items():
            out.update({("flops", mod, op): n for op, n in ops.items()})
        for name, d in self._dicts.items():
            for k, v in d.items():
                if isinstance(v, dict):
                    out.update({(name, k, f): n for f, n in v.items()})
                else:
                    out[(name, k)] = v
        if self.tally is not None:
            out[("count",)] = self.tally.count
        return out

    def add(self, after: Dict[tuple, int], before: Dict[tuple, int], n: int) -> None:
        for path, v in after.items():
            d = n * (v - before.get(path, 0))
            if not d:
                continue
            if path == ("bytes",):
                self.meta.bytes_accessed += d
            elif path == ("count",):
                self.tally.count += d
            elif path[0] == "flops":
                self.flops.flop_counts[path[1]][path[2]] += d
            elif len(path) == 3:
                entry = self._dicts[path[0]].setdefault(path[1], {})
                entry[path[2]] = entry.get(path[2], 0) + d
            else:
                self._dicts[path[0]][path[1]] = self._dicts[path[0]].get(path[1], 0) + d


class _Mark(torch.autograd.Function):
    """The identity on ``xs``, whose backward calls ``hook()`` first: in
    the backward of a counted loop it runs after every node made later
    than it and before every node made earlier (the engine runs the ready
    node made last first)."""

    @staticmethod
    def forward(ctx, hook, *xs):
        ctx.hook = hook
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        return (None, *grads)


class _Stacked(torch.autograd.Function):
    """The ``torch.stack`` of a loop's ``length`` outputs, of which the
    counted steps' ``ys`` are the first: an allocation, whose backward
    hands each counted step its slice."""

    @staticmethod
    def forward(ctx, length: int, dim: int, *ys):
        ctx.dim, ctx.n = dim, len(ys)
        shape = list(ys[0].shape)
        shape.insert(dim % (len(shape) + 1), length)
        return ys[0].new_empty(shape)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *(grad.select(ctx.dim, t) for t in range(ctx.n)))


# the steps a counted loop runs: the first (its carry made outside, its
# gradient not needed), a middle one and the last
LOOP_STEPS = 3


class LoopCounter:
    """Stands in for each loop over time (``models/layers/scan.scan``) of
    more than :data:`LOOP_STEPS` steps under :func:`count`, so that a
    trace of T positions costs what one of three does and counts what the
    unrolled loop does.

    It runs the first, a middle and the last step as the loop would and
    adds T - 3 times the middle step's counts: flops and flops by rate,
    bytes accessed, kernel tallies and collectives.  The first step differs
    (its carry, zeros and m = -1e9, needs no gradient) and the last is the
    one whose backward reaches the accumulated gradients first, so neither
    stands for the others.  ``torch.stack`` of the outputs is counted on the
    three and scaled to T; the result is an allocation of T.  In the
    backward, :class:`_Mark` nodes around the middle step take its counts,
    added T - 3 times.  The peak: the storages the middle step made that
    are still alive after the last (what autograd saved, the carry the next
    step saved, the output the loop keeps) stand in for the T - 3 others,
    as one meta allocation made after the last step (and the last step's
    peak raised by it), cut to what survives the stack after it and freed
    where the backward leaves the middle steps."""

    def __init__(self, counts: _Counts):
        self.counts = counts

    def __call__(self, step, carry, xs, dim: int, out_dim: int):
        length = xs[0].shape[dim]
        if length <= LOOP_STEPS or any(x.device.type != "meta" for x in xs):
            return None
        counts, meta = self.counts, self.counts.meta
        extra = length - LOOP_STEPS
        held: Dict[str, Any] = {}

        def after_middle():   # the backward reaches the middle step
            held["bwd"] = counts.snapshot()

        def before_middle():  # the backward leaves the middle step
            counts.add(counts.snapshot(), held.pop("bwd"), extra)
            held.pop("filler", None)

        hooks = (before_middle, after_middle)
        ys, serials, snaps = [], [], []
        for t in range(LOOP_STEPS):
            serials.append(meta.serial)
            snaps.append(counts.snapshot())
            if t == LOOP_STEPS - 1:
                peak, meta.peak = meta.peak, meta.live
            carry, y = step(carry, *(x.select(dim, t) for x in xs))
            if y is not None:
                ys.append(y)
            if t < LOOP_STEPS - 1:
                flat, spec = tree_flatten(carry)
                carry = tree_unflatten(list(_Mark.apply(hooks[t], *flat)), spec)
                del flat
            del y
        counts.add(snaps[2], snaps[1], extra)
        last_peak, meta.peak = meta.peak, max(peak, meta.peak)
        kept = extra * meta.alive_made(serials[1], serials[2])
        held["filler"] = torch.empty(kept, dtype=torch.uint8, device="meta")
        meta.peak = max(meta.peak, last_peak + kept)
        out = None
        if ys:
            before = counts.snapshot()
            torch.stack(ys, out_dim)
            after = counts.snapshot()
            per = {k: (v - before.get(k, 0)) // LOOP_STEPS for k, v in after.items()}
            counts.add(per, {}, extra)
            out = _Stacked.apply(length, out_dim, *ys)
            ys.clear()   # the loop's list of outputs dies with it
            held.pop("filler")
            kept = extra * meta.alive_made(serials[1], serials[2])
            held["filler"] = torch.empty(kept, dtype=torch.uint8, device="meta")
        return carry, out


def count(fn, args, *, sharding: Optional[ShardCtx] = None,
          tally: Optional[CollectiveTally] = None, loops: bool = True) -> Dict[str, Any]:
    """Run ``fn(*args)`` (meta tensors) once under ``sharding`` and the
    counters and return the counts: ``memory`` (the reference's keys),
    ``cost`` (``flops``: the aten ops' plus the kernels' operations;
    ``bytes accessed``: the aten ops' plus the kernels'; ``flops_by_rate``:
    the flops by the peak they run at, ``"bfloat16"`` or ``"float32"``), ``kernels``
    (``{name: {"launches", "bytes", "operations"}}``) and ``trace_s``.  The
    collectives count into ``tally``, that of the mesh the caller built
    ``fn`` on.  With ``loops`` each loop over time is counted from three
    of its steps (:class:`LoopCounter`), else unrolled."""
    arg_tensors = _tensors(args)
    flops = FlopCounterMode(display=False)
    counter = MetaCounter(flops)
    counter.known(arg_tensors)
    kernels: Dict[str, Dict[str, int]] = {}
    k_by_rate: Dict[str, int] = {}
    loop = LoopCounter(_Counts(flops, counter, kernels, k_by_rate, tally)) if loops else None
    t0 = time.perf_counter()
    with use_sharding(sharding), kernel_cost.counting(kernels, k_by_rate), flops, counter, \
            counted_by(loop):
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    out_tensors = _tensors(out)
    arg_keys = {t.untyped_storage()._cdata for t in arg_tensors}
    argument = _unique_bytes(arg_tensors)
    output = _unique_bytes(out_tensors)
    alias = _unique_bytes([t for t in out_tensors if t.untyped_storage()._cdata in arg_keys])
    peak = _unique_bytes(arg_tensors, rounded=True) + counter.peak
    k_ops = sum(k["operations"] for k in kernels.values())
    k_bytes = sum(k["bytes"] for k in kernels.values())
    return dict(
        memory=dict(argument_size_in_bytes=argument, output_size_in_bytes=output,
                    alias_size_in_bytes=alias,
                    temp_size_in_bytes=max(peak - argument - (output - alias), 0),
                    peak_memory_in_bytes=peak),
        cost={"flops": float(flops.get_total_flops() + k_ops),
              "bytes accessed": float(counter.bytes_accessed + k_bytes),
              "flops_by_rate": {r: float(counter.flops_by_rate.get(r, 0) + k_by_rate.get(r, 0))
                                for r in PEAK_OPS}},
        kernels=kernels, trace_s=trace_s,
    )


# ---------------------------------------------------------------------------
# the calls: (fn, meta args, the sharding context the call runs under)
# ---------------------------------------------------------------------------

def _rank_inputs(batch, mesh, rules):
    return shard_tree(batch, leaf_dims(batch_shardings(batch, mesh, rules), mesh), mesh)


def build_train(model, shape: InputShape, mesh, rules, optimizer: str,
                param_rules=None, tc_kw=None):
    """The port's train step (``train/step.make_train_step`` on ``mesh``:
    fused-direct LAMB where the config asks for it, else the optimizer's
    chain), its state from ``init_fn(seed, "meta")`` and rank 0's rows of
    ``model.input_specs(shape)``."""
    tc = TrainConfig(optimizer=optimizer, learning_rate=1e-3, **(tc_kw or {}))
    init_fn, step_fn = make_train_step(model, tc, mesh=mesh, param_rules=param_rules)
    state = init_fn(0, torch.device("meta"))
    batch = _rank_inputs(model.input_specs(shape), mesh, rules)
    return step_fn, (state, batch), ShardCtx(mesh, rules)


def _serving(fn, model, mesh, rules, param_rules, batch: int, cache=None):
    """``fn(params, ...)`` on rank 0's parameter blocks in the layout the
    parameter rules store them in: each leaf taken to the layout the
    layers compute in first (FSDP's gather over the data-parallel ranks
    under the default rules), as the Engine does (``RankParams``), without
    autograd, under the context the Engine's call of ``batch`` rows over
    ``cache`` (whole, meta) runs under; with rank 0's block of ``cache``."""
    specs = specs_for(model.defs, mesh, param_rules)
    ctx = ShardCtx(mesh, rules, specs)
    rank = RankParams(model, model.abstract_params(), ctx)
    if cache is not None:
        ctx = serving_ctx(ctx, specs, cache, batch)
        cache = cache_block(cache, mesh, rules, "meta")

    def run(params, *rest):
        with torch.no_grad():
            return fn(rank.compute_blocks(params), *rest)

    return run, rank.blocks, cache, ctx


def build_prefill(model, shape: InputShape, mesh, rules, param_rules=None):
    cache = model.make_cache(shape.global_batch, shape.seq_len, "meta")
    fn, params, cache, ctx = _serving(make_prefill_step(model), model, mesh, rules,
                                      param_rules, shape.global_batch, cache)
    batch = _rank_inputs(model.input_specs(shape), mesh, rules)
    return fn, (params, batch, cache), ctx


def build_decode(model, shape: InputShape, mesh, rules, param_rules=None):
    cache = model.make_cache(shape.global_batch, shape.seq_len, "meta")
    fn, params, cache, ctx = _serving(make_decode_step(model), model, mesh, rules,
                                      param_rules, shape.global_batch, cache)
    inputs = {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                    device="meta")}
    tok = _rank_inputs(inputs, mesh, rules)["tokens"]
    return fn, (params, cache, tok, torch.empty_like(tok)), ctx


def build_encoder_forward(model, shape: InputShape, mesh, rules, param_rules=None):
    """Encoder 'prefill' = plain forward (no cache)."""

    def forward(params, batch):
        logits, _ = model.apply(params, batch)
        return logits[:, -1]

    fn, params, _, ctx = _serving(forward, model, mesh, rules, param_rules,
                                  shape.global_batch)
    return fn, (params, _rank_inputs(model.input_specs(shape), mesh, rules)), ctx


# ---------------------------------------------------------------------------
# main runner
# ---------------------------------------------------------------------------

def apply_overrides(cfg: ModelConfig, sets) -> ModelConfig:
    for item in sets or []:
        key, _, val = item.partition("=")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            parsed: Any = val.lower() in ("1", "true", "yes")
        elif cur is None:
            parsed = None if val.lower() == "none" else int(val)
        elif isinstance(cur, int):
            parsed = int(val)
        elif isinstance(cur, float):
            parsed = float(val)
        else:
            parsed = val
        cfg = cfg.replace(**{key: parsed})
    return cfg


def dryrun_rules(mesh, act_rule_sets=None, param_rule_sets=None):
    """The reference's rules: the default activation rules with
    ``cache_seq`` over ``("pod", "data")`` and ``inner`` over ``model``,
    then the ``name=a,b`` overrides; param rules only when overridden."""
    multi_pod = "pod" in mesh.shape
    rules = default_act_rules(multi_pod=multi_pod)
    rules["cache_seq"] = ("pod", "data")
    rules["inner"] = ("model",)
    rules = override_rules(rules, act_rule_sets or [])
    param_rules = None
    if param_rule_sets:
        param_rules = override_rules(default_param_rules(multi_pod=multi_pod), param_rule_sets)
    return rules, param_rules


def call_for(model, shape: InputShape, mesh, rules, optimizer: str = "lamb",
                param_rules=None, tc_kw=None):
    """``(fn, args, ctx)`` of the call ``shape`` runs: the train step, the
    encoder forward (an encoder's prefill), the prefill or the decode."""
    if shape.kind == "train":
        return build_train(model, shape, mesh, rules, optimizer, param_rules, tc_kw)
    if shape.kind == "prefill":
        if model.cfg.is_encoder:
            return build_encoder_forward(model, shape, mesh, rules, param_rules)
        return build_prefill(model, shape, mesh, rules, param_rules)
    return build_decode(model, shape, mesh, rules, param_rules)


def trace(model, shape: InputShape, mesh, *, optimizer: str = "lamb", rules=None,
          param_rules=None, tc_kw=None, loops: bool = True) -> Dict[str, Any]:
    """The counts (:func:`count`) of rank 0's call of ``shape`` on ``mesh``
    (an abstract mesh: its counting groups are made here), with the
    collectives' tally and the roofline."""
    if rules is None:
        rules, _ = dryrun_rules(mesh)
    tally = CollectiveTally()
    cmesh = counting_mesh(mesh, tally)
    fn, args, ctx = call_for(model, shape, cmesh, rules, optimizer, param_rules, tc_kw)
    counts = count(fn, args, sharding=ctx, tally=tally, loops=loops)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mf = model_flops(shape.kind, model.active_param_count(), tokens) / mesh.size
    counts.update(
        tokens=tokens, collectives=tally.by_axis,
        roofline=analyze(counts["cost"], tally, model_flops_per_device=mf,
                         mesh_shape=mesh.shape).to_dict())
    return counts


def run_dryrun(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    optimizer: str = "lamb",
    sets=None,
    mesh=None,
    act_rule_sets=None,
    param_rule_sets=None,
    moment_dtype: Optional[str] = None,
    tag: str = "",
) -> Dict[str, Any]:
    shape = get_shape(shape_name)
    cfg0 = get_config(arch)
    cfg, note = plan(cfg0, shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2pod" if multi_pod else "1pod",
        "optimizer": optimizer, "note": note, "tag": tag,
        "overrides": list(sets or []),
        "act_rules": list(act_rule_sets or []),
        "param_rules": list(param_rule_sets or []),
        "moment_dtype": moment_dtype,
    }
    if cfg is None:
        record["status"] = "skipped"
        return record
    cfg = apply_overrides(cfg, sets)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rules, param_rules = dryrun_rules(mesh, act_rule_sets, param_rule_sets)
    tc_kw = {"moment_dtype": moment_dtype} if moment_dtype else {}
    model = build_model(cfg)
    counts = trace(model, shape, mesh, optimizer=optimizer, rules=rules,
                   param_rules=param_rules, tc_kw=tc_kw)
    record.update(
        status="ok",
        devices=mesh.size,
        trace_s=round(counts["trace_s"], 2),
        params=model.param_count(),
        active_params=model.active_param_count(),
        tokens=counts["tokens"],
        memory=counts["memory"],
        cost=counts["cost"],
        roofline=counts["roofline"],
        cost_source="meta",
        kernels=counts["kernels"],
        collectives=counts["collectives"],
    )
    return record


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", default="lamb")
    ap.add_argument("--set", action="append", default=[],
                    help="model-config override key=value (repeatable)")
    ap.add_argument("--act-rule", action="append", default=[],
                    help="activation sharding rule override name=axis1,axis2")
    ap.add_argument("--param-rule", action="append", default=[],
                    help="parameter sharding rule override name=axis1,axis2 "
                         "(empty value replicates that logical axis)")
    ap.add_argument("--moment-dtype", default="",
                    help="optimizer moment dtype override (e.g. bfloat16)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    rec = run_dryrun(
        args.arch, args.shape, multi_pod=args.multi_pod,
        optimizer=args.optimizer, sets=args.set,
        act_rule_sets=args.act_rule, param_rule_sets=args.param_rule,
        moment_dtype=args.moment_dtype or None, tag=args.tag,
    )
    if rec.get("status") == "ok":
        rl = rec["roofline"]
        print(f"== {args.arch} × {args.shape} × {rec['mesh']} "
              f"[{rec['optimizer']}] ==")
        print(f"  trace {rec['trace_s']}s  (meta, rank 0 of {rec['devices']})")
        print(f"  memory: {json.dumps(rec['memory'])}")
        print(f"  cost:   {json.dumps(rec['cost'])}")
        print(f"  compute {rl['compute_s']*1e3:.3f}ms  memory "
              f"{rl['memory_s']*1e3:.3f}ms  collective "
              f"{rl['collective_s']*1e3:.3f}ms  → {rl['dominant']}-bound  "
              f"useful-FLOP {rl['useful_fraction']:.3f}")
    else:
        print(f"== {args.arch} × {args.shape}: {rec['status']} ({rec['note']})")
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
