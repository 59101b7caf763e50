"""Train step: token-weighted accumulation, bf16 compute on fp32 masters,
the optimizer update and the non-finite guard (port of
``repro.train.step``).

Two paths, chosen as the reference chooses them.  LAMB with
``tc.use_fused_lamb`` or ``cfg.use_fused_lamb_kernel`` runs fused-direct:
K1/K2 update params and moments in place, and the guard's verdict reaches
them as a device flag.  Every other optimizer (and unfused LAMB) runs the
transform chain of :func:`make_optimizer`: ``opt.update`` then
``optim.apply_updates``, with the guard a where-select of old against new
over the params and the whole chain state.  ``tc.record_trust_ratios``
adds the per-layer records under ``telemetry.trust.PER_LAYER_KEY``: the
ratios K2 applied on the fused path, phi(||x||)/||Δx|| on a chain.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import core, nn, optim
from repro_torch.checkpoint.io import tree_leaves_with_paths, tree_map_with_paths
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import fused_lamb, fused_lamb_init, make_fused_lamb_step
from repro_torch.models.api import Model
from repro_torch.optim.base import global_norm
from repro_torch.sharding import ShardCtx, specs_for, use_sharding
from repro_torch.sharding.collectives import (
    all_reduce,
    is_plain,
    shard_block,
    to_compute,
    to_storage,
)
from repro_torch.sharding.context import Layout, compute_layout
from repro_torch.telemetry.trust import PER_LAYER_KEY
from repro_torch.train.faults import apply_grad_faults, apply_loss_faults, split_faults
from repro_torch.train.loss import check_fused_ce_supported, loss_for

# Metric key carrying each microbatch's supervised-token count; drives the
# token-weighted accumulation.
TOKEN_WEIGHT_KEY = "tokens/supervised"

# Metric key the non-finite guard reports under: 1.0 when the step was
# skipped (state left as it was), 0.0 otherwise.  Only present with
# ``tc.skip_nonfinite``.
GUARD_KEY = "nonfinite/skip"

LOSS_KEY = "loss/total"

# The trust-ratio summary ``tc.log_trust_ratios`` adds to the metrics.
TRUST_KEYS = ("trust_ratio/min", "trust_ratio/max", "trust_ratio/mean")

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state and two int32 device counters.

    ``opt_state`` is a ``FusedLambState`` on the fused-direct path, else the
    transform chain's tuple of state dataclasses.  ``step`` counts the steps
    taken; ``skipped`` the non-finite guard's skips, persisted with a
    checkpoint so a resume can fast-forward the data by ``step + skipped``
    batches (a skipped step consumed a batch without advancing ``step``).
    Both default to 0 on the params' device.
    """

    params: nn.Params
    opt_state: Any
    step: Optional[torch.Tensor] = None
    skipped: Optional[torch.Tensor] = None

    def __post_init__(self):
        device = next(iter(self.params.values())).device
        for name in ("step", "skipped"):
            value = getattr(self, name)
            if not isinstance(value, torch.Tensor):
                setattr(self, name, torch.tensor(value or 0, dtype=torch.int32,
                                                 device=device))


def tree_all_finite(tree: Dict[str, torch.Tensor], *extra: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """Bool device scalar: every element of every leaf (and of ``extra``) is
    finite.  Integer leaves are finite by definition.

    One ``aminmax`` per floating leaf (reads it once and writes two values:
    NaN propagates into both, ±inf shows in one), then one check over the
    stacked extremes; no host sync.
    """
    leaves = [x for x in list(tree.values()) + [x for x in extra if x is not None]
              if x.is_floating_point()]
    if not leaves:
        device = next(iter(tree.values())).device if tree else None
        return torch.ones((), dtype=torch.bool, device=device)
    ends = [v.to(torch.float32) for x in leaves for v in torch.aminmax(x.detach())]
    return torch.isfinite(torch.stack(ends)).all()


def _wants_fused(model: Model, tc: TrainConfig) -> bool:
    return bool(tc.use_fused_lamb or model.cfg.use_fused_lamb_kernel)


def _check_fused_supported(tc: TrainConfig) -> None:
    if not tc.bias_correction or tc.moment_dtype is not None:
        raise ValueError(
            "fused LAMB supports bias-corrected fp32 moments only; "
            "unset use_fused_lamb or bias_correction/moment_dtype"
        )


def make_optimizer(model: Model, tc: TrainConfig, schedule=None
                   ) -> optim.GradientTransformation:
    """The configured optimizer with the model's layerwise metadata (weight
    decay mask, trust mask, stacked-layer axes), name for name as the
    reference builds it, quirks included: ``lars``, ``adam``, ``adamw``,
    ``adagrad`` and ``momentum`` get no gradient clip; ``nlamb``/``nnlamb``
    keep their own b1, b2 and eps; ``adam`` takes no weight decay;
    ``momentum`` takes ``tc.b1``.  Returns deltas for ``optim.apply_updates``
    from token-mean fp32 grads.
    """
    lr = schedule if schedule is not None else tc.learning_rate
    wd_mask = model.wd_mask()
    common = dict(wd_mask=wd_mask, trust_mask=model.trust_mask(),
                  layer_axes=model.layer_axes(), phi_bounds=tc.phi_bounds)
    name = tc.optimizer
    if name == "lamb" and _wants_fused(model, tc):
        _check_fused_supported(tc)
        return fused_lamb(lr, tc.b1, tc.b2, tc.eps, tc.weight_decay,
                          grad_clip_norm=tc.grad_clip_norm, **common)
    if name == "lamb":
        return core.lamb(lr, tc.b1, tc.b2, tc.eps, tc.weight_decay,
                         bias_correction=tc.bias_correction,
                         grad_clip_norm=tc.grad_clip_norm,
                         moment_dtype=tc.moment_dtype, **common)
    if name == "lans":
        return core.lans(lr, tc.b1, tc.b2, tc.eps, tc.weight_decay,
                         bias_correction=tc.bias_correction,
                         grad_clip_norm=tc.grad_clip_norm,
                         moment_dtype=tc.moment_dtype, **common)
    if name == "nlamb":
        return core.nlamb(lr, weight_decay=tc.weight_decay,
                          grad_clip_norm=tc.grad_clip_norm, **common)
    if name == "nnlamb":
        return core.nnlamb(lr, weight_decay=tc.weight_decay,
                           grad_clip_norm=tc.grad_clip_norm, **common)
    if name == "lars":
        return core.lars(lr, momentum=tc.b1, weight_decay=tc.weight_decay, **common)
    if name == "adam":
        return optim.adam(lr, tc.b1, tc.b2, tc.eps)
    if name == "adamw":
        return optim.adamw(lr, tc.b1, tc.b2, tc.eps, tc.weight_decay, wd_mask)
    if name == "adagrad":
        return optim.adagrad(lr)
    if name == "momentum":
        return optim.momentum(lr, tc.b1, tc.weight_decay, wd_mask)
    raise ValueError(f"unknown optimizer {name!r}")


def make_loss_fn(model: Model) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` for this model.

    With ``cfg.use_fused_ce_head`` the model returns final hidden states
    instead of (B, S, V) logits and the loss runs the fused MLM head (gather
    the supervised positions, then chunked-vocab CE, kernels K6–K8), so the
    logits tensor never exists.  Its vocab projection is ``params``' own: in
    a train step, the compute-dtype copy the forward ran on.  The model's
    aux (the MoE losses) reaches the loss on both paths.
    """
    cfg = model.cfg
    if cfg.use_fused_ce_head:
        check_fused_ce_supported(cfg)
    loss_impl = loss_for(cfg)

    def loss_fn(params, batch):
        if cfg.use_fused_ce_head:
            hidden, aux = model.apply(params, batch, return_hidden=True)
            return loss_impl(None, batch, aux, cfg, params=params, hidden=hidden)
        logits, aux = model.apply(params, batch)
        return loss_impl(logits, batch, aux, cfg, params=params)

    return loss_fn


def _weighted_sums(
    loss_fn: Callable, params: nn.Params, batch: Dict[str, torch.Tensor], n_micro: int,
    unreachable: frozenset = frozenset(), *, weighted: bool = True, seeded: bool = False,
    joined: bool = False,
) -> Tuple[nn.Params, Metrics, torch.Tensor]:
    """``(Σ_i w_i g_i, Σ_i w_i m_i, Σ_i w_i)`` over ``n_micro`` slices of
    ``batch``, ``w_i`` the slice's supervised-token count (1 when the loss
    reports none), the gradients in fp32.  With one slice and not
    ``weighted``, ``(g, m, w)`` unscaled.  ``params`` are the leaves the
    gradient is taken against (the compute-dtype copy); the ``unreachable``
    ones, which the model declares the loss does not reach, get a zero
    gradient, as under ``jax.grad``.  ``seeded`` starts each backward pass
    at ``w_i`` instead of scaling its gradients after it: a loss term that
    every data-parallel rank computes over the whole micro-batch (the MoE
    router's) then reaches each rank's rows at the ranks' summed weight
    through the backward of its sum over them, whatever each rank's own
    count.  Unseeded is the reference's order, whose bf16 roundings every
    other run keeps.  ``joined``: the graph is shared with other ranks
    (threads of one process over plain collectives, which join the ranks'
    graphs in the forward), so the backward keeps it for theirs.
    """
    for x in batch.values():
        if x.shape[0] % n_micro:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"accum_steps {n_micro}; remainder examples would be dropped"
            )
    keys = [k for k in params if k not in unreachable]
    leaves: List[torch.Tensor] = [params[k] for k in keys]

    def one(i):
        mb = {k: x.narrow(0, i * (x.shape[0] // n_micro), x.shape[0] // n_micro)
              for k, x in batch.items()}
        loss, metrics = loss_fn(params, mb)
        metrics = {k: t.detach() for k, t in metrics.items()}
        w = metrics.get(TOKEN_WEIGHT_KEY)
        if w is None:
            w = torch.ones((), dtype=torch.float32, device=loss.device)
        # an untied head's gradient comes back transposed from the fused CE
        # head and is laid out again
        grads = torch.autograd.grad(loss, leaves, grad_outputs=w if seeded else None,
                                    retain_graph=joined)
        g = {k: t.to(torch.float32).contiguous() for k, t in zip(keys, grads)}
        g.update({k: torch.zeros(params[k].shape, dtype=torch.float32,
                                 device=params[k].device) for k in unreachable})
        g = {k: g[k] for k in params}
        return g, metrics, w

    g0, m0, w0 = one(0)
    if n_micro == 1 and not weighted:
        return g0, m0, w0
    g_acc = g0 if seeded else {k: w0 * t for k, t in g0.items()}
    m_acc = {k: w0 * t for k, t in m0.items()}
    w_acc = w0
    for i in range(1, n_micro):
        g, m, w = one(i)
        for k in keys:
            if seeded:
                g_acc[k].add_(g[k])
            else:
                g_acc[k].add_(w * g[k])
        m_acc = {k: m_acc[k] + w * m[k] for k in m_acc}
        w_acc = w_acc + w
    return g_acc, m_acc, w_acc


def _microbatch_grads(
    loss_fn: Callable, params: nn.Params, batch: Dict[str, torch.Tensor], n_micro: int,
    unreachable: frozenset = frozenset(),
) -> Tuple[nn.Params, Metrics]:
    """Token-weighted sequential accumulation over ``n_micro`` slices.

    Returns fp32 grads equal to the full-batch token-mean gradient
    ``Σ_i w_i g_i / Σ_i w_i`` (see :func:`_weighted_sums`).  Metrics are
    averaged with the same weights, except ``tokens/supervised``, which is
    summed.
    """
    g_acc, m_acc, w_acc = _weighted_sums(loss_fn, params, batch, n_micro, unreachable,
                                         weighted=False)
    if n_micro == 1:
        return g_acc, m_acc
    inv = 1.0 / w_acc
    for t in g_acc.values():
        t.mul_(inv)
    metrics = {k: t * inv for k, t in m_acc.items()}
    if TOKEN_WEIGHT_KEY in metrics:
        metrics[TOKEN_WEIGHT_KEY] = w_acc   # total over the global batch, not mean
    return g_acc, metrics


def _sharded_grads(
    loss_fn: Callable, shards: nn.Params, batch: Dict[str, torch.Tensor], n_micro: int,
    unreachable: frozenset, compute_dtype, layouts: Dict[str, Tuple[Layout, Layout]], mesh,
    group, seeded: bool = False, joined: bool = False,
) -> Tuple[nn.Params, Metrics]:
    """:func:`_microbatch_grads` over the data-parallel ranks, FSDP-style.

    ``shards`` are this rank's blocks of the fp32 masters in the layout the
    parameter rules store them in, and ``batch`` its rows; ``layouts`` gives
    each leaf's ``(storage, compute)`` layouts and ``group`` is the
    data-parallel group of this rank's other coordinates.  The compute
    copy is cast on the block and moved to the compute layout
    (``collectives.to_compute``: under the default rules FSDP's gather over
    ``group``), in which a leaf split over ``model`` is this rank's heads, ff
    columns or vocab rows, what the model's tensor-parallel layers compute
    on.  The rank's ``Σ_i w_i g_i`` goes back to its storage block summed
    over the data-parallel ranks (``collectives.to_storage``: under the
    default rules a reduce-scatter over ``group``, an all-reduce for a leaf
    not split over it) and is divided by the global token weight,
    all-reduced from the ranks' ``tokens/supervised``.  Metrics get the same
    weighting in one all-reduce; ``tokens/supervised`` is the global sum.
    The ranks of one data coordinate hold the same rows and the same loss,
    so the sums over ``group`` are the global batch's.  The ranks ×
    micro-batches are one token-weighted accumulation, so the result is the
    global batch's token-mean gradient.  ``seeded`` (an MoE model over more
    than one data-parallel rank) starts each backward pass at the rank's
    weight (:func:`_weighted_sums`), so the router's global loss terms
    reach every rank's rows at the micro-batch's whole weight, counted once
    in the reduce-scatter.  ``joined``: the ranks are threads whose plain
    collectives join their graphs (``launch.mesh.run_plain_mesh``); each
    takes its gradient through the joined graph, a function of every
    rank's leaves, and a leaf whole over ``model`` then sums its copies'
    gradients over the model ranks, what ``copy_to_model``'s backward sums
    on real ranks.
    """
    with torch.no_grad():
        full = {k: to_compute(v if compute_dtype is None or not v.is_floating_point()
                              else v.to(nn.torch_dtype(compute_dtype)), *layouts[k], mesh)
                for k, v in shards.items()}
    full = {k: v.detach().requires_grad_(True) for k, v in full.items()}
    g_sum, m_sum, w = _weighted_sums(loss_fn, full, batch, n_micro, unreachable,
                                     seeded=seeded, joined=joined)
    del full
    # over joined ranks a leaf whole over model has one copy a rank, whose
    # gradient holds the uses of that rank's copy alone
    copies = (mesh.group(("model",)) if joined and mesh.shape.get("model", 1) > 1 else None)
    with torch.no_grad():
        grads = {}
        for k in list(g_sum):
            g = g_sum.pop(k)
            if copies is not None and layouts[k][1].model is None and k not in unreachable:
                g = all_reduce(g, "sum", copies)
            grads[k] = (torch.zeros(shards[k].shape, dtype=torch.float32,
                                    device=g.device)
                        if k in unreachable else to_storage(g, *layouts[k], mesh))
        keys = list(m_sum)
        packed = all_reduce(torch.stack([w] + [m_sum[k].to(torch.float32) for k in keys]),
                            "sum", group)
        inv = 1.0 / packed[0]
        for t in grads.values():
            t.mul_(inv)
        metrics = {k: packed[i + 1] * inv for i, k in enumerate(keys)}
        if TOKEN_WEIGHT_KEY in metrics:
            metrics[TOKEN_WEIGHT_KEY] = packed[0]
    return grads, metrics


def make_train_step(model: Model, tc: TrainConfig, schedule=None, *,
                    optimizer: Optional[optim.GradientTransformation] = None,
                    mesh=None, param_rules=None):
    """Returns ``(init_fn(seed, device) -> TrainState,
    step_fn(state, batch) -> (state, metrics))``.

    ``step_fn`` consumes the global batch and slices it into
    ``tc.grad_accum_steps`` microbatches; the fp32 masters are cast to the
    compute dtype once per step.  Fault channels (``fault/*`` leaves, see
    :mod:`repro_torch.train.faults`) are popped before the loss and applied
    to the accumulated gradients.  With ``tc.skip_nonfinite`` the verdict of
    :func:`tree_all_finite` over every gradient and the loss decides the
    step: a non-finite one leaves every param, moment and counter as it
    was, ``skipped`` goes up by one and ``step`` does not.

    LAMB with ``tc.use_fused_lamb`` or ``cfg.use_fused_lamb_kernel`` (and no
    ``optimizer``) runs fused-direct: K1/K2 update the state in place (the
    verdict reaches them as a device flag) and the same ``state`` comes
    back.  Otherwise ``optimizer`` (default :func:`make_optimizer`) runs as
    a transform chain and a new ``TrainState`` comes back, the guard
    selecting old against new per leaf.  ``tc.log_trust_ratios`` adds the
    ``trust_ratio/{min,max,mean}`` summary of phi(||x||)/||Δx|| on both;
    ``tc.record_trust_ratios`` the per-layer records (``PER_LAYER_KEY``),
    left on the device.

    With a concrete ``mesh`` (:func:`~repro_torch.launch.mesh.init_distributed`)
    the step is FSDP over its data-parallel ranks and tensor-parallel over
    its ``model`` ranks: ``init_fn`` keeps this rank's block of every leaf
    the param specs split (and the moments mirror them), ``step_fn`` takes
    the rank's rows of the global batch (:func:`_sharded_grads`; the
    model's layers split heads, ff and vocab over ``model``), the guard's
    verdict is all-reduced over the world with MIN so every rank skips
    together, and the optimizer runs on the blocks under the ambient
    :class:`~repro_torch.sharding.ShardCtx`, which keeps every norm and
    trust ratio the whole leaf's.  Metrics are global.  ``param_rules``
    (default ``sharding.default_param_rules``) decide the layout that
    stores each leaf and its moments: any layout ``resolve_spec`` gives (a
    dimension over ``data`` and ``model`` together, over part of the
    data-parallel axes, beside any other mesh axis).  The layers compute in
    the default rules' layout whatever the storage, so the step's products
    are the default layout's (:func:`_sharded_grads`).
    ``init_fn(seed, "meta")`` makes a state of meta tensors with nothing
    drawn (the dry-run's, ``launch/dryrun.py``).
    """
    loss_fn = make_loss_fn(model)
    n_micro = tc.grad_accum_steps
    compute_dtype = tc.compute_dtype
    guard = tc.skip_nonfinite
    layer_axes = model.layer_axes()
    unreachable = model.unreachable()
    ctx = None
    if mesh is not None:
        ctx = ShardCtx(mesh, param_specs=specs_for(model.defs, mesh, param_rules))
        compute = specs_for(model.defs, mesh)
        layouts = {k: (ctx.layout(k), compute_layout(compute[k], mesh))
                   for k in ctx.param_specs}
        group = ctx.dp_group
        # the router's global terms over more than one data rank need the
        # seeded order (:func:`_weighted_sums`); every other run keeps the
        # reference's, and with it the single process's bf16 roundings
        seeded = bool(model.cfg.n_experts) and ctx.data_axis is not None
        # ranks as threads of one process (``launch.mesh.run_plain_mesh``):
        # each takes its gradient through the graph their plain collectives
        # join, none meeting the others inside a backward (on a card every
        # backward runs on the device's one autograd thread)
        joined = mesh.size > 1 and is_plain((mesh.groups or {}).get(mesh.axis_names))
        if joined and seeded:
            raise ValueError("an MoE over plain data ranks: its router's global terms would "
                             "reach each rank at that rank's weight alone; run the data "
                             "ranks as processes")

    def draw(seed: int, device: torch.device) -> nn.Params:
        if ctx is None:
            return model.init(seed, device)
        return model.init(seed, device,
                          keep=lambda path, x: shard_block(x, ctx.layout(path), mesh))

    def grads_and_metrics(params, batch):
        batch, faults = split_faults(batch)
        if ctx is None:
            # the one cast of the masters per step; gradients are taken
            # against this copy and accumulate in fp32
            with torch.no_grad():
                cast = params if compute_dtype is None else nn.cast_tree(params, compute_dtype)
            cast = {k: v.detach().requires_grad_(True) for k, v in cast.items()}
            grads, metrics = _microbatch_grads(loss_fn, cast, batch, n_micro, unreachable)
            del cast
        else:
            grads, metrics = _sharded_grads(loss_fn, params, batch, n_micro, unreachable,
                                            compute_dtype, layouts, mesh, group, seeded,
                                            joined)
        grads = apply_grad_faults(grads, faults)
        metrics = apply_loss_faults(metrics, faults)
        metrics["grad_norm"] = global_norm(grads)
        # the verdict before the update (the fused path clips in place)
        ok = tree_all_finite(grads, metrics.get(LOSS_KEY)) if guard else None
        if ok is not None and ctx is not None:   # every rank skips together
            ok = all_reduce(ok.to(torch.int32), "min", ctx.world_group) != 0
        return grads, metrics, ok

    def sharded(step_fn):
        """``step_fn`` under the mesh's ambient context (none without a mesh)."""
        def step(state, batch):
            with use_sharding(ctx):
                return step_fn(state, batch)

        return step

    def trust_diag(params, updates):
        return core.summarize_trust_ratios(core.trust_ratio_tree(
            params, updates, layer_axes=layer_axes, phi_bounds=tc.phi_bounds))

    # per-layer telemetry (off by default): the records stay on the device
    # in the metrics until the Trainer's log step fetches them
    record = tc.record_trust_ratios

    def per_layer_records(params, updates, applied_ratio=None):
        return core.trust_records(params, updates, layer_axes=layer_axes,
                                  phi_bounds=tc.phi_bounds, trust_ratio=applied_ratio)

    if optimizer is None and tc.optimizer == "lamb" and _wants_fused(model, tc):
        _check_fused_supported(tc)
        fused_step = make_fused_lamb_step(
            schedule if schedule is not None else tc.learning_rate,
            tc.b1, tc.b2, tc.eps, tc.weight_decay,
            wd_mask=model.wd_mask(), trust_mask=model.trust_mask(),
            layer_axes=layer_axes, phi_bounds=tc.phi_bounds,
            grad_clip_norm=tc.grad_clip_norm, with_aux=record,
        )

        def init_fn(seed: int, device: torch.device) -> TrainState:
            params = draw(seed, device)
            return TrainState(params, fused_lamb_init(params))

        def step_fn(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
            grads, metrics, ok = grads_and_metrics(state.params, batch)
            adv = None if ok is None else ok.to(torch.int32)
            # K1/K2 write the params in place: keep the old ones for the
            # trust-ratio summary and records, and only then
            old = ({k: v.clone() for k, v in state.params.items()}
                   if tc.log_trust_ratios or record else None)
            out = fused_step(state.params, grads, state.opt_state, ok=adv)
            delta_sq, applied = out if record else (out, None)
            metrics["update_norm"] = torch.sqrt(delta_sq)
            if old is not None:
                updates = {k: v.to(torch.float32) - old[k].to(torch.float32)
                           for k, v in state.params.items()}
                if tc.log_trust_ratios:
                    metrics.update(trust_diag(old, updates))
                if record:   # the ratios K2 applied (its aux output)
                    metrics[PER_LAYER_KEY] = per_layer_records(old, updates, applied)
            if guard:
                metrics[GUARD_KEY] = 1.0 - adv.to(torch.float32)
                state.step.add_(adv)
                state.skipped.add_(1 - adv)
            else:
                state.step.add_(1)
            return state, metrics

        return init_fn, sharded(step_fn)

    opt = optimizer if optimizer is not None else make_optimizer(model, tc, schedule)

    def init_fn(seed: int, device: torch.device) -> TrainState:
        params = draw(seed, device)
        return TrainState(params, opt.init(params))

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        grads, metrics, ok = grads_and_metrics(state.params, batch)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        del grads
        params = optim.apply_updates(state.params, updates)
        update_norm = global_norm(updates)
        if ok is not None:
            # a non-finite step passes the params and the whole chain state
            # (schedule and moment counters included) through unchanged
            params = {k: torch.where(ok, p, state.params[k]) for k, p in params.items()}
            old = dict(tree_leaves_with_paths(state.opt_state))
            opt_state = tree_map_with_paths(
                lambda path, new: torch.where(ok, new, old[path]), opt_state)
            update_norm = torch.where(ok, update_norm, 0.0)
        metrics["update_norm"] = update_norm
        if tc.log_trust_ratios:
            metrics.update(trust_diag(state.params, updates))
        if record:   # a chain's ratio is internal: the post-hoc one
            metrics[PER_LAYER_KEY] = per_layer_records(state.params, updates)
        if ok is None:
            return TrainState(params, opt_state, state.step + 1, state.skipped), metrics
        adv = ok.to(torch.int32)
        metrics[GUARD_KEY] = 1.0 - adv.to(torch.float32)
        return TrainState(params, opt_state, state.step + adv, state.skipped + (1 - adv)), metrics

    return init_fn, sharded(step_fn)
