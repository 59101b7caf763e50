"""Train step: token-weighted accumulation, bf16 compute on fp32 masters,
fused LAMB applied in place, and the non-finite guard (port of the
fused-direct path of ``repro.train.step.make_train_step``).

Only ``optimizer="lamb"`` with ``use_fused_lamb`` is ported; the unfused
optimizers and the trust-ratio telemetry raise (ROADMAP.md queue 1, items
5 and 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import FusedLambState, fused_lamb_init, make_fused_lamb_step
from repro_torch.models.api import Model
from repro_torch.optim.base import global_norm
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

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state and two int32 device counters.

    ``step`` counts the steps taken; ``skipped`` the non-finite guard's
    skips, persisted with a checkpoint so a resume can fast-forward the
    data by ``step + skipped`` batches (a skipped step consumed a batch
    without advancing ``step``).  Both default to 0 on the params' device.
    """

    params: nn.Params
    opt_state: FusedLambState
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


def check_train_config(tc: TrainConfig) -> None:
    """Raise for the options of ``TrainConfig`` the port does not have yet."""
    if tc.optimizer != "lamb" or not tc.use_fused_lamb:
        raise NotImplementedError(
            f"optimizer {tc.optimizer!r} (use_fused_lamb={tc.use_fused_lamb}) is "
            "not ported: only fused LAMB is (ROADMAP.md queue 1, items 5 and 8)"
        )
    if not tc.bias_correction or tc.moment_dtype is not None:
        raise ValueError(
            "fused LAMB supports bias-corrected fp32 moments only; "
            "unset use_fused_lamb or bias_correction/moment_dtype"
        )
    for flag in ("log_trust_ratios", "record_trust_ratios"):
        if getattr(tc, flag):
            raise NotImplementedError(
                f"{flag} is not ported (ROADMAP.md queue 1, item 8)"
            )


def make_loss_fn(model: Model) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` for this model.

    With ``cfg.use_fused_ce_head`` the model returns final hidden states
    instead of (B, S, V) logits and the loss runs the fused MLM head (gather
    the supervised positions, then chunked-vocab CE, kernels K6–K8), so the
    logits tensor never exists.  Its vocab projection is ``params``' own: in
    a train step, the compute-dtype copy the forward ran on.
    """
    cfg = model.cfg
    if cfg.use_fused_ce_head:
        check_fused_ce_supported(cfg)
    loss_impl = loss_for(cfg)

    def loss_fn(params, batch):
        if cfg.use_fused_ce_head:
            hidden = model.apply(params, batch, return_hidden=True)
            return loss_impl(None, batch, cfg, params=params, hidden=hidden)
        logits = model.apply(params, batch)
        return loss_impl(logits, batch, cfg)

    return loss_fn


def _microbatch_grads(
    loss_fn: Callable, params: nn.Params, batch: Dict[str, torch.Tensor], n_micro: int
) -> Tuple[nn.Params, Metrics]:
    """Token-weighted sequential accumulation over ``n_micro`` slices.

    Returns fp32 grads equal to the full-batch token-mean gradient
    ``Σ_i w_i g_i / Σ_i w_i``, ``w_i`` the slice's supervised-token count
    (uniform weights when the loss reports none).  Metrics are averaged with
    the same weights, except ``tokens/supervised``, which is summed.
    ``params`` are the leaves the gradient is taken against (the
    compute-dtype copy).
    """
    for x in batch.values():
        if x.shape[0] % n_micro:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"accum_steps {n_micro}; remainder examples would be dropped"
            )
    keys = list(params)
    leaves: List[torch.Tensor] = [params[k] for k in keys]

    def one(i):
        mb = {k: x.narrow(0, i * (x.shape[0] // n_micro), x.shape[0] // n_micro)
              for k, x in batch.items()}
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        g = {k: t.to(torch.float32) for k, t in zip(keys, grads)}
        metrics = {k: t.detach() for k, t in metrics.items()}
        w = metrics.get(TOKEN_WEIGHT_KEY)
        if w is None:
            w = torch.ones((), dtype=torch.float32, device=loss.device)
        return g, metrics, w

    g0, m0, w0 = one(0)
    if n_micro == 1:
        return g0, m0
    g_acc = {k: w0 * t for k, t in g0.items()}
    m_acc = {k: w0 * t for k, t in m0.items()}
    w_acc = w0
    for i in range(1, n_micro):
        g, m, w = one(i)
        for k in keys:
            g_acc[k].add_(w * g[k])
        m_acc = {k: m_acc[k] + w * m[k] for k in m_acc}
        w_acc = w_acc + w
    inv = 1.0 / w_acc
    for t in g_acc.values():
        t.mul_(inv)
    metrics = {k: t * inv for k, t in m_acc.items()}
    if TOKEN_WEIGHT_KEY in metrics:
        metrics[TOKEN_WEIGHT_KEY] = w_acc   # total over the global batch, not mean
    return g_acc, metrics


def make_train_step(model: Model, tc: TrainConfig, schedule=None):
    """Returns ``(init_fn(seed, device) -> TrainState,
    step_fn(state, batch) -> (state, metrics))``.

    ``step_fn`` consumes the global batch and slices it into
    ``tc.grad_accum_steps`` microbatches; the fp32 masters are cast to the
    compute dtype once per step, and the fused LAMB update then runs in
    place on the masters and moments.  Fault channels (``fault/*`` leaves,
    see :mod:`repro_torch.train.faults`) are popped before the loss and
    applied to the accumulated gradients.  With ``tc.skip_nonfinite`` the
    verdict of :func:`tree_all_finite` over every gradient and the loss goes
    into the update as a device flag: a non-finite step writes no param,
    moment or counter, ``skipped`` goes up by one and ``step`` does not.
    """
    check_train_config(tc)
    loss_fn = make_loss_fn(model)
    n_micro = tc.grad_accum_steps
    compute_dtype = tc.compute_dtype
    fused_step = make_fused_lamb_step(
        schedule if schedule is not None else tc.learning_rate,
        tc.b1, tc.b2, tc.eps, tc.weight_decay,
        wd_mask=model.wd_mask(), trust_mask=model.trust_mask(),
        layer_axes=model.layer_axes(), phi_bounds=tc.phi_bounds,
        grad_clip_norm=tc.grad_clip_norm,
    )

    guard = tc.skip_nonfinite

    def init_fn(seed: int, device: torch.device) -> TrainState:
        params = model.init(seed, device)
        return TrainState(params, fused_lamb_init(params))

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        batch, faults = split_faults(batch)
        # the one cast of the masters per step; gradients are taken against
        # this copy and accumulate in fp32
        with torch.no_grad():
            params = (state.params if compute_dtype is None
                      else nn.cast_tree(state.params, compute_dtype))
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads, metrics = _microbatch_grads(loss_fn, params, batch, n_micro)
        del params
        grads = apply_grad_faults(grads, faults)
        metrics = apply_loss_faults(metrics, faults)
        metrics["grad_norm"] = global_norm(grads)
        # the verdict before the update clips the gradients in place
        adv = tree_all_finite(grads, metrics.get(LOSS_KEY)).to(torch.int32) if guard else None
        delta_sq = fused_step(state.params, grads, state.opt_state, ok=adv)
        metrics["update_norm"] = torch.sqrt(delta_sq)
        if guard:
            metrics[GUARD_KEY] = 1.0 - adv.to(torch.float32)
            state.step.add_(adv)
            state.skipped.add_(1 - adv)
        else:
            state.step.add_(1)
        return state, metrics

    return init_fn, step_fn
