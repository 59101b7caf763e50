"""Train step: token-weighted accumulation, bf16 compute on fp32 masters,
fused LAMB applied in place (port of the fused-direct path of
``repro.train.step.make_train_step``).

Only ``optimizer="lamb"`` with ``use_fused_lamb`` is ported; the unfused
optimizers, the non-finite guard and the trust-ratio telemetry raise
(ROADMAP.md queue 1, items 5–8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import FusedLambState, fused_lamb_init, make_fused_lamb_step
from repro_torch.models.api import Model
from repro_torch.optim.base import global_norm
from repro_torch.train.loss import loss_for

# Metric key carrying each microbatch's supervised-token count; drives the
# token-weighted accumulation.
TOKEN_WEIGHT_KEY = "tokens/supervised"
LOSS_KEY = "loss/total"

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: nn.Params
    opt_state: FusedLambState
    step: int = 0


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
    for flag, item in (("skip_nonfinite", 6), ("log_trust_ratios", 8),
                       ("record_trust_ratios", 8)):
        if getattr(tc, flag):
            raise NotImplementedError(
                f"{flag} is not ported (ROADMAP.md queue 1, item {item})"
            )


def make_loss_fn(model: Model) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``, dense head."""
    cfg = model.cfg
    loss_impl = loss_for(cfg)

    def loss_fn(params, batch):
        logits = model.apply(params, batch)
        return loss_impl(logits, batch, cfg)

    return loss_fn


def _microbatch_grads(
    loss_fn: Callable, params: nn.Params, batch: Dict[str, torch.Tensor], n_micro: int
) -> Tuple[nn.Params, Metrics]:
    """Token-weighted sequential accumulation over ``n_micro`` slices.

    Returns fp32 grads equal to the full-batch token-mean gradient
    ``Σ_i w_i g_i / Σ_i w_i``, ``w_i`` the slice's supervised-token count.
    Metrics are averaged with the same weights, except
    ``tokens/supervised``, which is summed.  ``params`` are the leaves the
    gradient is taken against (the compute-dtype copy).
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
        return g, metrics, metrics[TOKEN_WEIGHT_KEY]

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
    metrics[TOKEN_WEIGHT_KEY] = w_acc
    return g_acc, metrics


def make_train_step(model: Model, tc: TrainConfig, schedule=None):
    """Returns ``(init_fn(seed, device) -> TrainState,
    step_fn(state, batch) -> (state, metrics))``.

    ``step_fn`` consumes the global batch and slices it into
    ``tc.grad_accum_steps`` microbatches; the fp32 masters are cast to the
    compute dtype once per step, and the fused LAMB update then runs in
    place on the masters and moments.
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

    def init_fn(seed: int, device: torch.device) -> TrainState:
        params = model.init(seed, device)
        return TrainState(params, fused_lamb_init(params), 0)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        # the one cast of the masters per step; gradients are taken against
        # this copy and accumulate in fp32
        with torch.no_grad():
            params = (state.params if compute_dtype is None
                      else nn.cast_tree(state.params, compute_dtype))
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads, metrics = _microbatch_grads(loss_fn, params, batch, n_micro)
        del params
        metrics["grad_norm"] = global_norm(grads)
        delta_sq = fused_step(state.params, grads, state.opt_state)
        metrics["update_norm"] = torch.sqrt(delta_sq)
        state.step += 1
        return state, metrics

    return init_fn, step_fn
