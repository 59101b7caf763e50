"""Causal-LM / masked-LM loss with the MoE aux terms, and the masked-
prediction loss of the audio stub (port of ``repro.train.loss``).

Two head paths share the loss:

  * **dense** — the model returns ``(B, S, V)`` logits and
    :func:`cross_entropy` takes an fp32 ``log_softmax`` over them;
  * **fused** (``cfg.use_fused_ce_head``) — the model returns the final
    hidden states, :func:`gather_supervised` packs the ``labels >= 0``
    positions into a fixed-size ``(B, P, D)`` buffer before the vocab
    projection, and ``kernels.fused_ce`` (K6–K8) streams vocab chunks through
    projection + online log-sum-exp, so the logits never exist.

Over a ``model`` axis that splits the vocab (the ambient sharding context),
each rank holds a V/M slice: the dense head's logits are the rank's
columns and :func:`vocab_parallel_cross_entropy` reduces them over
``model``; the fused head runs K6–K8 on the rank's rows of the vocab
projection (``fused_ce(..., model=)``).  The ``model`` ranks hold the same
rows, and every one of them the same loss and metrics.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.models.layers.tensor_parallel import split_axis
from repro_torch.models.transformer import mtp_logits
from repro_torch.sharding.collectives import all_reduce, reduce_from_model
from repro_torch.sharding.context import ModelAxis, model_parallel

IGNORE = -1  # label value for unsupervised positions


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over positions with label >= 0.  Returns (loss, accuracy).

    The log-softmax runs in fp32; the accuracy's argmax is taken on the
    logits' own dtype and picks the first maximum, as ``jnp.argmax`` does.
    """
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = -(ll * mask).sum() / denom
    acc = ((torch.argmax(logits, -1) == safe).to(torch.float32) * mask).sum() / denom
    return loss, acc


def vocab_parallel_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, tp: ModelAxis
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`cross_entropy` of the whole vocabulary from this rank's
    (..., V/M) slice of the logits, columns ``[v0, v0 + V/M)``.

    In fp32: the row max all-reduced with MAX (a constant shift, so it
    takes no gradient), the sum of exponentials and the label logit (from
    the rank that holds it, zero elsewhere) summed over ``model``, whose
    gradient reaches each rank's slice unchanged; log p = logit − max −
    log Σ.  The accuracy's argmax is taken on the logits' own dtype: the
    lowest global index among the ranks whose max is the global one, as
    ``jnp.argmax`` picks the first."""
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    v = logits.shape[-1]
    v0 = tp.index * v
    x = logits.to(torch.float32)
    top = all_reduce(x.detach().amax(-1), "max", tp.group)
    total = reduce_from_model(torch.exp(x - top[..., None]).sum(-1), tp.group)
    local = safe - v0
    mine = (local >= 0) & (local < v)
    picked = torch.gather(x, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    ll = reduce_from_model(torch.where(mine, picked, 0.0), tp.group) - top - torch.log(total)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = -(ll * mask).sum() / denom
    best, arg = logits.detach().max(-1)
    best = best.to(torch.float32)
    peak = all_reduce(best.clone(), "max", tp.group)
    idx = all_reduce(torch.where(best == peak, arg + v0, torch.iinfo(torch.int64).max),
                     "min", tp.group)
    acc = ((idx == safe).to(torch.float32) * mask).sum() / denom
    return loss, acc


# ---------------------------------------------------------------------------
# fused head: gather supervised positions, then chunked-vocab CE
# ---------------------------------------------------------------------------

def mlm_buffer_size(cfg: ModelConfig, seq_len: int) -> int:
    """The fused head's gather-buffer size P (see
    :meth:`ModelConfig.mlm_buffer_size`, the bound the synthetic MLM data
    caps per-row target counts at)."""
    return cfg.mlm_buffer_size(seq_len)


def gather_supervised(
    hidden: torch.Tensor,  # (B, S, D)
    labels: torch.Tensor,  # (B, S) with IGNORE marking unsupervised positions
    p: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the ``labels >= 0`` positions into a fixed-size (B, P, ...) buffer.

    Returns ``(hidden_sel (B,P,D), labels_sel (B,P), valid (B,P) bool,
    count (B,))``: supervised positions first, in their original order, pad
    slots marked invalid with label IGNORE.  Overflow (``count > p``) is not
    truncated here; callers check ``count`` (see :func:`fused_cross_entropy`).
    """
    mask = labels >= 0
    count = mask.to(torch.int32).sum(-1)
    # a stable argsort of the inverted mask puts supervised positions first
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    idx = order[:, :p]
    hidden_sel = torch.take_along_dim(hidden, idx[..., None], dim=1)
    labels_sel = torch.take_along_dim(labels, idx, dim=1)
    valid = torch.arange(p, device=labels.device)[None, :] < count[:, None]
    return hidden_sel, torch.where(valid, labels_sel, IGNORE), valid, count


def fused_cross_entropy(
    hidden: torch.Tensor,  # (B, S, D) final hidden states
    labels: torch.Tensor,  # (B, S) with IGNORE
    w: torch.Tensor,       # (V, D) vocab projection (embedding layout)
    *,
    max_positions: int,
    model: Optional[ModelAxis] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-head (loss, accuracy): gather → chunked-vocab CE, no logits;
    ``model``: ``w`` is this rank's vocab slice over that axis.

    Semantics match :func:`cross_entropy` on the same labels (token mean
    over ``labels >= 0``; zero supervision gives loss 0, accuracy 0 and zero
    gradients).

    A sequence with more than ``max_positions`` supervised positions does not
    fit the gather buffer: the loss, the accuracy and every gradient are then
    NaN, never a silent truncation.  Labels on the CPU, which can be read
    without a device sync, raise a ValueError for it first.
    """
    p = max(1, min(max_positions, hidden.shape[1]))
    if labels.device.type == "cpu":
        mx = int((labels >= 0).to(torch.int32).sum(-1).max())
        if mx > p:
            raise ValueError(
                f"a sequence supervises {mx} positions but the fused-CE "
                f"gather buffer holds P={p}; raise "
                f"ModelConfig.mlm_max_predictions (or cap masking in the "
                f"data pipeline) — refusing to silently truncate"
            )
    return _gathered_cross_entropy(hidden, labels, w, p, model)


def _gathered_cross_entropy(hidden, labels, w, p: int, model: Optional[ModelAxis] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_cross_entropy` after its eager check: NaN on overflow."""
    b, _, d = hidden.shape
    hidden_sel, labels_sel, valid, count = gather_supervised(hidden, labels, p)
    nll, correct = fused_ce(hidden_sel.reshape(b * p, d), w, labels_sel.reshape(b * p),
                            model=model)
    wrow = valid.reshape(b * p).to(torch.float32)
    denom = torch.clamp(wrow.sum(), min=1.0)
    loss = (nll * wrow).sum() / denom
    acc = (correct * wrow).sum() / denom
    # multiplicative, so the NaN reaches the gradients too (a select would
    # zero the taken branch's cotangent)
    poison = torch.where((count > p).any(), torch.nan, 1.0)
    return loss * poison, acc * poison


def head_weights(params, cfg: ModelConfig) -> torch.Tensor:
    """The vocab projection in (V, D) embedding layout for the fused head:
    the tied embedding, or the untied (D, V) ``unembed`` transposed into
    a contiguous copy (the kernels read w by rows; the reference's ``.T``
    is a copy under XLA too)."""
    if cfg.tie_embeddings:
        return params["embed"]
    return params["unembed"].t().contiguous()


def check_fused_ce_supported(cfg: ModelConfig) -> None:
    """Clear error for configs the fused head cannot express."""
    if cfg.family in ("hybrid", "ssm"):
        raise ValueError(
            f"use_fused_ce_head is not supported for family {cfg.family!r} "
            "(the hidden-states forward path is transformer-only)"
        )
    if cfg.logit_softcap:
        raise ValueError(
            "use_fused_ce_head cannot apply logit_softcap (the fused CE "
            "streams raw projections); disable one of the two"
        )
    if cfg.frontend == "audio_stub" and cfg.mlm_max_predictions is None:
        raise ValueError(
            "use_fused_ce_head with audio_stub needs an explicit "
            "ModelConfig.mlm_max_predictions: Bernoulli span masks are not "
            "bounded by ceil(mask_ratio * seq) (that is their mean), so the "
            "default gather buffer would overflow on most batches"
        )


def _masked_ce(
    logits: Optional[torch.Tensor],
    hidden: Optional[torch.Tensor],
    labels: torch.Tensor,
    cfg: ModelConfig,
    params,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense or fused CE over ``labels >= 0``: one switch for the loss,
    vocab-parallel where the ambient ``model`` axis splits the vocab."""
    if hidden is None:
        tp = split_axis(logits.shape[-1], cfg.vocab_size, model_parallel())
        if tp is not None:
            return vocab_parallel_cross_entropy(logits, labels, tp)
        return cross_entropy(logits, labels)
    if params is None:
        raise ValueError("the fused CE head needs params (vocab projection)")
    w = head_weights(params, cfg)
    return fused_cross_entropy(
        hidden, labels, w, max_positions=mlm_buffer_size(cfg, labels.shape[-1]),
        model=split_axis(w.shape[0], cfg.vocab_size, model_parallel()),
    )


def supervised_token_count(labels: torch.Tensor) -> torch.Tensor:
    """Number of positions contributing to the CE denominator (label >= 0)."""
    return (labels >= 0).to(torch.float32).sum()


def lm_loss(
    logits: Optional[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    aux: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    params=None,
    hidden: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over ``batch["labels"]`` (aligned with the model's
    positions) plus the MoE aux losses: ``router_aux_coef · moe_lb_loss``
    and, where the model reports it, ``router_z_coef · moe_z_loss``; with
    ``cfg.use_mtp`` (the model's ``aux["mtp_hidden"]`` and ``params`` given)
    also ``mtp_loss_coef`` times the MTP head's CE against the labels
    shifted one further, the last position unsupervised.

    With ``hidden`` given (fused head), the main CE runs gather +
    chunked-vocab CE on the final hidden states against ``params``' vocab
    projection instead of dense logits; the MTP head keeps its own dense CE
    either way, as in the reference.
    """
    labels = batch["labels"]
    mtp_hidden = aux.get("mtp_hidden")
    ce, acc = _masked_ce(logits, hidden, labels, cfg, params)
    total = ce
    metrics = {"loss/ce": ce, "accuracy": acc}
    if "moe_lb_loss" in aux:
        lb = aux["moe_lb_loss"]
        total = total + cfg.router_aux_coef * lb
        metrics["loss/moe_lb"] = lb
        metrics["moe/drop_fraction"] = aux.get("moe_drop_fraction",
                                               torch.zeros((), device=ce.device))
    if "moe_z_loss" in aux:
        total = total + cfg.router_z_coef * aux["moe_z_loss"]
        metrics["loss/moe_z"] = aux["moe_z_loss"]
    if cfg.use_mtp and mtp_hidden is not None and params is not None:
        mlogits = mtp_logits(params, mtp_hidden, batch, cfg)
        mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE)], dim=1)
        mtp_ce, _ = _masked_ce(mlogits, None, mtp_labels, cfg, None)
        total = total + cfg.mtp_loss_coef * mtp_ce
        metrics["loss/mtp"] = mtp_ce
    metrics["loss/total"] = total
    metrics["tokens/supervised"] = supervised_token_count(labels)
    return total, metrics


def masked_prediction_loss(
    logits: Optional[torch.Tensor],
    batch: Dict[str, torch.Tensor],
    aux: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    params=None,
    hidden: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """HuBERT-style: CE on the masked frames only (targets: cluster ids).

    The fused path (``hidden``) needs ``cfg.mlm_max_predictions`` sized for
    the masking distribution: the span masks are Bernoulli, so a row's count
    is not bounded by ``ceil(mask_ratio · S)``.
    """
    labels = torch.where(batch["mask"], batch["labels"], IGNORE)
    ce, acc = _masked_ce(logits, hidden, labels, cfg, params)
    return ce, {
        "loss/ce": ce, "accuracy": acc, "loss/total": ce,
        "tokens/supervised": supervised_token_count(labels),
    }


def loss_for(cfg: ModelConfig):
    if cfg.frontend == "audio_stub":
        return masked_prediction_loss
    return lm_loss
