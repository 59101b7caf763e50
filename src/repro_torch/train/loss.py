"""Masked-LM / causal-LM loss, dense head (port of ``repro.train.loss``).

The fused CE head (kernels K6–K8) is not ported yet (ROADMAP.md queue 2);
``models.api.build_model`` refuses configs that ask for it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig

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


def supervised_token_count(labels: torch.Tensor) -> torch.Tensor:
    """Number of positions contributing to the CE denominator (label >= 0)."""
    return (labels >= 0).to(torch.float32).sum()


def lm_loss(
    logits: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE over ``batch["labels"]`` (aligned with the logits' positions)."""
    labels = batch["labels"]
    ce, acc = cross_entropy(logits, labels)
    metrics = {
        "loss/ce": ce,
        "accuracy": acc,
        "loss/total": ce,
        "tokens/supervised": supervised_token_count(labels),
    }
    return ce, metrics


def loss_for(cfg: ModelConfig):
    if cfg.frontend != "none":
        raise NotImplementedError(
            "the masked-prediction loss is not ported (ROADMAP.md queue 1, item 10)"
        )
    return lm_loss
