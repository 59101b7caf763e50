"""Vectorized per-request sampling over a batch of next-token logits (port
of ``repro.serve.sampling``).

Every row of the batch carries its own sampling parameters (temperature,
top-k), so a continuous-batching step — where each slot belongs to a
different request — samples all slots in one fused op.  ``temperature <= 0``
selects greedy argmax for that row regardless of the generator, which keeps
greedy rows bit-deterministic inside a mixed batch.

The reference draws with ``jax.random.categorical`` from a key; here the
draw is the same distribution by the Gumbel-max trick,
``argmax(scaled + gumbel)``, with the noise from an explicit
``torch.Generator`` on the logits' device (no host sync).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def top_k_mask(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mask logits outside each row's top-k to NEG_INF.

    logits: (B, V); k: (B,) int — ``k <= 0`` disables the filter for that
    row (equivalent to k = V).  Per-row k is a threshold gather, not a shape.
    """
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    kk = torch.clamp(torch.where(k <= 0, v, k), 1, v).long()
    thresh = torch.gather(desc, -1, (kk - 1)[:, None])  # (B, 1)
    return torch.where(logits >= thresh, logits, NEG_INF)


def sample_tokens(
    gen: torch.Generator,
    logits: torch.Tensor,
    temperature,
    top_k: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row sampling: (B, V) logits → (B,) int32 tokens.

    temperature: (B,) float (or a scalar) — rows with ``t <= 0`` take argmax.
    top_k:       (B,) int or None — per-row top-k filter (0 = off).
    ``gen`` is a generator on ``logits``' device; every call draws from it.
    """
    logits = logits.to(torch.float32)
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    if temperature.ndim == 0:
        temperature = temperature.expand(logits.shape[:1])
    greedy = torch.argmax(logits, dim=-1)

    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if top_k is not None:
        scaled = top_k_mask(scaled, torch.as_tensor(top_k, device=logits.device))
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(scaled.shape, generator=gen, device=logits.device).clamp_(min=tiny)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
