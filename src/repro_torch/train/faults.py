"""Deterministic numerical fault injection (port of ``repro.train.faults``).

A :class:`FaultInjector` wraps a deterministic data iterator and stamps
per-batch *fault channels*, extra ``fault/*`` leaves shaped ``(B,)`` so they
slice like real batch leaves, keyed by **batch ordinal** (position in the
stream), not by ``state.step``: with the non-finite guard on, a skipped step
does not advance ``state.step``, so a step-keyed fault would fire forever.

``make_train_step`` pops the channels out of the batch before the loss
(:func:`split_faults`) and applies them to the token-mean gradients on the
device (:func:`apply_grad_faults`):

* ``grad_nan`` / ``grad_inf``: every gradient leaf becomes NaN/Inf, the
  signature of a poisoned microbatch; drives the guard's skip path.
* ``grad_scale``: the gradients times a large factor (finite, so the guard
  passes and the optimizer moments take it).
* ``loss_spike``: ``scale`` added to the reported ``loss/total`` only.
* ``batch_nan``: the first float leaf of the batch itself poisoned at stamp
  time, upstream of the forward pass.

The same spec list over the same stream gives the same stamps, and ``once``
survives a rebuilt stream (the fired set lives on the injector).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Tuple

import torch

FAULT_PREFIX = "fault/"
GRAD_NAN_KEY = FAULT_PREFIX + "grad_nan"
GRAD_INF_KEY = FAULT_PREFIX + "grad_inf"
GRAD_SCALE_KEY = FAULT_PREFIX + "grad_scale"
LOSS_SPIKE_KEY = FAULT_PREFIX + "loss_spike"

KINDS = ("grad_nan", "grad_inf", "grad_scale", "loss_spike", "batch_nan")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: ``kind`` at batch ordinal ``at`` (0-based).

    ``at < 0`` fires on every batch.  ``once=True`` fires a non-negative
    ``at`` a single time even if the ordinal is replayed.  ``scale`` is the
    ``grad_scale`` multiplier (and the ``loss_spike`` magnitude).
    """

    kind: str
    at: int
    scale: float = 1e6
    once: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")


class FaultInjector:
    def __init__(self, faults: Iterable[FaultSpec]):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self._fired: Dict[int, int] = {}

    def _active(self, ordinal: int):
        out = []
        for idx, f in enumerate(self.faults):
            if f.at >= 0 and f.at != ordinal:
                continue
            if f.at >= 0 and f.once and self._fired.get(idx, 0):
                continue
            self._fired[idx] = self._fired.get(idx, 0) + 1
            out.append(f)
        return out

    def stamp(self, batch: Dict[str, torch.Tensor], ordinal: int) -> Dict[str, torch.Tensor]:
        """``batch`` plus the four fault channels (always present, on the
        batch's device); ``batch_nan`` faults poison the batch itself."""
        active = self._active(ordinal)
        b = dict(batch)
        first = next(iter(batch.values()))
        n, device = int(first.shape[0]), first.device
        nan_on = any(f.kind == "grad_nan" for f in active)
        inf_on = any(f.kind == "grad_inf" for f in active)
        scale = 1.0
        spike = 0.0
        for f in active:
            if f.kind == "grad_scale":
                scale *= f.scale
            if f.kind == "loss_spike":
                spike += f.scale

        def chan(value):
            return torch.full((n,), value, dtype=torch.float32, device=device)

        b[GRAD_NAN_KEY] = chan(1.0 if nan_on else 0.0)
        b[GRAD_INF_KEY] = chan(1.0 if inf_on else 0.0)
        b[GRAD_SCALE_KEY] = chan(scale)
        b[LOSS_SPIKE_KEY] = chan(spike)
        for f in active:
            if f.kind != "batch_nan":
                continue
            key = next((k for k in sorted(batch) if batch[k].is_floating_point()), None)
            if key is None:
                raise ValueError(
                    "batch_nan fault: batch has no float leaf to poison "
                    f"(keys: {sorted(batch)})"
                )
            leaf = batch[key].clone()
            leaf.view(-1)[0] = float("nan")
            b[key] = leaf
        return b

    def wrap(self, data: Iterator[Dict[str, torch.Tensor]]) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield ``data``'s batches with fault channels stamped; ordinals
        restart at 0 per wrapped stream, fired-once state persists."""

        def gen():
            for ordinal, batch in enumerate(data):
                yield self.stamp(batch, ordinal)

        return gen()


def split_faults(batch) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Pop the ``fault/*`` channels out of a batch: ``(clean_batch, faults)``;
    an unfaulted batch passes through untouched with an empty dict."""
    if not isinstance(batch, dict) or not any(k.startswith(FAULT_PREFIX) for k in batch):
        return batch, {}
    clean = {k: v for k, v in batch.items() if not k.startswith(FAULT_PREFIX)}
    faults = {k: v for k, v in batch.items() if k.startswith(FAULT_PREFIX)}
    return clean, faults


@torch.no_grad()
def apply_grad_faults(grads: Dict[str, torch.Tensor],
                      faults: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Apply stamped fault channels to the gradient dict, on the device.

    The ``(B,)`` channels are reduced to scalars first, then broadcast over
    every leaf; no host sync.
    """
    if not faults:
        return grads
    scale = faults.get(GRAD_SCALE_KEY)
    if scale is not None:
        s = scale.to(torch.float32).max()
        grads = {k: (g.to(torch.float32) * s).to(g.dtype) for k, g in grads.items()}
    for key, bad in ((GRAD_NAN_KEY, float("nan")), (GRAD_INF_KEY, float("inf"))):
        chan = faults.get(key)
        if chan is not None:
            on = chan.to(torch.float32).max() > 0
            grads = {k: torch.where(on, torch.full((), bad, dtype=g.dtype, device=g.device), g)
                     for k, g in grads.items()}
    return grads


def apply_loss_faults(metrics: Dict[str, torch.Tensor],
                      faults: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add any stamped ``loss_spike`` magnitude to the ``loss/total`` metric
    (the observed channel only: parameters and gradients are untouched)."""
    chan = faults.get(LOSS_SPIKE_KEY)
    if chan is None or "loss/total" not in metrics:
        return metrics
    metrics = dict(metrics)
    metrics["loss/total"] = metrics["loss/total"] + chan.to(torch.float32).max()
    return metrics
