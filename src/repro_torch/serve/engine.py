"""Serving engine: prefill + decode steps and a batched-request driver (port
of ``repro.serve.engine``).

``make_prefill_step`` / ``make_decode_step`` are the model's two serving
calls; the :class:`Engine` adds a minimal batched greedy/temperature
generation loop over them, on the device its params live on.  The cache is
written in place (the reference donates its buffers to ``jit``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve.sampling import sample_tokens


def make_prefill_step(model: Model):
    """prefill_step(params, batch, cache) -> (last_logits(B,V), cache).

    Invariant: the returned cache holds every prompt position, so the first
    decode step can start at position ``prompt_len``.
    """

    def prefill_step(params, batch, cache):
        logits, cache = model.prefill(params, batch, cache)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(model: Model):
    """One-token step: (params, cache, tokens(B,1), positions(B,1)) → logits.

    Returns (logits(B,V), cache).  Invariant: fixed shapes over the whole
    decode loop; the cache is written in place.
    """

    def decode_step(params, cache, tokens, positions):
        logits, cache = model.decode(params, {"tokens": tokens}, cache, positions)
        return logits[:, -1], cache

    return decode_step


@dataclasses.dataclass
class Request:
    """One static-batch generation request (temperature 0 = greedy);
    ``out_tokens``/``latency_s`` are filled in by ``generate_batch``."""

    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: Optional[np.ndarray] = None
    latency_s: float = 0.0


def params_device(params) -> torch.device:
    """The device the (flat dict of) params live on."""
    return next(iter(params.values())).device


class Engine:
    """Static-batch generation engine (greedy / temperature sampling) on the
    device of ``params``."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        max_len: int = 512,
        seed: int = 0,
    ):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = params_device(params)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)

    def _sample(self, logits, temperatures: torch.Tensor):
        """Per-row sampling: each request keeps its own temperature."""
        return sample_tokens(self.gen, logits, temperatures)

    @torch.inference_mode()
    def generate_batch(self, requests: List[Request]) -> List[Request]:
        """Pad prompts to a common length, prefill once, decode to the
        slowest request's budget.

        Args: a list of :class:`Request`.  Returns the same list with
        ``out_tokens`` (each trimmed to its own ``max_new_tokens``) and a
        shared ``latency_s`` filled in.  Invariant: the whole batch decodes
        in lock-step — a short request waits on the longest one (the
        limitation ContinuousEngine removes).  Raises ValueError when the
        batch's decode would write past ``max_len`` (prompt length plus the
        largest budget), which the reference's clamped writes hide.
        """
        t0 = time.perf_counter()
        b = len(requests)
        s = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, s), np.int32)
        for i, r in enumerate(requests):
            toks[i, : len(r.prompt)] = r.prompt  # left-aligned, zero-padded
        max_new = max(r.max_new_tokens for r in requests)
        if s + max_new > self.max_len:
            raise ValueError(f"batch needs {s + max_new} cache positions but "
                             f"max_len is {self.max_len}")
        temps = torch.tensor([r.temperature for r in requests], dtype=torch.float32,
                             device=self.device)
        # all-greedy (the default): skip sampling and leave the generator untouched
        greedy = max(r.temperature for r in requests) <= 0.0
        sample = (
            (lambda logits: torch.argmax(logits, dim=-1)) if greedy
            else (lambda logits: self._sample(logits, temps))
        )

        cache = self.model.make_cache(b, self.max_len, self.device)
        tokens = torch.from_numpy(toks).to(self.device)
        last, cache = self._prefill(self.params, {"tokens": tokens}, cache)
        out = np.zeros((b, max_new), np.int32)
        tok = sample(last)
        for t in range(max_new):
            out[:, t] = tok.cpu().numpy()
            positions = torch.full((b, 1), s + t, dtype=torch.int32, device=self.device)
            last, cache = self._decode(
                self.params, cache, tok[:, None].to(torch.int32), positions
            )
            tok = sample(last)

        dt = time.perf_counter() - t0
        for i, r in enumerate(requests):
            r.out_tokens = out[i, : r.max_new_tokens]
            r.latency_s = dt
        return requests

    def throughput_stats(self, requests: List[Request]) -> Dict[str, float]:
        """Aggregate a completed batch: request/token counts, wall time,
        tokens/s (batch-level, since latency is shared)."""
        n_new = sum(r.max_new_tokens for r in requests)
        dt = max(r.latency_s for r in requests)
        return {
            "requests": len(requests),
            "new_tokens": n_new,
            "wall_s": dt,
            "tokens_per_s": n_new / dt if dt else 0.0,
        }
