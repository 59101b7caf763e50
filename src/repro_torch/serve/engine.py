"""Serving engine: prefill + decode steps and a batched-request driver (port
of ``repro.serve.engine``).

``make_prefill_step`` / ``make_decode_step`` are the model's two serving
calls; the :class:`Engine` adds a minimal batched greedy/temperature
generation loop over them, on the device its params live on.  The cache is
written in place (the reference donates its buffers to ``jit``).

With a ``shard_ctx`` (a :class:`~repro_torch.sharding.ShardCtx` over a
concrete mesh, one engine a rank) the Engine serves on the mesh as the
reference's GSPMD does: the rank holds its parameter blocks (each call
gathers them over the data-parallel ranks, FSDP), its rows of the batch
(its block where the activation rules split ``batch``, every row where
they do not: ``placement.serving_rows``) and its block of the cache
(``placement.cache_block`` of a meta ``Model.make_cache``: heads,
``inner`` slice and, under the ``cache_seq`` rule, its block of
positions; ``placement.serving_ctx`` says which).  The last position's logits, the rank's vocab columns and
rows, are gathered over ``model`` and over the data-parallel ranks into
the batch's whole (B, V), from which every rank samples with the same
seeded generator: every rank returns every request's tokens, those one
device gives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import tree_leaves_with_paths
from repro_torch.models.api import Model
from repro_torch.serve.sampling import sample_tokens
from repro_torch.sharding.axes import batch_axes, specs_for
from repro_torch.sharding.collectives import gather_leaf, shard_block, to_compute
from repro_torch.sharding.context import ShardCtx, compute_layout, use_sharding
from repro_torch.sharding.placement import cache_block, leaf_dims, serving_ctx, serving_rows


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


class RankParams:
    """This rank's blocks of a model's parameters on ``shard_ctx``'s mesh:
    ``specs`` (the context's, by default the reference's parameter rules),
    their ``layouts``, and ``blocks`` cut from ``params``, each leaf the
    whole or already this rank's block.  :meth:`call` takes each block to
    the layout the layers compute in (``collectives.to_compute``: under the
    default rules FSDP's gather over the data-parallel ranks, the ``model``
    split kept): the parameters a serving call computes with."""

    def __init__(self, model: Model, params, shard_ctx: ShardCtx):
        self.ctx = shard_ctx
        mesh = shard_ctx.mesh
        self.specs = dict(shard_ctx.param_specs) or specs_for(model.defs, mesh)
        self.layouts = leaf_dims(self.specs, mesh)
        compute = specs_for(model.defs, mesh)
        self.compute = {k: compute_layout(compute[k], mesh) for k in self.specs}
        # over one data-parallel rank the default layout's blocks are the
        # compute blocks themselves
        dp = batch_axes(mesh)
        self._as_stored = mesh.extent(dp) == 1 and all(
            tuple(s for s in self.layouts[k].splits if s[1] != dp) == self.compute[k].splits
            for k in self.specs)
        whole = model.abstract_params()
        self.blocks = {k: self._block(k, v, whole[k]) for k, v in params.items()}

    def _block(self, path: str, x: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``path`` from ``x``, the whole leaf (of
        ``whole``'s shape) or already the block."""
        lay, mesh = self.layouts[path], self.ctx.mesh
        mine = shard_block(whole, lay, mesh).shape
        if x.shape == mine:
            return x
        if x.shape == whole.shape:
            return shard_block(x, lay, mesh)
        raise ValueError(f"parameter {path} of shape {tuple(x.shape)} is neither the whole "
                         f"{tuple(whole.shape)} nor this rank's block {tuple(mine)}")

    def compute_blocks(self, blocks) -> Dict[str, torch.Tensor]:
        """``blocks`` (this rank's, in the storage layouts) in the layouts
        the layers compute in."""
        if self._as_stored:
            return blocks
        mesh = self.ctx.mesh
        return {k: to_compute(v, self.layouts[k], self.compute[k], mesh)
                for k, v in blocks.items()}

    def call(self):
        """The parameters a call computes with (:meth:`compute_blocks` of
        the rank's blocks)."""
        return self.compute_blocks(self.blocks)


def gather_logits(last: torch.Tensor, ctx: ShardCtx, vocab: int) -> torch.Tensor:
    """A call's (rows, V or V/M) last-position logits under ``ctx`` → the
    batch's (B, V): gathered over ``model`` where the vocab is split, over
    the data-parallel ranks where each holds its own rows (without a
    context, ``last`` itself)."""
    if ctx is None:
        return last
    if last.shape[-1] != vocab:
        last = gather_leaf(last.contiguous(), 1, ctx.model_axis.group)
    if ctx.data_axis is not None:
        last = gather_leaf(last.contiguous(), 0, ctx.data_axis.group)
    return last


class Engine:
    """Static-batch generation engine (greedy / temperature sampling) on the
    device of ``params``; with ``shard_ctx``, one rank's engine over its
    mesh (see the module docstring).  ``params`` are then the whole tree or
    this rank's blocks of it (under ``shard_ctx.param_specs``, by default
    the reference's parameter rules); the Engine keeps the blocks
    (:class:`RankParams`)."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        max_len: int = 512,
        shard_ctx: Optional[ShardCtx] = None,
        seed: int = 0,
    ):
        self.model = model
        self.max_len = max_len
        self.shard_ctx = shard_ctx
        self.device = params_device(params)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model)
        self._rank = None
        if shard_ctx is not None:
            self._rank = RankParams(model, params, shard_ctx)
            params = self._rank.blocks
        self.params = params
        self.cache_bytes = 0   # this rank's cache, set by each batch

    def _gather(self, last: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
        """(rows, V or V/M) last-position logits → the batch's (B, V)."""
        return gather_logits(last, ctx, self.model.cfg.vocab_size)

    def _sample(self, logits, temperatures: torch.Tensor):
        """Per-row sampling: each request keeps its own temperature."""
        return sample_tokens(self.gen, logits, temperatures)

    def _run(self, toks: np.ndarray, steps: int, choose) -> None:
        """Prefill the (B, S) prompts ``toks``, then decode ``steps`` tokens:
        ``choose(t, logits)`` takes the batch's (B, V) logits after step
        ``t`` (0: the prefill) and returns the (B,) tokens fed next."""
        b, s = toks.shape
        if s + steps > self.max_len:
            raise ValueError(f"batch needs {s + steps} cache positions but "
                             f"max_len is {self.max_len}")
        ctx, params, start, rows = None, self.params, 0, b
        if self.shard_ctx is None:
            cache = self.model.make_cache(b, self.max_len, self.device)
        else:
            meta = self.model.make_cache(b, self.max_len, "meta")
            ctx = serving_ctx(self.shard_ctx, self._rank.specs, meta, b)
            start, rows, _ = serving_rows(b, ctx.mesh, ctx.act_rules)
            cache = cache_block(meta, ctx.mesh, ctx.act_rules, self.device)
        with use_sharding(ctx):
            if ctx is not None:
                params = self._rank.call()
            tokens = torch.from_numpy(toks[start:start + rows]).to(self.device)
            last, cache = self._prefill(params, {"tokens": tokens}, cache)
            tok = choose(0, last if ctx is None else self._gather(last, ctx))
            for t in range(steps):
                positions = torch.full((rows, 1), s + t, dtype=torch.int32, device=self.device)
                mine = tok[start:start + rows, None].to(torch.int32)
                last, cache = self._decode(params, cache, mine, positions)
                tok = choose(t + 1, last if ctx is None else self._gather(last, ctx))
        self.cache_bytes = sum(x.numel() * x.element_size()
                               for _, x in tree_leaves_with_paths(cache))

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
        largest budget), which the reference's clamped writes hide, and on
        a mesh when the rules split the batch's rows over only some of its
        data-parallel axes.
        """
        t0 = time.perf_counter()
        b = len(requests)
        s = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, s), np.int32)
        for i, r in enumerate(requests):
            toks[i, : len(r.prompt)] = r.prompt  # left-aligned, zero-padded
        max_new = max(r.max_new_tokens for r in requests)
        temps = torch.tensor([r.temperature for r in requests], dtype=torch.float32,
                             device=self.device)
        # all-greedy (the default): skip sampling and leave the generator untouched
        greedy = max(r.temperature for r in requests) <= 0.0
        out = np.zeros((b, max_new), np.int32)

        def choose(t, logits):
            tok = (torch.argmax(logits, dim=-1) if greedy
                   else self._sample(logits, temps))
            if t < max_new:
                out[:, t] = tok.cpu().numpy()
            return tok

        self._run(toks, max_new, choose)
        dt = time.perf_counter() - t0
        for i, r in enumerate(requests):
            r.out_tokens = out[i, : r.max_new_tokens]
            r.latency_s = dt
        return requests

    @torch.inference_mode()
    def replay(self, prompts: np.ndarray, forced: np.ndarray) -> torch.Tensor:
        """Teacher-forced logits: the (B, S) ``prompts`` prefilled, then one
        decode step for each column of the (B, n) ``forced`` tokens; returns
        the batch's (B, n + 1, V) last-position logits in fp32 (on a mesh
        gathered whole, as the Engine samples from them)."""
        rows = []
        forced = torch.from_numpy(np.asarray(forced, np.int32)).to(self.device)

        def choose(t, logits):
            rows.append(logits.float())
            return forced[:, t] if t < forced.shape[1] else None

        self._run(np.asarray(prompts, np.int32), forced.shape[1], choose)
        return torch.stack(rows, 1)

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
