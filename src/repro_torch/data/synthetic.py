"""Deterministic synthetic data (numpy port of ``repro.data.synthetic``).

A Zipfian-marginal Markov chain over tokens, the causal-LM and BERT-style
masked-LM batches built from it, and the vision and audio stubs' batches
(random patch or frame embeddings).  Same seed, same arrays as the JAX package's, byte for byte:
both are numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

IGNORE = -1  # mirrors repro_torch.train.loss.IGNORE


@dataclasses.dataclass
class SyntheticLM:
    """Markov-Zipf language source."""

    vocab_size: int
    seed: int = 0
    n_states: int = 8
    zipf_a: float = 2.0
    max_effective_vocab: int = 8192

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, self.max_effective_vocab)
        s = self.n_states
        self._v_eff = v
        ranks = np.arange(1, v + 1, dtype=np.float64)
        base = 1.0 / ranks**self.zipf_a
        self._cond = np.stack(
            [base[rng.permutation(v)] for _ in range(s)], axis=0
        )
        self._cond /= self._cond.sum(axis=1, keepdims=True)
        self._cum = np.cumsum(self._cond, axis=1)

    def tokens(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        """Same draws and same tokens as the JAX package's ``(cum < u).sum()``:
        on a non-decreasing row that count is ``searchsorted(row, u, "left")``,
        found here per state instead of by comparing the whole vocab row."""
        out = np.empty((batch, seq), np.int32)
        state = rng.integers(0, self.n_states, size=batch)
        for t in range(seq):
            u = rng.random(batch)
            tok = np.empty(batch, np.int32)
            for s in np.unique(state):
                rows = state == s
                tok[rows] = np.searchsorted(self._cum[s], u[rows], side="left")
            out[:, t] = tok
            state = tok % self.n_states
        return out


def lm_batch(
    source: SyntheticLM, rng: np.random.Generator, batch: int, seq: int
) -> Dict[str, np.ndarray]:
    toks = source.tokens(rng, batch, seq + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def vlm_batch(
    source: SyntheticLM,
    rng: np.random.Generator,
    batch: int,
    seq: int,
    n_prefix: int,
    d_model: int,
) -> Dict[str, np.ndarray]:
    """Vision stub: random patch embeddings + text; labels IGNORE on the prefix."""
    s_text = seq - n_prefix
    toks = source.tokens(rng, batch, s_text + 1)
    labels = np.full((batch, seq), IGNORE, np.int32)
    labels[:, n_prefix:] = toks[:, 1:]
    return {
        "tokens": toks[:, :-1],
        "image_embeds": rng.standard_normal((batch, n_prefix, d_model)).astype(np.float32),
        "labels": labels,
    }


def audio_batch(
    rng: np.random.Generator,
    batch: int,
    seq: int,
    d_model: int,
    vocab: int,
    mask_ratio: float,
) -> Dict[str, np.ndarray]:
    """HuBERT stub: frame embeddings, cluster-id targets (the argmax of a
    fixed random projection of each frame, so masked prediction is
    learnable) and a Bernoulli span mask with frame 0 always masked."""
    emb = rng.standard_normal((batch, seq, d_model)).astype(np.float32)
    proj = np.random.default_rng(1234).standard_normal((d_model, vocab)).astype(np.float32)
    labels = np.argmax(emb @ proj, axis=-1).astype(np.int32)
    mask = rng.random((batch, seq)) < mask_ratio
    mask[:, 0] = True
    return {"frame_embeds": emb, "mask": mask, "labels": labels}


def mlm_batch(
    source: SyntheticLM,
    rng: np.random.Generator,
    batch: int,
    seq: int,
    mask_ratio: float,
    mask_token: int = 3,
    max_predictions: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """BERT-style masked-LM batch: 80% [MASK] / 10% random / 10% kept.

    Per-row target counts are capped at ``max_predictions`` (default
    ``ceil(mask_ratio * seq)``); every row has at least one target.
    """
    toks = source.tokens(rng, batch, seq)
    labels = np.full((batch, seq), IGNORE, np.int32)
    cap = int(np.ceil(mask_ratio * seq))
    if max_predictions is not None:
        cap = min(cap, max_predictions)
    cap = max(min(cap, seq), 1)
    scores = rng.random((batch, seq))
    kth = np.partition(scores, cap - 1, axis=-1)[:, cap - 1]
    sel = (scores < mask_ratio) & (scores <= kth[:, None])
    none = ~sel.any(axis=1)
    sel[none, np.argmin(scores[none], axis=1)] = True
    labels[sel] = toks[sel]
    u = rng.random((batch, seq))
    corrupted = toks.copy()
    corrupted[sel & (u < 0.8)] = mask_token
    rand_ids = rng.integers(0, source._v_eff, size=(batch, seq)).astype(np.int32)
    rand_sel = sel & (u >= 0.8) & (u < 0.9)
    corrupted[rand_sel] = rand_ids[rand_sel]
    return {"tokens": corrupted, "labels": labels}


def make_batch(
    cfg: ModelConfig,
    rng: np.random.Generator,
    batch: int,
    seq: int,
    source: Optional[SyntheticLM] = None,
) -> Dict[str, np.ndarray]:
    if cfg.frontend == "audio_stub":
        return audio_batch(rng, batch, seq, cfg.d_model, cfg.vocab_size,
                           max(cfg.mask_ratio, 0.08))
    src = source or SyntheticLM(cfg.vocab_size)
    if cfg.frontend == "vision_stub":
        return vlm_batch(src, rng, batch, seq, cfg.n_prefix_tokens, cfg.d_model)
    if cfg.is_encoder:
        return mlm_batch(src, rng, batch, seq, max(cfg.mask_ratio, 0.15),
                         max_predictions=cfg.mlm_buffer_size(seq))
    return lm_batch(src, rng, batch, seq)


def batch_iterator(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
    host_index: int = 0,
    host_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite deterministic iterator; each host draws its own shard."""
    if batch % host_count:
        raise ValueError("global batch must divide host count")
    local = batch // host_count
    source = SyntheticLM(cfg.vocab_size, seed=seed)
    step = 0
    while True:
        rng = np.random.default_rng((seed, step, host_index))
        yield make_batch(cfg, rng, local, seq, source)
        step += 1
