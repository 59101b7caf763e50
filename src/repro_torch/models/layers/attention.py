"""Multi-head attention: MHA / GQA / MQA, causal / bidirectional / sliding
window, with a fixed-size KV cache for prefill and decode.

Port of ``repro.models.layers.attention``: projections (plus the qkv
biases where ``cfg.use_qkv_bias``), RoPE, then flash attention (kernels
K3–K5 through ``kernels.ops.flash_sdpa``) when ``cfg.use_flash_kernel``,
else ``_sdpa`` under the additive ``_mask_bias``, and the output
projection.  A ``cfg.logit_softcap`` is applied in ``_sdpa`` only: the
flash kernels take raw scores, so a config that sets both is refused when
its model is built (``transformer.check_flash_softcap``).  With a cache, prefill
attends as above and fills ``cache[:, :S]``; decode writes its k/v at ``index`` and runs the
dense ``_sdpa`` over the whole cache under a length/window mask (never the
flash kernel, as in the reference).

Layouts follow the JAX package: q (B, S, H, Dh), k/v (B, T, Hkv, Dh),
``wq`` (D, H, Dh), ``wo`` (H, Dh, D); a cache is ``{"k", "v"}`` of
(B, T, Hkv, Dh) in the activation dtype and an int32 ``index``.  The JAX
package returns a new cache (its buffers donated); here every write lands
in the cache's own tensors, index included.

Over a ``model`` axis of M ranks (the ambient sharding context) whose specs
split the heads, this rank's ``wq``/``wk``/``wv`` (and biases) hold H/M and
Hkv/M heads: q, k and v are column-parallel products on them, attention
(flash or dense) runs on the local heads, and ``wo`` is a row-parallel
product summed over ``model`` (``layers/tensor_parallel.py``).  Where the
heads split and the kv heads stay whole (GQA whose kv heads ``model`` does
not divide), k and v are whole on every rank and each rank attends with
its q heads against their global kv heads as MHA
(``tensor_parallel.kv_heads_for_rank``), the kv gradient summed over
``model``.

Serving on such a mesh: the rank's cache holds the kv heads its specs give
it, Hkv/M where they split and all Hkv where they stay whole.  Prefill
writes the cache before k and v are expanded to the rank's q-head rows;
decode reads the cache's kv heads for the rank's q heads (the heads'
global kv heads, ``_rank_kv``: a view where they come in equal groups).
Where the cache's sequence is split over the data-parallel ranks (the
reference's ``cache_seq`` rule; long-context decode at batch 1, every rank
holding every row) rank r of N holds positions [r·T/N, (r+1)·T/N): prefill
computes k and v for the whole prompt and attends over it whole (K3 with
flash), each rank copying the positions that fall in its block; a decode
step's k/v are written by the rank that owns ``index`` alone (for the slot
pool's (B,) index, each row by the rank that owns that row's), each rank
scores its own positions under the absolute-position mask (each row
against its own valid length) and keeps its row max, sum and unnormalised
output in fp32 (``softmax_partial``), and the data group combines them
(``combine_partials``: the max all-reduced, the rescaled sums and outputs
all-reduced).  A block with no valid key for a row adds e^(−1e9) = 0
there, as the reference's −1e9 bias does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_sdpa
from repro_torch.models.layers.embeddings import apply_rope
from repro_torch.models.layers.tensor_parallel import (
    column_matmul,
    kv_head_index,
    kv_heads_for_rank,
    row_matmul,
    split_axis,
)
from repro_torch.nn.module import Param
from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.context import ModelAxis, cache_seq_axis, model_parallel

NEG_INF = -1e9


def attention_defs(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": Param((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": Param((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": Param((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": Param((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_qkv_bias:
        bias = dict(init="zeros", no_weight_decay=True, no_trust_ratio=True)
        defs["bq"] = Param((h, dh), ("heads", "head_dim"), **bias)
        defs["bk"] = Param((hkv, dh), ("kv_heads", "head_dim"), **bias)
        defs["bv"] = Param((hkv, dh), ("kv_heads", "head_dim"), **bias)
    return defs


def _mask_bias(
    q_pos: torch.Tensor,      # (B, S) absolute positions of queries
    kv_pos: torch.Tensor,     # (T,) absolute positions of keys
    kv_valid_len: Optional[torch.Tensor],  # (B,) number of valid keys
    *,
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """(B, 1, S, T) additive mask bias in fp32."""
    q = q_pos[:, :, None]
    k = kv_pos[None, None, :]
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    if kv_valid_len is not None:
        valid = kv_valid_len[:, None, None] if kv_valid_len.ndim == 1 else kv_valid_len
        ok &= k < valid
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)[:, None]


def _sdpa(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, Hkv, Dh)
    v: torch.Tensor,  # (B, T, Hkv, Dh)
    bias: torch.Tensor,  # (B, 1, S, T)
    n_kv_heads: int,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Dense attention: scores in q's dtype scaled by 1/sqrt(Dh) (taken in
    q's dtype), in fp32 capped to ``softcap · tanh(s / softcap)`` where
    given, fp32 softmax over the biased scores, probs cast back."""
    scores, vt = _scores(q, k, v, bias, n_kv_heads, softcap)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _heads_out(probs @ vt, q.shape)                           # b n g s d


def _scores(q, k, v, bias, n_kv_heads, softcap):
    """``_sdpa``'s fp32 biased scores (B, Hkv, G, S, T) and v as (B, Hkv,
    1, T, Dh)."""
    b, s, h, dh = q.shape
    g = h // n_kv_heads
    qg = q.reshape(b, s, n_kv_heads, g, dh).permute(0, 2, 3, 1, 4)  # b n g s d
    kt = k.permute(0, 2, 3, 1)[:, :, None]                           # b n 1 d t
    vt = v.permute(0, 2, 1, 3)[:, :, None]                           # b n 1 t d
    # a host scalar: a tensor copied to the card would block the host
    scale = float(torch.tensor(math.sqrt(dh), dtype=torch.float32).to(q.dtype))
    scores = (qg @ kt) / scale
    scores = scores.to(torch.float32)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    return scores + bias[:, :, None], vt


def _heads_out(out: torch.Tensor, shape) -> torch.Tensor:
    """(B, Hkv, G, S, Dh) → (B, S, H, Dh)."""
    return out.permute(0, 3, 1, 2, 4).reshape(shape)


def softmax_partial(scores: torch.Tensor, values: torch.Tensor):
    """The softmax of fp32 ``scores`` over one block of the keys (the last
    dim), unnormalised: ``(m, l, o)``, the row max, the sum of
    ``exp(s − m)`` and its weighted sum of ``values``, in fp32."""
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    return m, p.sum(-1, keepdim=True), p @ values.to(torch.float32)


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                     seq: ModelAxis) -> torch.Tensor:
    """Softmax-weighted outputs from each rank's block of the keys: with
    ``M`` the all-reduced max of the ranks' ``m``, ``Σ e^(m−M)·o / Σ
    e^(m−M)·l`` summed over ``seq``'s group, in fp32 (the decode-side twin
    of the vocab-parallel head's cross-rank logsumexp)."""
    top = all_reduce(m.clone(), "max", seq.group)
    w = torch.exp(m - top)
    return all_reduce(o * w, "sum", seq.group) / all_reduce(l * w, "sum", seq.group)


def write_prefill(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                  seq: Optional[ModelAxis] = None) -> None:
    """Write a prefill's (B, S, ...) leaves ``new`` at positions [0, S) of
    the same-named leaves of ``cache`` in place and set its index to S.
    With ``seq``, the cache holds this rank's block of positions: only the
    prompt's positions inside it are copied."""
    s = next(iter(new.values())).shape[1]
    t = cache[next(iter(new))].shape[1]
    start = 0 if seq is None else seq.index * t
    lo, hi = max(start, 0), min(start + t, s)
    if lo < hi:
        for name, x in new.items():
            cache[name][:, lo - start:hi - start].copy_(x[:, lo:hi])
    cache["index"].fill_(s)


def write_decode(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                 seq: Optional[ModelAxis] = None) -> torch.Tensor:
    """Write one decode step's (B, S, ...) leaves ``new`` (k/v, or the MLA's
    latents) into the same-named leaves of ``cache`` in place; returns the
    number of valid keys after it (scalar, or (B,) per slot).

    A scalar ``index`` (the static engine: one length for the batch) writes
    positions [idx, idx + S), its start clamped so they fit as
    ``dynamic_update_slice`` clamps it; a (B,) ``index`` (the slot pool)
    writes row b at idx[b].  Neither reads the index on the host.  With
    ``seq`` (one-token steps) the cache holds this rank's block of
    positions, and row b is written only by the rank whose block holds its
    index (one index for the batch, or each slot's own): the other ranks
    write their block's row back unchanged."""
    idx = cache["index"]
    s = next(iter(new.values())).shape[1]
    t = cache[next(iter(new))].shape[1]
    if seq is not None:
        if s != 1:
            raise ValueError("a cache split along its sequence takes one-token steps")
        b = next(iter(new.values())).shape[0]
        rows = torch.arange(b, device=idx.device)
        local = (torch.clamp(idx, 0, t * seq.size - 1).long() - seq.index * t).expand(b)
        mine = (local >= 0) & (local < t)
        pos = torch.clamp(local, 0, t - 1)
        for name, x in new.items():
            old = cache[name][rows, pos]
            write = mine.view(b, *[1] * (old.dim() - 1))
            cache[name][rows, pos] = torch.where(write, x[:, 0].to(old.dtype), old)
        valid = idx + s
    elif idx.ndim == 0:
        start = torch.clamp(idx, 0, t - s).long()
        pos = start + torch.arange(s, device=idx.device)
        for name, x in new.items():
            cache[name].index_copy_(1, pos, x.to(cache[name].dtype))
        valid = idx + s
    else:
        assert s == 1, "per-slot decode is single-token"
        rows = torch.arange(idx.shape[0], device=idx.device)
        for name, x in new.items():
            cache[name][rows, idx.long()] = x[:, 0].to(cache[name].dtype)
        valid = idx + 1
    idx.copy_(valid)
    return valid


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
    valid_len: Optional[torch.Tensor] = None,  # (B,) per-example valid length
) -> torch.Tensor:
    """Attention block (projections + SDPA + output projection).

    Modes, as in the reference:
      train/encoder: cache=None, decode=False
      prefill:       cache=a zeroed cache, decode=False → fills it in place
      decode:        cache=filled, decode=True, x (B, S, D) at ``positions``

    ``valid_len`` masks keys at positions >= valid_len[b] on the
    train/prefill path (at least key 0 stays visible on both paths, as in
    the JAX package); decode masks by the cache's index instead.
    """
    b, s, d = x.shape
    dtype = x.dtype
    dh = cfg.head_dim
    # this rank's heads: all of them, or H/M over a model axis, and Hkv/M
    # kv heads where M divides them (else all of them)
    h, hkv = p["wq"].shape[1], p["wk"].shape[1]
    tp = split_axis(h, cfg.n_heads, model_parallel())
    kv_tp = split_axis(hkv, cfg.n_kv_heads, tp)
    seq = None if cache is None else cache_seq_axis()
    if cache is not None and cache["k"].shape[2] != hkv:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} kv heads where this rank "
                         f"computes {hkv}: the cache's specs split the kv heads as the "
                         "parameters' do")

    def proj(w, heads, axis):
        return column_matmul(x, w.to(dtype).reshape(d, heads * dh), axis).view(b, s, heads, dh)

    q, k, v = proj(p["wq"], h, tp), proj(p["wk"], hkv, kv_tp), proj(p["wv"], hkv, kv_tp)
    if cfg.use_qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    whole_kv = tp is not None and kv_tp is None
    if cache is not None and decode:
        valid = write_decode(cache, {"k": k, "v": v}, seq)
        ck, cv, n_kv = cache["k"], cache["v"], hkv
        if whole_kv:   # the whole kv heads' cache: this rank's q heads' kv heads
            ck, cv, n_kv = _rank_kv(ck, cv, h, cfg, tp)
        t = ck.shape[1]
        first = 0 if seq is None else seq.index * t
        kv_pos = torch.arange(first, first + t, dtype=torch.int32, device=x.device)
        bias = _mask_bias(positions, kv_pos, valid, causal=True, window=cfg.sliding_window)
        if seq is None:
            out = _sdpa(q, ck, cv, bias, n_kv, cfg.logit_softcap)
        else:
            scores, vt = _scores(q, ck, cv, bias, n_kv, cfg.logit_softcap)
            out = _heads_out(combine_partials(*softmax_partial(scores, vt), seq).to(dtype),
                             q.shape)
    else:
        if cache is not None:  # prefill: cache[:, :s] (this rank's block of it)
            write_prefill(cache, {"k": k, "v": v}, seq)
        if whole_kv:   # whole kv heads: this rank's q heads' rows
            idx = kv_head_index(h, cfg.n_heads, cfg.n_kv_heads, tp, device=x.device)
            k, v = kv_heads_for_rank(k, idx, tp), kv_heads_for_rank(v, idx, tp)
            hkv = h
        if valid_len is not None:
            valid_len = torch.clamp(valid_len.to(torch.int32), min=1)
        if cfg.use_flash_kernel:
            out = flash_sdpa(q, k, v, causal=cfg.causal, kv_valid=valid_len,
                             window=cfg.sliding_window or 0)
        else:
            kv_pos = torch.arange(s, dtype=torch.int32, device=x.device)
            bias = _mask_bias(positions, kv_pos, valid_len, causal=cfg.causal,
                              window=cfg.sliding_window)
            out = _sdpa(q, k, v, bias, hkv, cfg.logit_softcap)
    return row_matmul(out.reshape(b, s, h * dh), p["wo"].to(dtype).reshape(h * dh, d), tp)


def _rank_kv(ck: torch.Tensor, cv: torch.Tensor, h: int, cfg: ModelConfig, tp: ModelAxis):
    """The cache's kv heads for this rank's ``h`` q heads, against a cache
    of all Hkv heads: ``(k, v, n_kv)`` for ``_sdpa``, whose grouping of the
    rank's q heads must be theirs on one device (q head ``j`` of the rank
    reads kv head ``(h0 + j)·Hkv // H``, ``kv_head_index``).  Where the
    rank's heads take ``n`` consecutive kv heads in groups of ``h/n``, the
    cache's slice of those (a view); else each q head's own rows."""
    first = tp.index * h
    heads = [(first + j) * cfg.n_kv_heads // cfg.n_heads for j in range(h)]
    n = heads[-1] - heads[0] + 1
    if h % n == 0 and heads == [heads[0] + j // (h // n) for j in range(h)]:
        return ck.narrow(2, heads[0], n), cv.narrow(2, heads[0], n), n
    idx = torch.tensor(heads, device=ck.device)
    return ck.index_select(2, idx), cv.index_select(2, idx), h


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, dtype=torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """A zeroed cache: k/v (batch, max_len, Hkv, Dh) in ``dtype``, index 0."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }
