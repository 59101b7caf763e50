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
``model``.  A cache on such a mesh raises.
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
from repro_torch.sharding.context import SEQ_SPLIT_CACHE, cache_seq_split, model_parallel

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
    scores = scores + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = probs @ vt                                                 # b n g s d
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def write_decode(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """Write one decode step's (B, S, ...) leaves ``new`` (k/v, or the MLA's
    latents) into the same-named leaves of ``cache`` in place; returns the
    number of valid keys after it (scalar, or (B,) per slot).

    A scalar ``index`` (the static engine: one length for the batch) writes
    positions [idx, idx + S), its start clamped so they fit as
    ``dynamic_update_slice`` clamps it; a (B,) ``index`` (the slot pool)
    writes row b at idx[b].  Neither reads the index on the host."""
    idx = cache["index"]
    s = next(iter(new.values())).shape[1]
    t = cache[next(iter(new))].shape[1]
    if idx.ndim == 0:
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
    if tp is not None and cache is not None:
        raise NotImplementedError("serving on a mesh (a KV cache of split heads) is not "
                                  "ported (ROADMAP.md queue 1, item 11 (e))")
    if cache is not None and cache_seq_split():
        raise NotImplementedError(SEQ_SPLIT_CACHE)

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
    if tp is not None and kv_tp is None:   # whole kv heads: this rank's q heads' rows
        idx = kv_head_index(h, cfg.n_heads, cfg.n_kv_heads, tp, device=x.device)
        k, v = kv_heads_for_rank(k, idx, tp), kv_heads_for_rank(v, idx, tp)
        hkv = h
    if cache is not None and decode:
        valid = write_decode(cache, {"k": k, "v": v})
        kv_pos = torch.arange(cache["k"].shape[1], dtype=torch.int32, device=x.device)
        bias = _mask_bias(positions, kv_pos, valid, causal=True, window=cfg.sliding_window)
        out = _sdpa(q, cache["k"], cache["v"], bias, hkv, cfg.logit_softcap)
    else:
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
        if cache is not None:  # prefill: fill cache[:, :s]
            cache["k"][:, :s].copy_(k)
            cache["v"][:, :s].copy_(v)
            cache["index"].fill_(s)
    return row_matmul(out.reshape(b, s, h * dh), p["wo"].to(dtype).reshape(h * dh, d), tp)


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, dtype=torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """A zeroed cache: k/v (batch, max_len, Hkv, Dh) in ``dtype``, index 0."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }
