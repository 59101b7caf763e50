"""Multi-head attention, train/encoder path (no KV cache).

Port of the train/encoder path of ``repro.models.layers.attention``:
projections, RoPE, then flash attention (kernels K3–K5 through
``kernels.ops.flash_sdpa``) when ``cfg.use_flash_kernel``, else ``_sdpa``
under the additive ``_mask_bias``, and the output projection.  The
decode/prefill cache branch is not ported yet (ROADMAP.md queue 1, item 9).

Layouts follow the JAX package: q (B, S, H, Dh), k/v (B, T, Hkv, Dh),
``wq`` (D, H, Dh), ``wo`` (H, Dh, D).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_sdpa
from repro_torch.models.layers.embeddings import apply_rope
from repro_torch.nn.module import Param

NEG_INF = -1e9


def attention_defs(cfg: ModelConfig) -> dict:
    if cfg.use_qkv_bias:
        raise NotImplementedError("qkv bias is not ported (ROADMAP.md queue 1, item 10)")
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": Param((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": Param((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": Param((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": Param((h, dh, d), ("heads", "head_dim", "embed")),
    }


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
) -> torch.Tensor:
    """Dense attention: scores in q's dtype scaled by 1/sqrt(Dh) (taken in
    q's dtype), fp32 softmax over the biased scores, probs cast back."""
    b, s, h, dh = q.shape
    g = h // n_kv_heads
    qg = q.reshape(b, s, n_kv_heads, g, dh).permute(0, 2, 3, 1, 4)  # b n g s d
    kt = k.permute(0, 2, 3, 1)[:, :, None]                           # b n 1 d t
    vt = v.permute(0, 2, 1, 3)[:, :, None]                           # b n 1 t d
    scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(q.dtype)
    scores = (qg @ kt) / scale.to(q.device)
    scores = scores.to(torch.float32) + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = probs @ vt                                                 # b n g s d
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    valid_len: Optional[torch.Tensor] = None,  # (B,) per-example valid length
) -> torch.Tensor:
    """Train/encoder attention block (projections + SDPA + output projection).

    ``valid_len`` masks keys at positions >= valid_len[b] (at least key 0
    stays visible on both paths, as in the JAX package).
    """
    b, s, d = x.shape
    dtype = x.dtype
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(w, heads):
        return (x @ w.to(dtype).reshape(d, heads * dh)).view(b, s, heads, dh)

    q, k, v = proj(p["wq"], h), proj(p["wk"], hkv), proj(p["wv"], hkv)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if valid_len is not None:
        valid_len = torch.clamp(valid_len.to(torch.int32), min=1)
    if cfg.use_flash_kernel:
        out = flash_sdpa(q, k, v, causal=cfg.causal, kv_valid=valid_len,
                         window=cfg.sliding_window or 0)
    else:
        kv_pos = torch.arange(s, dtype=torch.int32, device=x.device)
        bias = _mask_bias(positions, kv_pos, valid_len, causal=cfg.causal,
                          window=cfg.sliding_window)
        out = _sdpa(q, k, v, bias, hkv)
    return out.reshape(b, s, h * dh) @ p["wo"].to(dtype).reshape(h * dh, d)
