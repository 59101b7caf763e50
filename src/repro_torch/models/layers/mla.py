"""Multi-head Latent Attention (DeepSeek-V2/V3; port of
``repro.models.layers.mla``).

Queries and keys/values are projected through low-rank latents; only the
compressed KV latent (``kv_lora_rank``) and the shared rope key
(``qk_rope_dim``) are cached, (512 + 64) values a token at full width
instead of 2·H·Dh = 2·128·192.

Two score paths, as in the reference:

* naive: per-head K/V are rebuilt from the latent for every cached token
  (``(B, T, H, Dh)``), the rope key broadcast over the heads;
* absorbed (``cfg.mla_absorb``): W_uk is folded into the query and W_uv
  applied after the attention, so the scores and the weighted sum run in
  the latent space and the per-head K/V never exist.

Both cast where the reference casts: the products in the activation dtype,
the scores to fp32 times the fp32 scale, plus the (B, 1, S, T) bias,
softmax, probs cast back.  The MLA never routes through the flash kernels
(the reference's does not, whatever ``use_flash_kernel`` says).

With a cache (``{"c_kv" (B, T, kv_lora), "k_rope" (B, T, rope), "index"}``)
prefill writes positions [0, S) and decode writes at ``index`` (a scalar,
or (B,) per slot in the serving pool), in place as ``attention.py`` does,
and both attend over the whole cache under a length mask, as the reference
does.  Layouts are the reference's: ``wq_b`` (q_lora, H, nope + rope),
``wkv_a`` (D, kv_lora + rope), ``wk_b``/``wv_b`` (kv_lora, H, ·), ``wo``
(H, v_head, D).

Over a ``model`` axis of M ranks whose specs split the heads, this rank's
``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` hold H/M heads; ``wq_a``,
``q_norm``, ``wkv_a`` and ``kv_norm`` are whole (their ``embed`` dimension
splits over ``data`` only), so ``cq``, ``c_kv`` and ``k_rope`` are the same
on every rank.  ``wq_b`` is column-parallel, every score and the absorbed
products are per head and so local, and ``wo`` is row-parallel
(``layers/tensor_parallel.py``).  The latents feed only the rank's heads,
so their gradients are partial: ``cq``'s is summed by the column-parallel
product, ``c_kv``'s and ``k_rope``'s over ``model`` before they reach
``wkv_a`` and ``x``.

Serving on such a mesh: ``c_kv`` and ``k_rope`` have no heads axis, so the
latent cache is whole on every ``model`` rank (each writes the same
latents) and each rank attends with its H/M heads, naive or absorbed.
Where the cache's sequence is split over the data-parallel ranks (batch 1),
rank r holds its block of positions as ``attention.py`` says: prefill
attends over the prompt's own latents and copies its block's positions;
decode writes at ``index`` on the owning rank, scores its block and
combines the ranks' unnormalised outputs in fp32
(``attention.combine_partials``), in the absorbed form the latent-space
outputs, before the up-projection ``wv_b``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import (
    _mask_bias,
    combine_partials,
    softmax_partial,
    write_decode,
    write_prefill,
)
from repro_torch.models.layers.embeddings import apply_rope
from repro_torch.models.layers.tensor_parallel import column_matmul, row_matmul, split_axis
from repro_torch.nn.module import Param
from repro_torch.sharding.collectives import copy_to_model
from repro_torch.sharding.context import ModelAxis, cache_seq_axis, model_parallel


def mla_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    norm = dict(init="ones", no_weight_decay=True, no_trust_ratio=True)
    return {
        "wq_a": Param((d, qr), ("embed", "q_lora")),
        "q_norm": Param((qr,), ("q_lora",), **norm),
        "wq_b": Param((qr, h, dn + dr), ("q_lora", "heads", "qk_dim")),
        "wkv_a": Param((d, kr + dr), ("embed", "kv_lora")),
        "kv_norm": Param((kr,), ("kv_lora",), **norm),
        "wk_b": Param((kr, h, dn), ("kv_lora", "heads", "qk_dim")),
        "wv_b": Param((kr, h, dv), ("kv_lora", "heads", "v_dim")),
        "wo": Param((h, dv, d), ("heads", "v_dim", "embed")),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The MLA's own RMS norm of the latents: fp32, eps 1e-6, cast back."""
    x32 = x.to(torch.float32)
    y = x32 / torch.sqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _latents(p: Dict[str, torch.Tensor], x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig, tp: Optional[ModelAxis] = None):
    """Shared projections → ``(q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv
    (B,S,kr), k_rope (B,S,dr))``, the rope parts rotated; over the ``model``
    ranks ``tp`` the rank's heads of q, and latents whose gradients are
    summed over ``model``."""
    dtype = x.dtype
    b, s, _ = x.shape
    h, dn, dr, kr = p["wq_b"].shape[1], cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    qr = cfg.q_lora_rank
    cq = _rms(x @ p["wq_a"].to(dtype), p["q_norm"])
    q = column_matmul(cq, p["wq_b"].to(dtype).reshape(qr, h * (dn + dr)), tp
                      ).view(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = x @ p["wkv_a"].to(dtype)
    c_kv = _rms(kv[..., :kr], p["kv_norm"])
    k_rope = apply_rope(kv[..., kr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    if tp is not None:
        c_kv, k_rope = copy_to_model(c_kv, tp.group), copy_to_model(k_rope, tp.group)
    return q_nope, q_rope, c_kv, k_rope


def _mask(positions: torch.Tensor, t: int, valid: Optional[torch.Tensor],
          first: int = 0) -> torch.Tensor:
    """(B, 1, S, T) fp32 bias over keys at positions ``first + [0, T)``: 0
    where key <= query position and key < ``valid`` (scalar or (B,)),
    -1e9 elsewhere."""
    kv_pos = torch.arange(first, first + t, dtype=torch.int32, device=positions.device)
    return _mask_bias(positions, kv_pos, valid, causal=True, window=None)


def mla_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
    valid_len: Optional[torch.Tensor] = None,  # (B,) per-example valid length
) -> torch.Tensor:
    """The MLA block (latent projections, scores, output projection): x
    (B, S, D) → (B, S, D).  Modes as ``attention.attention``'s: train
    (no cache), prefill (a zeroed cache, filled in place) and decode (a
    filled cache, written at its index in place)."""
    dtype = x.dtype
    b, s, d = x.shape
    if valid_len is not None:
        # same clamp as attention.py: fully-padded examples keep key 0
        valid_len = torch.clamp(valid_len.to(torch.int32), min=1)
    # this rank's heads: all of them, or H/M over a model axis
    h, dn, dr, dv = p["wq_b"].shape[1], cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    tp = split_axis(h, cfg.n_heads, model_parallel())
    seq = None if cache is None else cache_seq_axis()
    # a host scalar: 1/sqrt(dn + dr) taken in fp32, as the reference's
    scale = float(1.0 / torch.sqrt(torch.tensor(float(dn + dr), dtype=torch.float32)))

    q_nope, q_rope, c_kv, k_rope = _latents(p, x, positions, cfg, tp)

    first = 0
    if cache is not None and seq is not None and not decode:
        # prefill over a split cache: this rank's block of the prompt's
        # latents, attention over all of them
        write_prefill(cache, {"c_kv": c_kv, "k_rope": k_rope}, seq)
        kv_src, kr_src = c_kv, k_rope
        bias = _mask(positions, s, valid_len)
        seq = None
    elif cache is not None:
        if decode:
            valid = write_decode(cache, {"c_kv": c_kv, "k_rope": k_rope}, seq)
        else:   # prefill: positions [0, S)
            write_prefill(cache, {"c_kv": c_kv, "k_rope": k_rope})
            valid = torch.full((), s, dtype=torch.int32, device=x.device)
        kv_src, kr_src = cache["c_kv"].to(dtype), cache["k_rope"].to(dtype)
        if valid_len is not None:   # ragged prefill: an example may end before S
            valid = torch.minimum(valid, valid_len)
        first = 0 if seq is None else seq.index * kv_src.shape[1]
        bias = _mask(positions, kv_src.shape[1], valid, first)
    else:
        kv_src, kr_src = c_kv, k_rope
        bias = _mask(positions, s, valid_len)
    t = kv_src.shape[1]

    if cfg.mla_absorb:
        # attention in the latent space: q_lat = q_nope · W_uk per head
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(dtype))
        s_nope = (q_lat.transpose(1, 2).reshape(b, h * s, kr)
                  @ kv_src.transpose(1, 2)).view(b, h, s, t)
        s_rope = (q_rope.transpose(1, 2).reshape(b, h * s, dr)
                  @ kr_src.transpose(1, 2)).view(b, h, s, t)
        scores = (s_nope + s_rope).to(torch.float32) * scale + bias
        if seq is None:
            probs = torch.softmax(scores, dim=-1).to(dtype)
            o_lat = (probs.reshape(b, h * s, t) @ kv_src).view(b, h, s, kr)
        else:   # the ranks' latent-space outputs combined before W_uv
            o = combine_partials(*softmax_partial(scores.reshape(b, h * s, t), kv_src), seq)
            o_lat = o.to(dtype).view(b, h, s, kr)
        out = torch.einsum("bshr,rhv->bshv", o_lat.transpose(1, 2), p["wv_b"].to(dtype))
    else:
        # per-head K/V from the latent, the rope key broadcast over the heads
        k_nope = (kv_src @ p["wk_b"].to(dtype).reshape(kr, h * dn)).view(b, t, h, dn)
        v = (kv_src @ p["wv_b"].to(dtype).reshape(kr, h * dv)).view(b, t, h, dv)
        k = torch.cat([k_nope, kr_src[:, :, None, :].expand(b, t, h, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).to(torch.float32) * scale
        if seq is None:
            probs = torch.softmax(scores + bias, dim=-1).to(dtype)
            out = (probs @ v.transpose(1, 2)).transpose(1, 2)               # b s h v
        else:
            o = combine_partials(*softmax_partial(scores + bias, v.transpose(1, 2)), seq)
            out = o.to(dtype).transpose(1, 2)

    return row_matmul(out.reshape(b, s, h * dv), p["wo"].to(dtype).reshape(h * dv, d), tp)


def init_mla_cache(batch: int, max_len: int, cfg: ModelConfig, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """A zeroed latent cache: ``c_kv`` (batch, max_len, kv_lora), ``k_rope``
    (batch, max_len, rope) in ``dtype``, a scalar int32 ``index``."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }
