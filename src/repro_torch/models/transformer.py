"""Dense transformer, train/encoder forward (port of ``repro.models.transformer``).

The JAX package ``lax.scan``s a block over stacked ``(layers, ...)`` leaves;
here the stack is split once per forward with ``torch.unbind`` (whose
backward is a single ``stack``, so the gradient of each stacked leaf comes
back as one contiguous ``(layers, ...)`` tensor — the view the LAMB kernels
take) and a Python loop runs the blocks.  Indexing ``p[i]`` per layer
instead would make every ``select`` backward allocate a zero tensor the size
of the whole stack.

Only the dense family's train path is ported: MoE, MLA, dense prefixes,
untied heads, MTP, modality frontends, remat and the KV caches raise
(ROADMAP.md queue 1, items 9–10).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import attention, attention_defs
from repro_torch.models.layers.embeddings import embed, embed_defs, tied_unembed
from repro_torch.models.layers.mlp import mlp, mlp_defs
from repro_torch.models.layers.norms import apply_norm, norm_defs

_UNPORTED = {
    "n_experts": "MoE",
    "use_mla": "MLA",
    "n_dense_layers": "dense prefix blocks",
    "use_mtp": "MTP",
    "logit_softcap": "logit softcap",
}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP.md queue 1, item 10)"
        )
    for field, what in _UNPORTED.items():
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{what} is not ported (ROADMAP.md queue 1, item 10)"
            )
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied output heads are not ported "
                                  "(ROADMAP.md queue 1, item 10)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported "
                                  "(ROADMAP.md queue 1, item 10)")
    if cfg.remat != "none":
        raise NotImplementedError("remat is not ported (ROADMAP.md queue 1, item 3)")


def _block_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": norm_defs(d, cfg.norm_type),
        "ln2": norm_defs(d, cfg.norm_type),
        "attn": attention_defs(cfg),
        "mlp": mlp_defs(d, cfg.d_ff, cfg.gated_mlp, cfg.act_fn),
    }


def transformer_defs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    return {
        "embed": embed_defs(cfg.vocab_size, cfg.d_model),
        "blocks": nn.stack(_block_defs(cfg), cfg.n_layers),
        "final_norm": norm_defs(cfg.d_model, cfg.norm_type),
    }


def _sub(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """``{"ln1/scale": ...}`` view of the ``prefix/``-paths of a flat dict."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def _one_block(
    bp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    h = apply_norm(_sub(bp, "ln1"), x)
    x = x + attention(_sub(bp, "attn"), h, positions, cfg, valid_len=valid_len)
    h = apply_norm(_sub(bp, "ln2"), x)
    return x + mlp(_sub(bp, "mlp"), h, cfg)


def forward(
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> torch.Tensor:
    """(B, S, V) logits of the tied head."""
    dtype = nn.torch_dtype(cfg.activation_dtype)
    x = embed(params["embed"], batch["tokens"], dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    valid_len = batch.get("valid_len")

    stacked = {k: torch.unbind(v, 0) for k, v in _sub(params, "blocks").items()}
    for i in range(cfg.n_layers):
        bp = {k: v[i] for k, v in stacked.items()}
        x = _one_block(bp, x, positions, cfg, valid_len=valid_len)

    x = apply_norm(_sub(params, "final_norm"), x)
    return tied_unembed(x, params["embed"])
