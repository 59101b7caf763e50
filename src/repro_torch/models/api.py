"""Model API over the ported families (port of ``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` with the parameter
definitions, ``init``/``apply`` (``(logits, aux)``, as the reference's), the
serving calls ``prefill``/``decode`` over a ``make_cache`` cache, and the
optimizer metadata (weight-decay mask, trust-ratio mask, stacked-layer
axes), all keyed by the JAX paths.  It dispatches on ``cfg.family`` as the
reference does: ``hybrid`` to ``models/hybrid.py`` (Jamba), ``ssm`` to
``models/xlstm_model.py``, every other family to ``models/transformer.py``.
Under a ``model`` axis of more than one rank (the ambient sharding context)
every family trains and serves, each layer on this rank's heads, ff
columns, experts, ``inner`` slice or vocab rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import hybrid, transformer, xlstm_model


def _family(cfg: ModelConfig):
    """The module of ``cfg``'s family, with its ``forward`` and
    ``make_cache``."""
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm":
        return xlstm_model
    return transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    defs: Any

    def init(self, seed: int, device: torch.device, keep=None) -> nn.Params:
        """The parameters drawn from ``seed`` (``keep``: see
        :func:`~repro_torch.nn.init_params`)."""
        return nn.init_params(self.defs, seed, torch.device(device), self.cfg.param_dtype,
                              keep=keep)

    def abstract_params(self) -> nn.Params:
        """Meta tensors of every leaf, floating leaves in ``param_dtype``:
        the parameters :meth:`init` would draw, with no storage."""
        return self.init(0, "meta")

    def wd_mask(self) -> Dict[str, bool]:
        return nn.weight_decay_mask(self.defs)

    def trust_mask(self) -> Dict[str, bool]:
        return nn.trust_ratio_mask(self.defs)

    def unreachable(self) -> frozenset:
        """Leaves the loss does not reach (zero gradient in the train step)."""
        return transformer.unreachable_leaves(self.cfg)

    def layer_axes(self) -> Dict[str, int]:
        axes = nn.layer_axis_tree(self.defs)
        if self.cfg.lamb_granularity == "leaf":
            return {k: -1 for k in axes}
        return axes

    def apply(self, params: nn.Params, batch, *, return_hidden: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Train/encoder forward: ``(logits, aux)``, the (B, S, V) logits in
        the activation dtype (with ``return_hidden`` the final hidden states
        (B, S, D) for the fused CE head: transformer families only, as in
        the reference) and the MoE aux losses averaged over the layers (empty
        for a dense model)."""
        if return_hidden:
            if _family(self.cfg) is not transformer:
                raise ValueError(f"return_hidden is not supported for family "
                                 f"{self.cfg.family!r} (transformer families only)")
            return transformer.forward(params, batch, self.cfg, return_hidden=True)
        return _family(self.cfg).forward(params, batch, self.cfg)

    def prefill(self, params: nn.Params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """(B, S, V) logits of the prompt, and ``cache`` filled in place with
        its S positions (the aux losses are dropped, as in the reference).
        Weights are cast to the activation dtype where they
        are used, as in the reference."""
        logits, _ = _family(self.cfg).forward(params, batch, self.cfg, caches=cache,
                                              decode=False)
        return logits, cache

    def decode(self, params: nn.Params, batch, cache, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Any]:
        """(B, S, V) logits of ``batch["tokens"]`` at ``positions`` (B, S),
        each layer's k/v written into ``cache`` at its index (a recurrent
        layer's state overwritten), in place."""
        logits, _ = _family(self.cfg).forward(params, batch, self.cfg, caches=cache,
                                              decode=True, positions=positions)
        return logits, cache

    def make_cache(self, batch: int, max_len: int, device) -> Dict[str, Any]:
        """A zeroed cache for ``batch`` rows of ``max_len`` positions in the
        activation dtype, on ``device`` (recurrent state: O(1) in
        ``max_len``, fp32 where the reference keeps it so).  A rank of a
        mesh cuts its block from a meta one
        (``sharding.placement.cache_block``)."""
        return _family(self.cfg).make_cache(self.cfg, batch, max_len,
                                            dtype=nn.torch_dtype(self.cfg.activation_dtype),
                                            device=torch.device(device))

    def input_specs(self, shape: InputShape, device="meta") -> Dict[str, torch.Tensor]:
        return input_specs(self.cfg, shape, device)

    def param_count(self) -> int:
        return nn.param_count(self.defs)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k experts + non-MoE):
        the routed-expert leaves (axes holding ``experts``) count k/E."""
        cfg = self.cfg
        total = nn.param_count(self.defs)
        if cfg.n_experts == 0:
            return total
        routed = 0
        for p in nn.flatten(self.defs).values():
            if "experts" in p.axes:
                n = 1
                for d in p.shape:
                    n *= d
                routed += n
        active_frac = cfg.n_experts_per_tok / cfg.n_experts
        return int(total - routed + routed * active_frac)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``; raises for what the port does not have yet."""
    if cfg.family == "hybrid":
        return Model(cfg, hybrid.hybrid_defs(cfg))
    if cfg.family == "ssm":
        return Model(cfg, xlstm_model.xlstm_defs(cfg))
    return Model(cfg, transformer.transformer_defs(cfg))


# ---------------------------------------------------------------------------
# dry-run inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: InputShape, device="meta") -> Dict[str, torch.Tensor]:
    """Empty stand-ins (meta tensors by default) for every model input of
    ``shape``, as the reference's ``input_specs``:

    train:   {tokens, labels} (+ modality stubs)
    prefill: {tokens} (+ stubs)
    decode:  {tokens: (B, 1)}; the cache is supplied separately.
    """
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    act = nn.torch_dtype(cfg.activation_dtype)

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    if cfg.frontend == "audio_stub":
        specs = {"frame_embeds": spec((b, s, d), act), "mask": spec((b, s), torch.bool)}
        if shape.kind == "train":
            specs["labels"] = spec((b, s))
        return specs
    if shape.kind == "decode":
        return {"tokens": spec((b, 1))}
    if cfg.frontend == "vision_stub":
        n_img = cfg.n_prefix_tokens
        specs = {"tokens": spec((b, s - n_img)), "image_embeds": spec((b, n_img, d), act)}
        if shape.kind == "train":
            specs["labels"] = spec((b, s))
        return specs
    specs = {"tokens": spec((b, s))}
    if shape.kind == "train":
        specs["labels"] = spec((b, s))
    return specs
