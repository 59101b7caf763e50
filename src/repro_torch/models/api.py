"""Model API over the ported families (port of ``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` with the parameter
definitions, ``init``/``apply`` (``(logits, aux)``, as the reference's), the serving calls ``prefill``/``decode``
over a ``make_cache`` cache, and the optimizer metadata (weight-decay
mask, trust-ratio mask, stacked-layer axes), all keyed by the JAX paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    defs: Any

    def init(self, seed: int, device: torch.device) -> nn.Params:
        params = nn.init_params(self.defs, seed, torch.device(device))
        return nn.cast_tree(params, self.cfg.param_dtype)

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
        (B, S, D) for the fused CE head) and the MoE aux losses averaged over
        the layers (empty for a dense model)."""
        return transformer.forward(params, batch, self.cfg, return_hidden=return_hidden)

    def prefill(self, params: nn.Params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """(B, S, V) logits of the prompt, and ``cache`` filled in place with
        its S positions (the aux losses are dropped, as in the reference).
        Weights are cast to the activation dtype where they
        are used, as in the reference."""
        logits, _ = transformer.forward(params, batch, self.cfg, caches=cache, decode=False)
        return logits, cache

    def decode(self, params: nn.Params, batch, cache, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Any]:
        """(B, S, V) logits of ``batch["tokens"]`` at ``positions`` (B, S),
        each layer's k/v written into ``cache`` at its index, in place."""
        logits, _ = transformer.forward(params, batch, self.cfg, caches=cache, decode=True,
                                        positions=positions)
        return logits, cache

    def make_cache(self, batch: int, max_len: int, device) -> Dict[str, Any]:
        """A zeroed cache for ``batch`` rows of ``max_len`` positions in the
        activation dtype, on ``device``."""
        return transformer.make_cache(self.cfg, batch, max_len,
                                      dtype=nn.torch_dtype(self.cfg.activation_dtype),
                                      device=torch.device(device))

    def param_count(self) -> int:
        return nn.param_count(self.defs)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``; raises for what the port does not have yet."""
    return Model(cfg, transformer.transformer_defs(cfg))
