"""Model API over the ported families (port of ``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` with the parameter
definitions, ``init``/``apply`` and the optimizer metadata (weight-decay
mask, trust-ratio mask, stacked-layer axes), all keyed by the JAX paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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

    def layer_axes(self) -> Dict[str, int]:
        axes = nn.layer_axis_tree(self.defs)
        if self.cfg.lamb_granularity == "leaf":
            return {k: -1 for k in axes}
        return axes

    def apply(self, params: nn.Params, batch) -> torch.Tensor:
        """Train/encoder forward: (B, S, V) logits in the activation dtype."""
        return transformer.forward(params, batch, self.cfg)

    def param_count(self) -> int:
        return nn.param_count(self.defs)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``; raises for what the port does not have yet."""
    if cfg.use_flash_kernel:
        raise NotImplementedError(
            "flash attention (kernels K3–K5) is not ported yet (ROADMAP.md "
            "queue 2); turn it off with use_flash_kernel=False / --no-flash"
        )
    if cfg.use_fused_ce_head:
        raise NotImplementedError(
            "the fused CE head (kernels K6–K8) is not ported yet (ROADMAP.md "
            "queue 2); turn it off with use_fused_ce_head=False / --no-fused-ce"
        )
    return Model(cfg, transformer.transformer_defs(cfg))
