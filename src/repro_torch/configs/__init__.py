"""Config registry of the port: ``get_config("granite-moe-1b-a400m")``.

Ported: bert-large, smollm-360m, and the transformer zoo's command-r-35b,
mistral-nemo-12b, granite-20b, paligemma-3b, hubert-xlarge and
granite-moe-1b-a400m.  deepseek-v3-671b, jamba-1.5-large-398b and
xlstm-350m raise (ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

from repro_torch.configs import (
    bert_large,
    command_r_35b,
    granite_20b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    mistral_nemo_12b,
    paligemma_3b,
    smollm_360m,
)
from repro_torch.configs.base import ModelConfig, TrainConfig

_ARCHS = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "paligemma-3b": paligemma_3b,
    "granite-20b": granite_20b,
    "hubert-xlarge": hubert_xlarge,
    "mistral-nemo-12b": mistral_nemo_12b,
    "command-r-35b": command_r_35b,
    "smollm-360m": smollm_360m,
    "bert-large": bert_large,
}


def _module(name: str):
    if name not in _ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP.md queue 1, "
            f"item 10); ported: {sorted(_ARCHS)}"
        )
    return _ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ModelConfig", "TrainConfig", "get_config", "smoke_config"]
