"""Config registry of the port: ``get_config("granite-moe-1b-a400m")``.

Every arch of the JAX package's registry: bert-large, smollm-360m, the
transformer zoo's command-r-35b, mistral-nemo-12b, granite-20b,
paligemma-3b, hubert-xlarge, granite-moe-1b-a400m and deepseek-v3-671b
(MLA, a dense prefix, MTP), and the recurrent families'
jamba-1.5-large-398b (hybrid) and xlstm-350m (ssm).  Any other name raises
``KeyError``, as in the reference.
"""
from __future__ import annotations

from repro_torch.configs import (
    bert_large,
    command_r_35b,
    deepseek_v3_671b,
    granite_20b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    jamba_1_5_large_398b,
    mistral_nemo_12b,
    paligemma_3b,
    smollm_360m,
    xlstm_350m,
)
from repro_torch.configs.base import ModelConfig, TrainConfig

_ARCHS = {
    "deepseek-v3-671b": deepseek_v3_671b,
    "xlstm-350m": xlstm_350m,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
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
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ModelConfig", "TrainConfig", "get_config", "smoke_config"]
