"""Config registry of the port: ``get_config("bert-large")``.

Only bert-large is ported; every other architecture of the JAX zoo raises
(ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

from repro_torch.configs import bert_large
from repro_torch.configs.base import ModelConfig, TrainConfig

_ARCHS = {"bert-large": bert_large}


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
