"""Config registry of the port: ``get_config("granite-moe-1b-a400m")``.

Every arch of the JAX package's registry: bert-large, smollm-360m, the
transformer zoo's command-r-35b, mistral-nemo-12b, granite-20b,
paligemma-3b, hubert-xlarge, granite-moe-1b-a400m and deepseek-v3-671b
(MLA, a dense prefix, MTP), and the recurrent families'
jamba-1.5-large-398b (hybrid) and xlstm-350m (ssm).  Any other name raises
``KeyError``, as in the reference.  The (architecture × input shape) plan
the dry-run walks (:func:`plan`, :func:`full_plan`) is the reference's,
notes word for word.
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
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.configs.shapes import SHAPES, get_shape

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


# the reference's dry-run archs, in its order: every arch but bert-large
ARCHS: List[str] = [
    "granite-moe-1b-a400m", "paligemma-3b", "granite-20b", "jamba-1.5-large-398b",
    "hubert-xlarge", "mistral-nemo-12b", "deepseek-v3-671b", "command-r-35b",
    "xlstm-350m", "smollm-360m",
]


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


# ---------------------------------------------------------------------------
# (arch × shape) plan
# ---------------------------------------------------------------------------

SWA_WINDOW_500K = 4096  # sliding-window variant used by dense archs on long_500k


def plan(cfg: ModelConfig, shape: InputShape) -> Tuple[Optional[ModelConfig], str]:
    """Returns (possibly-modified config, note).  config=None ⇒ skipped.

    Skips, as in the reference:
      * encoder-only archs have no decode step → decode shapes skipped;
      * full-attention archs run long_500k only via the sliding-window
        variant (cfg.sliding_window := 4096).
    """
    if shape.kind == "decode" and cfg.is_encoder:
        return None, "skip: encoder-only (no decode step)"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.use_mla
        if not sub_quadratic and cfg.sliding_window is None:
            return (
                cfg.replace(sliding_window=SWA_WINDOW_500K),
                f"variant: sliding_window={SWA_WINDOW_500K} (full attention is "
                "not sub-quadratic; SWA variant per DESIGN.md)",
            )
    if shape.kind == "prefill" and cfg.is_encoder:
        return cfg, "encoder forward (no cache) stands in for prefill"
    return cfg, "ok"


def full_plan() -> Dict[Tuple[str, str], Tuple[Optional[ModelConfig], str]]:
    """:func:`plan` of every arch of :data:`ARCHS` at every shape."""
    out = {}
    for arch in ARCHS:
        for sname, shape in SHAPES.items():
            out[(arch, sname)] = plan(get_config(arch), shape)
    return out


__all__ = [
    "ARCHS",
    "InputShape",
    "ModelConfig",
    "SHAPES",
    "SWA_WINDOW_500K",
    "TrainConfig",
    "full_plan",
    "get_config",
    "get_shape",
    "plan",
    "smoke_config",
]
