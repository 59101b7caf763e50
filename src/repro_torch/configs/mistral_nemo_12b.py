"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; 128k context (rope theta 1M), head_dim=128.
[hf:mistralai/Mistral-Nemo-Base-2407]

A copy of ``repro.configs.mistral_nemo_12b``: untied output head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    act_fn="silu",
    norm_type="rmsnorm",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="mistral-nemo-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
    )
