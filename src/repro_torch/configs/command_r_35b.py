"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; no biases, tied embeddings.  [hf:CohereForAI/c4ai-command-r-v01]

A copy of ``repro.configs.command_r_35b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    tie_embeddings=True,
    act_fn="silu",
    norm_type="layernorm",
    use_qkv_bias=False,
    rope_theta=8_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="command-r-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512,
    )
