"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-style port of the GPT-BigCode code model
(absolute positions → RoPE, as in the JAX package).  [arXiv:2405.04324]

A copy of ``repro.configs.granite_20b``: qkv biases, a vanilla GELU MLP,
LayerNorm and an untied output head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act_fn="gelu",
    gated_mlp=False,
    norm_type="layernorm",
    use_qkv_bias=True,
    use_rope=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="granite-20b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
        d_ff=512, vocab_size=512,
    )
