"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) expert_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]

A copy of ``repro.configs.granite_moe_1b_a400m``: every block's MLP is the
MoE layer (``models/layers/moe.py``), tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,            # unused (all layers MoE); kept to mirror the card
    vocab_size=49155,
    n_experts=32,
    n_experts_per_tok=8,
    moe_d_ff=512,
    tie_embeddings=True,
    act_fn="silu",
    norm_type="rmsnorm",
    use_rope=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        vocab_size=512, n_experts=4, n_experts_per_tok=2, moe_d_ff=64, d_ff=64,
    )
