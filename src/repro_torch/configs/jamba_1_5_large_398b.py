"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2; Mamba:attention 7:1 interleave, MoE every
other layer.  [arXiv:2403.19887]

A copy of ``repro.configs.jamba_1_5_large_398b`` (``models/hybrid.py``);
one H100 holds its Mamba layer at full width, not the model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    n_experts_per_tok=2,
    moe_d_ff=24576,
    attn_period=8,           # 1 attention layer per 8 (1:7)
    moe_period_in_block=2,   # MoE every other layer
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    use_rope=False,          # Jamba attention is NoPE
    act_fn="silu",
    norm_type="rmsnorm",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-smoke", n_layers=4, attn_period=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, n_experts=4, n_experts_per_tok=2,
        moe_d_ff=256,
    )
