"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP vision tower stubbed to 256 patch embeddings.
[arXiv:2407.07726]

A copy of ``repro.configs.paligemma_3b``: the ``vision_stub`` frontend
prepends ``image_embeds`` to the token embeddings; head dim 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,        # gemma-2b uses 256-dim heads
    d_ff=16384,
    vocab_size=257216,
    frontend="vision_stub",
    n_prefix_tokens=256,  # 224px / 14 SigLIP patches
    tie_embeddings=True,
    act_fn="gelu",
    norm_type="rmsnorm",
    use_rope=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="paligemma-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512, n_prefix_tokens=4,
    )
