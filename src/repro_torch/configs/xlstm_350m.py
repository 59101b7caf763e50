"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304; alternating
sLSTM + mLSTM blocks (no separate FFN — blocks carry their own projections).
[arXiv:2405.04517]

A copy of ``repro.configs.xlstm_350m`` (``models/xlstm_model.py``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_ratio=2,          # (mLSTM, sLSTM) pairs
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
    use_rope=False,
    norm_type="layernorm",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        vocab_size=512,
    )
