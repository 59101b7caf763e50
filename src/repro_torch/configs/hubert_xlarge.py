"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
(cluster codebook); encoder-only, masked frame-cluster prediction.  The conv
waveform frontend is stubbed: inputs are precomputed frame embeddings.
[arXiv:2106.07447]

A copy of ``repro.configs.hubert_xlarge``: the ``audio_stub`` frontend with
a learned ``mask_embed``, the masked-prediction loss, no serving path.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,            # encoder-only: no decode shapes
    frontend="audio_stub",
    mask_ratio=0.08,
    act_fn="gelu",
    gated_mlp=False,
    norm_type="layernorm",
    use_rope=False,          # conv positional embedding is part of the stub
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="hubert-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=64,
    )
