"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152;
llama-architecture small model.  [hf:HuggingFaceTB/SmolLM-135M]

A copy of ``repro.configs.smollm_360m``: a causal decoder with RMSNorm, the
gated SiLU MLP and tied embeddings, the model the serving path runs.
``use_flash_kernel`` stays off as in the JAX config (prefill and decode
take the dense attention); turned on, prefill runs flash attention (K3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    act_fn="silu",
    norm_type="rmsnorm",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="smollm-smoke", n_layers=2, d_model=120, n_heads=3, n_kv_heads=1,
        d_ff=320, vocab_size=512,
    )
