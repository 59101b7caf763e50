"""bert-large — the paper's own training target (Devlin et al., 2018):
24L d_model=1024 16H d_ff=4096 vocab=30522, bidirectional encoder, MLM.

A copy of ``repro.configs.bert_large``.  ``use_flash_kernel`` and
``use_fused_ce_head`` stay on as in the JAX config; both run on the port's
kernels (flash attention K3–K5, the fused CE head K6–K8).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-large",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    causal=False,          # bidirectional encoder; MLM loss
    mask_ratio=0.15,
    act_fn="gelu",
    gated_mlp=False,
    norm_type="layernorm",
    use_rope=True,
    tie_embeddings=True,
    use_flash_kernel=True,
    use_fused_ce_head=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="bert-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
    )


def tiny(vocab: int = 2048) -> ModelConfig:
    """~10M-param BERT for CPU-scale runs."""
    return CONFIG.replace(
        name="bert-tiny", n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=1024, vocab_size=vocab,
    )
