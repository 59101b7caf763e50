"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA, expert_ff=2048
vocab=129280; 1 shared + 256 routed experts top-8, 3 leading dense layers
(d_ff=18432), optional MTP head.  [arXiv:2412.19437]

A copy of ``repro.configs.deepseek_v3_671b``: MLA attention
(``models/layers/mla.py``), a dense prefix of ``n_dense_layers`` blocks
before the MoE blocks, and the MTP head when ``use_mtp`` (see
``models/transformer.py``); untied head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,       # MLA: all heads share the latent KV cache
    d_ff=18432,           # the 3 leading dense layers
    vocab_size=129280,
    n_dense_layers=3,
    n_experts=256,
    n_experts_per_tok=8,
    n_shared_experts=1,
    moe_d_ff=2048,        # assigned d_ff=2048 is the per-expert width
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=192,         # qk_nope + qk_rope
    use_mtp=False,        # enabled in the MTP smoke test / ablation
    act_fn="silu",
    norm_type="rmsnorm",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v3-smoke", n_layers=3, n_dense_layers=1, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512, n_experts=4,
        n_experts_per_tok=2, moe_d_ff=64, q_lora_rank=64, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=24,
    )
