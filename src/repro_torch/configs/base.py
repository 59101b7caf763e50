"""Model / training configuration dataclasses.

A field-for-field copy of ``repro.configs.base`` (the JAX package's), kept
here so the PyTorch port imports nothing of the JAX package.  One
``ModelConfig`` describes any architecture of the zoo; the port runs the
dense bert-large family only and raises on the rest (see
``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // n_heads

    # --- attention ---
    use_rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True            # False → encoder (hubert)
    sliding_window: Optional[int] = None
    use_qkv_bias: bool = False
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    act_fn: str = "silu"           # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1      # every k-th layer is MoE (1 = all)
    n_dense_layers: int = 0        # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 0.0

    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorb: bool = False       # beyond-paper decode optimization (§Perf)

    # --- hybrid / mamba (Jamba) ---
    mamba_chunk: Optional[int] = None  # chunked SSM scan (bounds temp memory)
    attn_period: int = 0           # 1 attention layer per `attn_period` layers
    moe_period_in_block: int = 2   # within a hybrid block, MoE every k layers
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: Optional[int] = None  # default ceil(d_model/16)

    # --- xLSTM ---
    slstm_ratio: int = 2           # 1 sLSTM per `slstm_ratio` layers (rest mLSTM)
    xlstm_proj_factor: float = 2.0

    # --- modality frontends (stubbed per assignment) ---
    n_prefix_tokens: int = 0       # image patches (vlm) / audio frames use seq directly
    frontend: str = "none"         # none | vision_stub | audio_stub
    mask_ratio: float = 0.0        # hubert masked-prediction ratio

    # --- MTP (DeepSeek-V3) ---
    use_mtp: bool = False
    mtp_loss_coef: float = 0.3

    # --- numerics / compile ---
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "none"            # none | full
    use_flash_kernel: bool = False # route attention through the Pallas kernel
    use_fused_lamb_kernel: bool = False
    use_fused_ce_head: bool = False  # fused MLM head: supervised-position
                                     # gather + chunked-vocab CE (no logits)
    fused_ce_backend: str = "auto"   # auto | pallas | xla | interpret
    mlm_max_predictions: Optional[int] = None  # fused-head gather buffer P;
                                     # default ceil(mask_ratio * seq_len)

    # --- optimizer interaction ---
    lamb_granularity: str = "slice"  # slice (per stacked layer) | leaf

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA group mismatch"

    def mlm_buffer_size(self, seq_len: int) -> int:
        """The fused-CE head's gather-buffer size P for this sequence length.

        ``mlm_max_predictions`` when set; otherwise ``ceil(mask_ratio · S)``
        (BERT's ``max_predictions_per_seq``), or S for unmasked objectives.
        This is the single source of truth for P: the loss sizes its gather
        buffer from it AND the synthetic MLM pipeline caps per-row target
        counts at it, so the two can never disagree.
        """
        if self.mlm_max_predictions is not None:
            return max(1, min(self.mlm_max_predictions, seq_len))
        if self.mask_ratio > 0:
            return max(1, min(seq_len, math.ceil(self.mask_ratio * seq_len)))
        return seq_len

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "lamb"        # lamb | lans | lars | nlamb | nnlamb | adam | adamw | adagrad | momentum
    learning_rate: float = 1e-3
    total_steps: int = 100
    warmup_ratio: float = 1.0 / 320.0
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    phi_bounds: Optional[Tuple[float, float]] = None
    grad_clip_norm: Optional[float] = 1.0
    bias_correction: bool = True
    moment_dtype: Optional[str] = None  # e.g. "bfloat16" — halves m/v state
    # --- large-batch scaling knobs (global_batch = microbatch × accum × DP) ---
    accum_steps: int = 1           # gradient-accumulation microbatches per step
    microbatch: Optional[int] = None  # legacy alias for accum_steps (slices)
    precision: str = "fp32"        # fp32 | bf16 (bf16 compute, fp32 masters)
    use_fused_lamb: bool = False   # Pallas/XLA fused LAMB update in the step
    fused_backend: str = "auto"    # auto | pallas | xla | interpret
    seed: int = 0
    # in-jit non-finite guard: one fused all-finite reduction over loss +
    # grads; a non-finite step passes the whole TrainState through unchanged
    # (schedule counters included) and bumps the persisted `skipped` counter
    skip_nonfinite: bool = False
    log_trust_ratios: bool = False
    # per-layer trust-ratio/norm recording: the step returns, under
    # metrics["telemetry/per_layer"], pytrees of per-layer-slice vectors
    # (trust_ratio threaded out of the fused-LAMB kernels as an aux output)
    # — jit-compatible, no host sync until the Trainer's log-step fetch
    record_trust_ratios: bool = False

    @property
    def grad_accum_steps(self) -> int:
        """Effective number of accumulation microbatches (≥ 1).

        ``accum_steps`` is canonical; the legacy ``microbatch`` slice count is
        honored when it asks for more slices.
        """
        return max(self.accum_steps, self.microbatch or 1, 1)

    @property
    def compute_dtype(self) -> Optional[str]:
        """Forward/backward compute dtype implied by ``precision`` (None = native)."""
        if self.precision in ("bf16", "bfloat16"):
            return "bfloat16"
        if self.precision in ("fp32", "float32"):
            return None
        raise ValueError(f"unknown precision {self.precision!r}")
