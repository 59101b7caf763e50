from repro_torch.core.mixed_batch import (
    Stage,
    bert_mixed_batch_plan,
    make_stage,
    scaled_plan,
)
from repro_torch.core.schedules import (
    adam_correction_equivalent_lr,
    constant,
    goyal_step_schedule,
    linear_epoch_warmup_ratio,
    linear_warmup,
    piecewise_stage_schedule,
    polynomial_decay,
    sqrt_scaled_lr,
    untuned_lamb_schedule,
    warmup_poly_decay,
)

__all__ = [
    "Stage",
    "adam_correction_equivalent_lr",
    "bert_mixed_batch_plan",
    "constant",
    "goyal_step_schedule",
    "linear_epoch_warmup_ratio",
    "linear_warmup",
    "make_stage",
    "piecewise_stage_schedule",
    "polynomial_decay",
    "scaled_plan",
    "sqrt_scaled_lr",
    "untuned_lamb_schedule",
    "warmup_poly_decay",
]
