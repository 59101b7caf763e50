from repro_torch.core.lamb import lamb
from repro_torch.core.lans import lans, normalize_grads, scale_by_lans
from repro_torch.core.lars import lars
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
from repro_torch.core.nlamb import nlamb, nnlamb
from repro_torch.core.trust_ratio import (
    summarize_trust_ratios,
    trust_ratio_tree,
    trust_records,
)
# after the submodule of the same name, so ``core.trust_ratio`` is the function
from repro_torch.core.strategy import (
    layerwise_adapt,
    layerwise_adaptation,
    phi_clip,
    trust_ratio,
)

__all__ = [
    "Stage",
    "adam_correction_equivalent_lr",
    "bert_mixed_batch_plan",
    "constant",
    "goyal_step_schedule",
    "lamb",
    "lans",
    "lars",
    "layerwise_adapt",
    "layerwise_adaptation",
    "linear_epoch_warmup_ratio",
    "linear_warmup",
    "make_stage",
    "nlamb",
    "nnlamb",
    "normalize_grads",
    "phi_clip",
    "piecewise_stage_schedule",
    "polynomial_decay",
    "scale_by_lans",
    "scaled_plan",
    "sqrt_scaled_lr",
    "summarize_trust_ratios",
    "trust_ratio",
    "trust_ratio_tree",
    "trust_records",
    "untuned_lamb_schedule",
    "warmup_poly_decay",
]
