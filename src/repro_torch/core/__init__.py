from repro_torch.core.schedules import (
    linear_epoch_warmup_ratio,
    polynomial_decay,
    sqrt_scaled_lr,
    warmup_poly_decay,
)

__all__ = [
    "linear_epoch_warmup_ratio",
    "polynomial_decay",
    "sqrt_scaled_lr",
    "warmup_poly_decay",
]
