from repro_torch.kernels.lamb_update import (
    LAUNCHES,
    LambOut,
    lamb_apply,
    lamb_moments,
    lamb_update,
    reset_launches,
    resolve_fused_backend,
)
from repro_torch.kernels.ops import (
    FusedLambState,
    fused_lamb_apply,
    fused_lamb_init,
    make_fused_lamb_step,
)

__all__ = [
    "LAUNCHES",
    "FusedLambState",
    "LambOut",
    "fused_lamb_apply",
    "fused_lamb_init",
    "lamb_apply",
    "lamb_moments",
    "lamb_update",
    "make_fused_lamb_step",
    "reset_launches",
    "resolve_fused_backend",
]
