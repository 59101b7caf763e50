from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.kernels.lamb_update import (
    LambOut,
    lamb_apply,
    lamb_moments,
    lamb_update,
    resolve_fused_backend,
)
from repro_torch.kernels.launches import COPIES, LAUNCHES, VARIANT_LAUNCHES, reset_launches
from repro_torch.kernels.ops import (
    FusedLambState,
    flash_sdpa,
    fused_lamb,
    fused_lamb_apply,
    fused_lamb_init,
    make_fused_lamb_step,
)

__all__ = [
    "COPIES",
    "LAUNCHES",
    "FusedLambState",
    "LambOut",
    "flash_sdpa",
    "fused_ce",
    "fused_lamb",
    "fused_lamb_apply",
    "fused_lamb_init",
    "lamb_apply",
    "lamb_moments",
    "lamb_update",
    "make_fused_lamb_step",
    "reset_launches",
    "resolve_fused_backend",
    "VARIANT_LAUNCHES",
]
