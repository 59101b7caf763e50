from repro_torch.nn.bridge import (
    params_from_jax,
    state_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.nn.module import (
    LAYERS_AXIS,
    Param,
    Params,
    cast_tree,
    flatten,
    init_params,
    layer_axis_tree,
    param_count,
    stack,
    torch_dtype,
    trust_ratio_mask,
    weight_decay_mask,
)

__all__ = [
    "LAYERS_AXIS",
    "Param",
    "Params",
    "cast_tree",
    "flatten",
    "init_params",
    "layer_axis_tree",
    "param_count",
    "params_from_jax",
    "stack",
    "state_from_jax",
    "torch_dtype",
    "train_state_from_jax",
    "train_state_to_numpy",
    "trust_ratio_mask",
    "weight_decay_mask",
]
