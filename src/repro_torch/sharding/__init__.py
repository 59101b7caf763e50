"""FSDP over a mesh's ``data`` axis and tensor parallelism over its
``model`` axis (port of ``repro.sharding``): specs, the ambient context,
placement and the collectives GSPMD inserts in the reference."""
from repro_torch.sharding.axes import (
    batch_axes,
    default_act_rules,
    default_param_rules,
    dp_size,
    resolve_spec,
    specs_for,
)
from repro_torch.sharding.context import (
    Layout,
    ShardCtx,
    current,
    leaf_layout,
    model_parallel,
    shard_act,
    use_sharding,
)
from repro_torch.sharding.placement import (
    BATCH_AXES,
    batch_rows,
    gather_tree,
    leaf_dims,
    opt_state_shardings,
    per_device_state_bytes,
    rank_rows,
    shard_tree,
    train_state_shardings,
)

__all__ = [
    "BATCH_AXES",
    "Layout",
    "ShardCtx",
    "batch_axes",
    "batch_rows",
    "current",
    "default_act_rules",
    "default_param_rules",
    "dp_size",
    "gather_tree",
    "leaf_dims",
    "leaf_layout",
    "model_parallel",
    "opt_state_shardings",
    "per_device_state_bytes",
    "rank_rows",
    "resolve_spec",
    "shard_act",
    "shard_tree",
    "specs_for",
    "train_state_shardings",
    "use_sharding",
]
