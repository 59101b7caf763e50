from repro_torch.checkpoint.async_io import AsyncCheckpointer
from repro_torch.checkpoint.io import (
    checkpoint_step,
    discard_checkpoints_after,
    gc_tmp_dirs,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves_with_paths,
    write_checkpoint_dir,
)

__all__ = [
    "AsyncCheckpointer",
    "checkpoint_step",
    "discard_checkpoints_after",
    "gc_tmp_dirs",
    "latest_checkpoint",
    "restore_checkpoint",
    "save_checkpoint",
    "tree_leaves_with_paths",
    "write_checkpoint_dir",
]
