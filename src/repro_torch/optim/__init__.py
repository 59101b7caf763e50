from repro_torch.optim.base import clip_tree_by_global_norm, global_norm

__all__ = ["clip_tree_by_global_norm", "global_norm"]
