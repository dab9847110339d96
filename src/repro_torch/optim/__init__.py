"""AdamW on plain tensor trees (the port's copy of ``repro/optim``)."""

from .adamw import (AdamWConfig, PartialUpdateError, apply_updates, global_norm,
                    init_opt_state, lr_schedule, tree_leaves, tree_map)

__all__ = ["AdamWConfig", "PartialUpdateError", "apply_updates", "global_norm",
           "init_opt_state", "lr_schedule", "tree_leaves", "tree_map"]
