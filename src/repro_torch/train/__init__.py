"""Training: AdamW with global-norm clipping, the train step on one
device or a mesh of ranks, and int8 error-feedback gradient compression,
ported from ``repro/train``."""

from .optim import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from .step import (
    TrainConfig,
    abstract_train_state,
    batch_sharding,
    init_train_state,
    make_train_step,
    train_state_specs,
)

__all__ = [
    "OptimizerConfig",
    "TrainConfig",
    "abstract_train_state",
    "adamw_update",
    "batch_sharding",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "init_train_state",
    "lr_schedule",
    "make_train_step",
    "train_state_specs",
]
