"""Training on one device: AdamW with global-norm clipping and the train
step, ported from ``repro/train``."""

from .optim import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from .step import TrainConfig, init_train_state, make_train_step

__all__ = [
    "OptimizerConfig",
    "TrainConfig",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "init_train_state",
    "lr_schedule",
    "make_train_step",
]
