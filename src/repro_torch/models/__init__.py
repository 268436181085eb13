from .lm import (
    ModelOptions,
    decode_step,
    forward,
    forward_with_cache,
    init_cache,
    init_params,
    loss_fn,
    stack_plan,
)

__all__ = ["ModelOptions", "decode_step", "forward", "forward_with_cache",
           "init_cache", "init_params", "loss_fn", "stack_plan"]
