from .lm import ModelOptions, init_params, stack_plan

__all__ = ["ModelOptions", "init_params", "stack_plan"]
