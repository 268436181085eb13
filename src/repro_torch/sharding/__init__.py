"""Sharding of the port's training over a mesh of ranks, ported from
``repro/sharding``: parameter partition specs and the logical-axis
binding."""

from .ctx import activation_rules, shard, use_rules
from .specs import logical_to_spec, param_logical_axes, param_specs

__all__ = [
    "activation_rules",
    "logical_to_spec",
    "param_logical_axes",
    "param_specs",
    "shard",
    "use_rules",
]
