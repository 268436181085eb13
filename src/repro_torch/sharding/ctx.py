"""Logical-axis sharding context, ported from ``repro/sharding/ctx.py``.

Model code may annotate activations with *logical* axis names through
``shard(x, axes)``; the train step binds logical names to mesh axes with
``use_rules``.  The port's tensors are rank-local (each rank computes on
its own rows with whole parameters), so there is no layout constraint to
apply and ``shard`` is the identity.  What the binding does carry is the
mesh's process groups: the loss terms that the reference takes over the
global batch (the cross-entropy's token count, the MoE load-balance
fractions) read the group of ranks that share one loss through
``loss_group``.  Outside a binding (unit tests, one device) nothing
changes.

Rule sets are plain dicts: logical name -> mesh axis (str), tuple of mesh
axes, or None.  Unknown names map to None (replicated).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

_state = threading.local()


@dataclass(frozen=True)
class Binding:
    mesh: object  # a ``repro_torch.launch.mesh.Mesh``
    rules: dict
    batch_axes: tuple  # the mesh axes whose ranks' rows make up one loss


def current() -> Optional[Binding]:
    return getattr(_state, "binding", None)


@contextmanager
def use_rules(mesh, rules: dict, batch_axes: Optional[tuple] = None):
    """Bind ``rules`` on ``mesh`` for the calls inside.  ``batch_axes``:
    the mesh axes over which one loss's rows are split (by default the
    axes ``rules["batch"]`` names that the mesh has)."""
    if batch_axes is None:
        batch = rules.get("batch") or ()
        batch = batch if isinstance(batch, tuple) else (batch,)
        batch_axes = tuple(a for a in batch if a in mesh.axis_names)
    prev = current()
    _state.binding = Binding(mesh, dict(rules), tuple(batch_axes))
    try:
        yield
    finally:
        _state.binding = prev


def loss_group() -> tuple:
    """(process group, rank count) of the ranks whose rows make up the
    bound loss; (None, 1) outside a binding or where one rank holds all
    of them."""
    b = current()
    if b is None:
        return None, 1
    n = b.mesh.size(b.batch_axes)
    return (b.mesh.group(b.batch_axes) if n > 1 else None), n


def resolve(axes: tuple, rules: dict) -> tuple:
    return tuple(None if a is None else rules.get(a) for a in axes)


def shard(x, axes: tuple):
    """The identity: the port's tensors are rank-local, so a logical
    layout has nothing to constrain (``axes`` is documentation)."""
    return x


# ---------------------------------------------------------------- rule sets


def activation_rules(
    *,
    data_axes: tuple = ("pod", "data"),
    model_axis: str = "model",
    sequence_parallel: bool = False,
    shard_cache_seq: bool = False,
) -> dict:
    """Standard rule set for the (pod, data, model) production mesh.

    - ``batch``/``dp`` over the pure-DP axes,
    - heads / ff / vocab / experts over the tensor axis,
    - ``seq``: sharded over the tensor axis between blocks iff
      ``sequence_parallel``,
    - ``cache_seq``: KV-cache sequence axis over the tensor axis iff
      ``shard_cache_seq``.
    """
    return {
        "batch": data_axes,
        "dp": data_axes,
        "seq": model_axis if sequence_parallel else None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "ff": model_axis,
        "vocab": model_axis,
        "expert": model_axis,
        "rnn": model_axis,
        "cache_seq": model_axis if shard_cache_seq else None,
        "fsdp": "data",
        "embed": None,
    }
