"""Logical-axis sharding context, ported from ``repro/sharding/ctx.py``.

Model code may annotate activations with *logical* axis names through
``shard(x, axes)``; the train step binds logical names to mesh axes with
``use_rules``.  Where the reference lets XLA lay activations out by those
names, the port's model code computes on what each rank holds, so
``shard`` is the identity and the binding carries what that code reads:

- ``loss_group``: the ranks that share one loss (its rows split over the
  batch axes), whose terms the reference takes over the global batch (the
  cross-entropy's token count, the MoE load-balance fractions);
- ``model_group``: the tensor-parallel group, the mesh axis that the rules
  map ``heads``, ``ff`` and ``vocab`` to.  Dense attention (heads), dense
  MLPs (ff), the embedding and the head (vocab), the routed experts
  (expert), the shared experts and the sLSTM's FFN (ff), the RG-LRU's
  channels (rnn) and the mLSTM's inner width (ff) run on the local leaves
  of that axis where the partition splits them (``models.lm``,
  ``models.layers``, ``models.moe``, ``models.recurrent``):
  column-parallel products in, row-parallel out (each rank's own experts,
  its partial combine), summed over the group in rank order.  The sLSTM's
  gates and cell run whole on every rank of the group, as the reference's
  partition leaves them.  The serving steps bind the same: the rows of a
  prefill or decode batch split over ``data_axes_for`` (the loss group's
  axes, which an MoE's load-balance terms read), heads, ff, rnn and vocab
  over ``model``, and a decode cache placed as the reference's
  ``cache_specs`` (``sharding.specs``): an attention layer's KV heads over
  ``model``, or else its positions, whose partial outputs the ranks merge
  (``models.layers.seq_split_decode_attention``), and the recurrent
  states' heads or channels over ``model``.  ``cache_seq`` naming the
  model axis (``shard_cache_seq``) puts every attention cache's positions
  on it where it divides them (``cache_seq_split``);
- ``stream_group``: under sequence parallelism (``seq`` naming the model
  axis), the model group over whose ranks a full-sequence forward holds
  the residual stream by blocks of positions (``split_stream``, which
  ``models.lm`` enters where the group divides the stream's length):
  norms and residual adds run on the rank's positions, each block's input
  is gathered over the sequence and its row-parallel sum scattered back
  (``models.layers.block_in`` / ``block_out``).

Outside a binding (unit tests, one device) nothing changes.

Rule sets are plain dicts: logical name -> mesh axis (str), tuple of mesh
axes, or None.  Unknown names map to None (replicated).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Optional

_state = threading.local()


TP_NAMES = ("heads", "ff", "vocab")


@dataclass(frozen=True)
class Binding:
    mesh: object  # a ``repro_torch.launch.mesh.Mesh``
    rules: dict
    batch_axes: tuple  # the mesh axes whose ranks' rows make up one loss
    model_axis: Optional[str]  # the tensor-parallel axis, or None
    stream: bool = False  # the residual stream split over the sequence


def current() -> Optional[Binding]:
    return getattr(_state, "binding", None)


def _rule_batch_axes(rules: dict, mesh) -> tuple:
    """The axes ``rules["batch"]`` names that the mesh has."""
    batch = rules.get("batch") or ()
    batch = batch if isinstance(batch, tuple) else (batch,)
    return tuple(a for a in batch if a in mesh.axis_names)


def tensor_axis(rules: dict, mesh, batch_axes: Optional[tuple] = None) -> Optional[str]:
    """The tensor-parallel axis that ``use_rules(mesh, rules, batch_axes)``
    binds: the mesh axis that ``rules`` map ``heads``, ``ff`` and ``vocab``
    to, where they all name one axis of more than one rank that splits no
    batch (neither ``batch_axes`` nor ``rules["batch"]``); else None."""
    names = {rules.get(k) for k in TP_NAMES}
    axis = names.pop() if len(names) == 1 else None
    batch = _rule_batch_axes(rules, mesh) + tuple(batch_axes or ())
    if (not isinstance(axis, str) or axis not in mesh.axis_names or axis in batch
            or mesh.shape[axis] == 1):
        return None
    return axis


@contextmanager
def use_rules(mesh, rules: dict, batch_axes: Optional[tuple] = None):
    """Bind ``rules`` on ``mesh`` for the calls inside.  ``batch_axes``:
    the mesh axes over which one loss's rows are split (by default the
    axes ``rules["batch"]`` names that the mesh has).  The tensor-parallel
    axis is ``tensor_axis(rules, mesh, batch_axes)``."""
    model_axis = tensor_axis(rules, mesh, batch_axes)
    if batch_axes is None:
        batch_axes = _rule_batch_axes(rules, mesh)
    prev = current()
    _state.binding = Binding(mesh, dict(rules), tuple(batch_axes), model_axis)
    try:
        yield
    finally:
        _state.binding = prev


def rebind(fn):
    """``fn`` that runs under the binding current now, on whatever thread
    calls it.  A rematerialised block's forward reruns in the backward
    pass, and on the card autograd runs that on its own device thread,
    which a thread-local binding does not reach."""
    binding = current()

    def call(*args, **kwargs):
        prev = current()
        _state.binding = binding
        try:
            return fn(*args, **kwargs)
        finally:
            _state.binding = prev

    return call


def loss_group() -> tuple:
    """(process group, rank count) of the ranks whose rows make up the
    bound loss; (None, 1) outside a binding or where one rank holds all
    of them."""
    b = current()
    if b is None:
        return None, 1
    n = b.mesh.size(b.batch_axes)
    return (b.mesh.group(b.batch_axes) if n > 1 else None), n


def loss_index() -> int:
    """This rank's index among the ranks of the bound loss's group (its
    block of the global batch's rows); 0 outside a binding."""
    b = current()
    return 0 if b is None else b.mesh.index(b.batch_axes)


@contextmanager
def whole_batch():
    """Within: the bound loss's group is this rank alone (the model axis
    stays bound), for work on the global batch's rows gathered whole."""
    b = current()
    if b is None:
        yield
        return
    _state.binding = replace(b, batch_axes=())
    try:
        yield
    finally:
        _state.binding = b


def model_group() -> tuple:
    """(process group, rank count, this rank's index) of the bound
    tensor-parallel axis; (None, 1, 0) outside a binding or without one."""
    b = current()
    if b is None or b.model_axis is None:
        return None, 1, 0
    axes = (b.model_axis,)
    return b.mesh.group(axes), b.mesh.size(axes), b.mesh.index(axes)


def _model_rule(name: str) -> bool:
    """Whether the bound rules map ``name`` to the bound tensor-parallel
    axis."""
    b = current()
    return b is not None and b.model_axis is not None and b.rules.get(name) == b.model_axis


def sequence_parallel(length: int) -> bool:
    """Whether a full-sequence forward of ``length`` positions splits its
    residual stream over the model group: the rules map ``seq`` to the
    tensor-parallel axis, whose ranks divide the length (else the stream
    stays whole, as ``fit_spec`` leaves a dim the axis does not divide)."""
    return _model_rule("seq") and length % model_group()[1] == 0


@contextmanager
def split_stream(on: bool = True):
    """Within (where ``on``): the residual stream holds this rank's block of
    the positions (``stream_group``)."""
    b = current()
    if not on or b is None:
        yield
        return
    _state.binding = replace(b, stream=True)
    try:
        yield
    finally:
        _state.binding = b


def stream_group() -> tuple:
    """(process group, rank count, this rank's index) of the model group
    over which the residual stream is split by positions (rank r holds
    [r S / n, (r + 1) S / n)); (None, 1, 0) where it is whole."""
    b = current()
    if b is None or not b.stream:
        return None, 1, 0
    return model_group()


def cache_seq_split() -> bool:
    """Whether the bound rules put an attention cache's positions on the
    model axis before its KV heads (``cache_seq``, ``shard_cache_seq``)."""
    return _model_rule("cache_seq")


def data_axes_for(mesh, global_batch: int, include_model: bool = False) -> tuple:
    """Largest prefix of (pod, data[, model]) that divides the batch: the
    axes a cell's or a serving step's rows split over."""
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    axes = [a for a in names if a in mesh.axis_names]
    size = 1
    chosen = []
    for a in axes:
        n = mesh.shape[a]
        if global_batch % (size * n) == 0:
            chosen.append(a)
            size *= n
    return tuple(chosen)


def resolve(axes: tuple, rules: dict) -> tuple:
    return tuple(None if a is None else rules.get(a) for a in axes)


def shard(x, axes: tuple):
    """The identity: the port's model code computes on each rank's own
    rows and local leaves, so a logical layout has nothing to constrain
    (``axes`` is documentation)."""
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
