"""Parameter partition specs, derived from the parameter tree's paths,
ported from ``repro/sharding/specs.py``.

Every leaf's logical axes are computed from its path (its dict keys) and
rank, and a rule set maps logical names onto mesh axes.  Nothing about
layout is stored: given (config, mesh shape, rules) every placement is
recomputable.  A spec is a plain tuple with one entry per dim: ``None``
(replicated), a mesh axis name, or a tuple of names (the dim split over
their product, the first name major).

Param logical-axis vocabulary:
  embed_p — model width dim of params      -> FSDP axis ("data")
  vocab   — vocabulary dim                 -> tensor axis ("model")
  heads   — attention heads                -> tensor axis
  ff      — MLP hidden / mLSTM inner dim   -> tensor axis
  expert  — MoE expert dim                 -> tensor axis (EP)
  rnn     — RG-LRU recurrence width        -> tensor axis
"""

from __future__ import annotations

from typing import Mapping

PARAM_RULES = {
    "embed_p": "data",
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "expert": "model",
    "rnn": "model",
}


def _leaf_axes(names: list, rank: int) -> tuple:
    """Logical axes for a parameter leaf, by name + context + rank."""
    name = names[-1]
    ctx = set(names)

    def r(*axes):
        assert len(axes) == rank, (names, rank, axes)
        return tuple(axes)

    if name == "table":
        return r("vocab", "embed_p")
    if name == "w" and "frontend" in ctx:
        return r(None, "embed_p")
    if name == "w" and "head" in ctx:
        return r("embed_p", "vocab")
    if name in ("scale",):
        return r(None)
    if "slstm" in ctx:
        if name in ("w_z", "w_i", "w_f", "w_o"):
            return r("embed_p", None)
        if name.startswith("r_"):
            return r("heads", None, None)
        if name == "w_o_proj":
            return r("embed_p", None)
        if name.startswith("b_"):
            return r(None)
        # fall through for the inner ffn (w_gate/w_up/w_down)
    if "rglru" in ctx:
        if name in ("w_x", "w_g"):
            return r("embed_p", "rnn")
        if name == "conv_w":
            return r(None, "rnn")
        if name in ("conv_b", "b_a", "b_i", "lam"):
            return r("rnn")
        if name in ("w_a", "w_i"):
            return r(None, "rnn")
        if name == "w_o":
            return r("rnn", "embed_p")
    if "mlstm" in ctx:
        if name == "w_up":
            return r("embed_p", "ff")
        if name == "conv_w":
            return r(None, "ff")
        if name == "conv_b":
            return r("ff")
        if name in ("wq", "wk", "wv"):
            return r("ff", "heads", None)
        if name in ("w_i", "w_f"):
            return r("ff", None)
        if name in ("b_i", "b_f"):
            return r(None)
        if name == "w_down":
            return r("ff", "embed_p")
    if name in ("wq", "wk", "wv"):
        return r("embed_p", "heads", None)
    if name == "wo":
        return r("heads", None, "embed_p")
    if name in ("bq", "bk", "bv"):
        return r("heads", None)
    if name == "router":
        return r("embed_p", "expert")
    if name == "shared_gate":
        return r("embed_p", None)
    if name in ("w_gate", "w_up"):
        return r("expert", "embed_p", None) if rank == 3 else r("embed_p", "ff")
    if name == "w_down":
        return r("expert", None, "embed_p") if rank == 3 else r("ff", "embed_p")
    if name == "conv_w":
        return r(None, "ff")
    if name in ("conv_b", "lam"):
        return r("ff")
    # biases / scalars: replicated
    return tuple(None for _ in range(rank))


def _map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` on every leaf of a nested dict/list tree, where
    ``names`` are the dict keys on the leaf's path (list indices skipped)."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(list(names), tree)


def _axes_of(names: list, leaf) -> tuple:
    # "main" segment params carry a leading stacked-group dim
    is_main = bool(names) and names[0] == "main"
    axes = _leaf_axes(names, len(leaf.shape) - (1 if is_main else 0))
    return ((None,) + axes) if is_main else axes


def param_logical_axes(params):
    """Tree (matching params) of logical-axis tuples.  Leaves need only a
    ``shape``."""
    return _map_with_names(_axes_of, params)


def logical_to_spec(axes: tuple, rules: dict) -> tuple:
    return tuple(rules.get(a) if a is not None else None for a in axes)


def spec_axes(part) -> tuple:
    """The mesh axes one spec entry names, major first."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def fit_spec(spec: tuple, shape: tuple, sizes: Mapping[str, int]) -> tuple:
    """Drop sharding on dims the mesh axes don't divide (e.g. MQA kv=1 over a
    16-way tensor axis -> replicate that dim).  ``sizes`` maps each mesh
    axis name to its size."""
    parts = []
    for i, p in enumerate(tuple(spec)[: len(shape)]):
        size = 1
        for a in spec_axes(p):
            size *= sizes[a]
        parts.append(p if p is not None and shape[i] % size == 0 else None)
    return tuple(parts)


def mesh_sizes(mesh) -> Mapping[str, int]:
    """Axis name -> size, of a mesh (its ``shape``) or of a mapping."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def map_specs(fn, params, mesh, rules: dict = PARAM_RULES):
    """A tree like ``params`` (leaves need only a ``shape``) holding
    ``fn(names, spec)`` for every leaf: its path's dict keys and the spec
    ``param_specs`` gives it."""
    sizes = mesh_sizes(mesh)
    return _map_with_names(
        lambda names, leaf: fn(names, fit_spec(
            logical_to_spec(_axes_of(names, leaf), rules), tuple(leaf.shape), sizes)),
        params)


def tensor_parallel(names: list) -> bool:
    """Whether the model computes on a leaf's local block where its
    ``heads``, ``ff``, ``vocab`` or ``expert`` dim is split over the tensor
    axis (``sharding.ctx.model_group``): dense attention, dense MLPs, the
    embedding table and the head, the routed experts (expert-parallel) and
    the shared experts (column- and row-parallel).  The MoE's router and
    qwen2's shared gate, and the RG-LRU, mLSTM and sLSTM widths, are
    gathered whole for compute."""
    return ("attn" in names or "mlp" in names
            or ("moe" in names and names[-1] not in ("router", "shared_gate"))
            or names[-2:] in (["embed", "table"], ["head", "w"]))


def param_specs(params, mesh, rules: dict = PARAM_RULES):
    """Tree of spec tuples for a parameter tree (leaves need only a
    ``shape``), on a mesh or a mapping of axis sizes."""
    return map_specs(lambda _names, spec: spec, params, mesh, rules)
