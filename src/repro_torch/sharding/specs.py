"""Parameter partition specs, derived from the parameter tree's paths,
ported from ``repro/sharding/specs.py``.

Every leaf's logical axes are computed from its path (its dict keys) and
rank, and a rule set maps logical names onto mesh axes.  Nothing about
layout is stored: given (config, mesh shape, rules) every placement is
recomputable.  A spec is a plain tuple with one entry per dim: ``None``
(replicated), a mesh axis name, or a tuple of names (the dim split over
their product, the first name major).

``cache_specs`` places a decode cache as the reference's dry-run does
(``repro/launch/cells.py``), and ``local_params`` / ``local_cache`` cut
this rank's blocks out of whole trees.

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

from ..convert import zip_params

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
    16-way tensor axis -> replicate that dim), then on a dim whose mesh axes
    an earlier dim already names: a spec names each mesh axis at most once,
    the only placement the reference's ``NamedSharding`` accepts (the
    mLSTM's ``wq (ff, heads, dk)`` splits ``ff`` over ``model``, its heads
    whole).  ``sizes`` maps each mesh axis name to its size."""
    parts, used = [], set()
    for i, p in enumerate(tuple(spec)[: len(shape)]):
        size = 1
        for a in spec_axes(p):
            size *= sizes[a]
        if p is None or shape[i] % size or used & set(spec_axes(p)):
            parts.append(None)
            continue
        parts.append(p)
        used.update(spec_axes(p))
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
    ``heads``, ``ff``, ``vocab``, ``expert`` or ``rnn`` dim is split over the
    tensor axis (``sharding.ctx.model_group``): dense attention, dense MLPs,
    the embedding table and the head, the routed experts (expert-parallel),
    the shared experts and the sLSTM's FFN (column- and row-parallel), the
    RG-LRU's channels and the mLSTM's inner width.  The MoE's router,
    qwen2's shared gate and the sLSTM's recurrent weights are gathered whole
    for compute."""
    return ("attn" in names or "mlp" in names or "rglru" in names or "mlstm" in names
            or ("slstm" in names and "ffn" in names)
            or ("moe" in names and names[-1] not in ("router", "shared_gate"))
            or names[-2:] in (["embed", "table"], ["head", "w"]))


def param_specs(params, mesh, rules: dict = PARAM_RULES):
    """Tree of spec tuples for a parameter tree (leaves need only a
    ``shape``), on a mesh or a mapping of axis sizes."""
    return map_specs(lambda _names, spec: spec, params, mesh, rules)


def mesh_rules(mesh, rules: dict = PARAM_RULES) -> dict:
    """The rules whose mesh axes ``mesh`` has, as the reference's
    compressed step filters them."""
    return {k: v for k, v in rules.items()
            if all(a in mesh.axis_names for a in spec_axes(v))}


def local_block(full, spec: tuple, mesh):
    """This rank's block of a whole leaf (a view; ``full`` itself where no
    dim is split)."""
    x = full
    for dim, part in enumerate(spec):
        axes = spec_axes(part)
        n = mesh.size(axes)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(axes) * size, size)
    return x


def own_block(full, spec: tuple, mesh):
    """``local_block`` in storage of its own (the whole leaf where it is
    one), so the whole leaf can be freed."""
    block = local_block(full, spec, mesh)
    return full if block is full else block.clone()


def local_params(params, mesh, rules: dict = PARAM_RULES):
    """This rank's shard of each leaf of a whole parameter tree, as
    ``param_specs`` partitions it (by the rules whose axes the mesh has)."""
    specs = param_specs(params, mesh, mesh_rules(mesh, rules))
    return zip_params(lambda p, s: own_block(p, s, mesh), params, specs)


# ------------------------------------------------------------- decode cache


def kv_cache_split(positions: int, kv_heads: int, n: int, cache_seq: bool = False) -> str:
    """Where an attention layer's (B, S, KV, hd) decode cache of S =
    ``positions`` splits over a model axis of n ranks, as the reference's
    ``cache_specs`` places it: ``"kv"``, its KV heads, where n divides them;
    else ``"seq"``, its positions, where n divides them (flash-decode:
    split-K over the cache sequence, so the cache is never replicated
    across the axis); else ``"whole"``.  With ``cache_seq`` (the rules map
    ``cache_seq`` to the model axis: ``shard_cache_seq``) the positions come
    first: the reference's spec then names the axis on both dims where n
    divides the KV heads too, and the later repeat is dropped
    (``fit_spec``)."""
    if n > 1 and cache_seq and positions % n == 0:
        return "seq"
    if n > 1 and kv_heads % n == 0:
        return "kv"
    if n > 1 and positions % n == 0:
        return "seq"
    return "whole"


def _batch_entry(batch_axes: tuple):
    """A spec entry for the rows: None, one axis, or a tuple of axes."""
    batch_axes = tuple(batch_axes)
    if not batch_axes:
        return None
    return batch_axes[0] if len(batch_axes) == 1 else batch_axes


def cache_specs(cache, cfg, mesh, batch_axes: tuple, rules: dict) -> dict:
    """Spec tuples for a whole decode cache (leaves need only a ``shape``)
    on a mesh or a mapping of axis sizes, ported from the reference's
    ``repro/launch/cells.py::cache_specs``: read off each leaf's shape, the
    rows over ``batch_axes``, an attention layer's cache as
    ``kv_cache_split`` says (``rules["kv_heads"]`` the model axis, and
    ``rules["cache_seq"]`` the sequence's: where both name it, the
    sequence's keeps it and the KV heads' later repeat is dropped, which
    the reference's ``NamedSharding`` refuses), recurrent states' heads or
    channels over the model axis, dims the axes do not divide whole
    (``fit_spec``).  A main-group leaf's leading group dim is known
    by its path: the reference reads it off the shape, (groups, B, ...)
    against (B, ...), and so takes the groups for the rows where they
    number the rows alike."""
    sizes = mesh_sizes(mesh)
    B = cache["len"].shape[0]
    model_ax, cache_seq_ax = rules.get("kv_heads"), rules.get("cache_seq")
    kv, hd, num_heads = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    model_size = sizes[model_ax] if model_ax else 1
    batch = _batch_entry(batch_axes)

    def spec_for(main: bool, shape: tuple) -> tuple:
        # strip the stacked main-group leading dim: (groups, B, ...)
        lead = ()
        if main:
            lead, shape = (None,), shape[1:]
        if not shape or shape[0] != B:
            return ()
        rest = shape[1:]
        if len(rest) == 3 and rest[-2:] == (kv, hd):  # (B, S, KV, hd) kv cache
            seq_ax, kv_ax = cache_seq_ax, model_ax
            if kv_cache_split(rest[0], kv, model_size) != "kv":
                kv_ax = None
                if rest[0] % model_size == 0:
                    seq_ax = model_ax
            return (*lead, batch, seq_ax, kv_ax, None)
        if len(rest) == 3 and rest[0] == num_heads:  # mLSTM C (B, H, dk, dv)
            return (*lead, batch, model_ax, None, None)
        if len(rest) == 2 and rest[0] == num_heads:  # (B, H, dk)
            return (*lead, batch, model_ax, None)
        if len(rest) == 2:  # conv state (B, W-1, C)
            return (*lead, batch, None, model_ax)
        return (*lead, batch, model_ax) if len(rest) == 1 else (*lead, batch)

    return _map_with_names(
        lambda names, x: fit_spec(spec_for(names[0] == "main", tuple(x.shape)),
                                  tuple(x.shape), sizes), cache)


def local_cache(cache, specs, mesh) -> dict:
    """This rank's block of a whole decode cache placed by ``specs``
    (``cache_specs``), each block in storage of its own: its rows, an
    attention layer's KV heads or positions, and a recurrent layer's heads
    or channels, where the specs split them.  ``"max_len"`` records the
    whole cache's positions (its longest attention cache), from which the
    model reads which attention caches the model axis splits over the
    sequence."""
    out = {seg: [{k: own_block(x, spec[k], mesh) for k, x in entry.items()}
                 for entry, spec in zip(cache[seg], specs[seg])]
           for seg in ("prefix", "main", "tail")}
    out["len"] = own_block(cache["len"], specs["len"], mesh)
    positions = [e["k"].shape[2 if seg == "main" else 1]
                 for seg in ("prefix", "main", "tail") for e in cache[seg] if "k" in e]
    if positions:
        out["max_len"] = max(positions)
    return out
