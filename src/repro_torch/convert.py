"""Parameters across the boundary between the two packages, through numpy.

The reference's parameter pytree (nested dicts and lists of arrays, main
group leaves stacked on a leading axis) maps one to one onto the port's:
same keys, same shapes, same axis orders.  Nothing here imports JAX; any
leaf that ``numpy.asarray`` takes will do.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def map_params(fn, tree, key=None):
    """Apply ``fn(key, leaf)`` to every leaf of a nested dict/list tree;
    ``key`` is the dict key the leaf sits under."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_params(fn, v, key) for v in tree)
    return fn(key, tree)


def zip_params(fn, a, b):
    """Apply ``fn(leaf_a, leaf_b)`` to the matching leaves of two trees of
    one structure (dicts matched by key, in ``a``'s order)."""
    if isinstance(a, dict):
        return {k: zip_params(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(zip_params(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


# Leaves that the reference reads in f32 (``x.astype(f32) @ w``, ``+ b`` in
# f32, an f32 step conv, qwen2-moe's shared-expert gate) rather than through
# ``.astype(dtype)``, by the
# block that holds them.  Norm scales (``scale``, anywhere) are read in f32
# too.
F32_LEAVES = {
    "rglru": {"w_a", "w_i", "b_a", "b_i", "lam", "conv_w", "conv_b"},
    "mlstm": {"w_i", "w_f", "b_i", "b_f", "conv_w", "conv_b"},
    "slstm": {f"{kind}_{gate}" for kind in "wrb" for gate in "zifo"},
    "moe": {"shared_gate"},
}


def _map_with_block(fn, tree, key=None, block=None):
    """``fn(leaf, key, block)`` on every leaf: ``key`` is the dict key the
    leaf sits under and ``block`` the key of the dict that holds it."""
    if isinstance(tree, dict):
        return {k: _map_with_block(fn, v, k, key) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_block(fn, v, key, block) for v in tree)
    return fn(tree, key, block)


def cast_params(params, dtype: torch.dtype, device=None):
    """Matrices and the embedding table in ``dtype``; norm scales and the
    leaves in ``F32_LEAVES`` stay f32, because the layers read them in f32
    and a narrower copy would change the numbers."""
    def cast(leaf, key, block):
        keep = key == "scale" or key in F32_LEAVES.get(block, ())
        return leaf.to(device=device, dtype=torch.float32 if keep else dtype)
    return _map_with_block(cast, params)


def params_from_numpy(tree, device=None, dtype: torch.dtype = torch.float32):
    """The reference's parameters (arrays, as numpy takes them) as the
    port's tensors on ``device`` (CUDA unless the caller asks for the CPU),
    cast as ``cast_params`` does."""
    dev = resolve_device(device)
    tensors = map_params(
        lambda _k, a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)
    return cast_params(tensors, dtype, dev)


def params_to_numpy(params):
    """The port's parameters as f32 numpy arrays, in the same tree."""
    return map_params(lambda _k, t: t.detach().float().cpu().numpy(), params)


def train_state_from_numpy(state, device=None) -> dict:
    """The reference's train state (``params``, ``opt.m``, ``opt.v``,
    ``step``; arrays as numpy takes them) as the port's: f32 tensors on
    ``device`` (CUDA unless the caller asks for the CPU), parameters that
    require grad, and ``step`` a 0-dim int32 tensor on the CPU."""
    params = params_from_numpy(state["params"], device)
    map_params(lambda _k, p: p.requires_grad_(True), params)
    return {
        "params": params,
        "opt": {name: params_from_numpy(state["opt"][name], device)
                for name in ("m", "v")},
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
    }


def train_state_to_numpy(state) -> dict:
    """The port's train state as f32 numpy arrays (``step`` int32), in the
    reference's tree."""
    return {
        "params": params_to_numpy(state["params"]),
        "opt": {name: params_to_numpy(state["opt"][name]) for name in ("m", "v")},
        "step": np.asarray(int(state["step"]), dtype=np.int32),
    }
