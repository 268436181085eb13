"""The training step, ported from ``repro/train/step.py``.

``make_train_step`` builds ``step(state, batch) -> (state, metrics)``: the
gradients of ``loss_fn`` (over ``accum_steps`` micro-batches, summed and
averaged as the reference's ``lax.scan`` does), clipped to the global norm
and applied by AdamW.  The state is updated in place and returned, as
``decode_step`` does with its cache: parameters, moments and gradients of
a full-size model do not fit twice on one card.

A train state is ``{"params", "opt": {"m", "v"}, "step"}``: f32 parameters
that require grad, f32 moments, and ``step``, a 0-dim int32 tensor kept on
the CPU, so the update's step-dependent scalars need no device sync; with
``compress_pod_grads`` also ``ef``, the error-feedback buffers.

On a mesh (``repro_torch.launch.mesh``, axes ``pod``, ``data``,
``model``) the step is data-parallel over ``pod`` x ``data`` and
tensor-parallel over ``model``.  Every parameter, moment and EF buffer is
held at rest as this rank's shard (``train_state_specs``: the reference's
partition, dims the mesh axes do not divide left whole).  ``step(state,
global_batch)`` takes this rank's rows (``batch_sharding``) and gathers
each leaf over the batch axes (``data``, from ``embed_p``).  Leaves of
dense attention, dense MLPs, the embedding, the head, the routed experts,
the shared experts, the RG-LRU and mLSTM layers and the sLSTM's FFN stay
split over ``model``: the model computes on them as column- and
row-parallel blocks, a vocab-parallel cross-entropy and expert-parallel
MoE layers (``sharding.ctx.model_group``); the other leaves split over
``model`` (the MoE router, the sLSTM's recurrent weights) are gathered
whole, and their compute is replicated within a ``model`` group.  The
gradient mean over the batch ranks is a reduce-scatter whose sums run in
rank order (``_mean_block``): each rank keeps its own block.  The step
clips by the global norm over the blocks (each leaf's squares summed over
the ranks that split it, once for a replicated leaf) and applies AdamW to
the block.  The loss is the global
batch's (``sharding.ctx.loss_group``).  The compressed variant takes each
pod's gradient (the mean over its data ranks, the loss over its rows, as
the reference's per-pod ``vmap``), adds the pod's EF buffer block and
combines the pods in int8 (``train.compress``), each block at its whole
leaf's scale.  Where one rank holds every leaf whole, the step copies
nothing: no gather buffer and no second parameter tree, and it computes
what the one-device step computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..convert import map_params, zip_params
from ..launch.mesh import BATCH_AXES
from ..models.lm import ModelOptions, init_params, loss_fn
from ..sharding.collectives import (
    gather_leaf,
    gather_stack,
    ordered_reduce_scatter,
    ordered_sum,
)
from ..sharding.ctx import tensor_axis, use_rules
from ..sharding.specs import (
    PARAM_RULES,
    local_block,
    local_params,
    map_specs,
    mesh_rules,
    param_specs,
    spec_axes,
    tensor_parallel,
)
from .compress import compressed_mean_over_axis, init_ef_state
from .optim import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
    leaves,
)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    accum_steps: int = 1
    compress_pod_grads: bool = False
    num_pods: int = 1
    remat: bool = True


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(), *,
                     seed: int = 0, device=None, params=None, mesh=None,
                     rules: dict = PARAM_RULES) -> dict:
    """A fresh train state: ``params`` if given (f32 tensors, e.g. the
    reference's through ``repro_torch.convert``), else ``init_params(cfg,
    seed, device)``; zero moments; step 0.  On a ``mesh`` (whose device
    is the default) it keeps this rank's shard of each leaf (partitioned
    by ``rules``), and its pod's EF buffers under ``compress_pod_grads``."""
    if params is None:
        if device is None and mesh is not None:
            device = mesh.device
        params = init_params(cfg, seed=seed, device=device)
    for p in leaves(params):
        if p.dtype != torch.float32:
            raise TypeError(f"train parameters must be float32, got {p.dtype}")
    num_pods = tcfg.num_pods
    if mesh is not None:
        params = local_params(params, mesh, rules)
        if tcfg.compress_pod_grads:
            if mesh.shape.get("pod") != tcfg.num_pods:
                raise ValueError(f"num_pods {tcfg.num_pods} is not the mesh's "
                                 f"{mesh.shape.get('pod')} pods")
            num_pods = 1  # this rank holds its own pod's buffers
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if tcfg.compress_pod_grads:
        state["ef"] = init_ef_state(params, num_pods)
    return state


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()) -> dict:
    """A train state of shapes and dtypes only (fake tensors: nothing is
    drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_train_state(cfg, tcfg, device="cpu")


def train_state_specs(state, mesh, rules: dict = PARAM_RULES) -> dict:
    """Spec tuples for a (possibly abstract) train state on a mesh or a
    mapping of axis sizes: parameters and moments by
    ``sharding.specs.param_specs``, EF buffers with their pod dim over
    ``pod``, ``step`` replicated."""
    p_specs = param_specs(state["params"], mesh, rules)
    specs = {"params": p_specs, "opt": {"m": p_specs, "v": p_specs}, "step": ()}
    if "ef" in state:
        specs["ef"] = zip_params(lambda _p, s: ("pod",) + s, state["params"], p_specs)
    return specs


def batch_sharding(mesh, batch, data_axes: tuple = BATCH_AXES, accum_steps: int = 1):
    """This rank's rows of a global batch (tensors or arrays with a leading
    batch dim), on the mesh's device: block ``pod_idx * n_data +
    data_idx`` of the rows, as the reference shards them over ``data_axes``.
    With ``accum_steps`` micro-batches, the rank's block of each micro-batch
    (consecutive rows of the global batch), in order."""
    axes = tuple(a for a in data_axes if a in mesh.axis_names)
    n, i = mesh.size(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % (n * accum_steps):
            raise ValueError(f"batch {v.shape[0]} does not split over {n} ranks "
                             f"x {accum_steps} micro-batches")
        m = v.shape[0] // accum_steps
        r = m // n
        rows = [v[j * m + i * r:j * m + (i + 1) * r] for j in range(accum_steps)]
        out[k] = (rows[0] if accum_steps == 1 else torch.cat(rows)).to(mesh.device)
    return out


def _grads_and_metrics(params, batch, cfg, opts, remat, accum_steps):
    """Gradients (a tree like ``params``), loss and metrics, accumulated in
    the parameters' ``.grad`` over ``accum_steps`` micro-batches."""
    B = batch["tokens"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not a multiple of accum_steps "
                         f"{accum_steps}")
    n = B // accum_steps
    loss_sum = None
    for i in range(accum_steps):
        micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, metrics = loss_fn(params, cfg, micro, opts, remat=remat)
        loss.backward()  # sums into .grad, as the reference's scan carry
        loss_sum = loss.detach() if i == 0 else loss_sum + loss.detach()
    grads = map_params(lambda _k, p: p.grad if p.grad is not None
                       else torch.zeros_like(p), params)
    if accum_steps <= 1:
        return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}
    with torch.no_grad():
        for g in leaves(grads):
            g.div_(accum_steps)
    zero = torch.zeros((), device=loss_sum.device)
    return grads, loss_sum / accum_steps, {"ce_loss": loss_sum / accum_steps,
                                           "aux_loss": zero, "tokens": zero}


def _mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of every rank's ``x`` over ``group``, summed in rank order;
    ``x`` itself for one rank."""
    return x if group is None else ordered_sum(x, group, n) / n


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(),
                    opts: ModelOptions = ModelOptions(),
                    mesh: Optional[object] = None,
                    act_rules: Optional[dict] = None, *,
                    param_rules: dict = PARAM_RULES,
                    batch_axes: tuple = BATCH_AXES):
    """Returns ``step(state, batch) -> (state, metrics)``.  ``batch`` holds
    ``tokens`` and ``labels`` (B,S) on any device (on a mesh, the global
    batch); they move to the parameters' device.  ``metrics``: ``loss``,
    ``grad_norm``, ``ce_loss``, ``aux_loss``, ``tokens`` (tensors on that
    device).  ``act_rules`` is bound around the loss on a mesh; there the
    state is partitioned by ``param_rules`` (as ``init_train_state`` took
    them) and the batch split over the mesh's ``batch_axes``, which must
    have a group (a real mesh makes (pod, data) and each axis alone)."""
    if tcfg.compress_pod_grads and (mesh is None or "pod" not in mesh.axis_names):
        raise ValueError("compress_pod_grads needs a mesh with a 'pod' axis")
    if mesh is not None:
        return _mesh_step(cfg, tcfg, opts, mesh, act_rules or {}, param_rules,
                          batch_axes)
    ocfg = tcfg.optimizer

    def step(state, batch):
        params = state["params"]
        dev = leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        for p in leaves(params):
            p.grad = None
        grads, loss, metrics = _grads_and_metrics(
            params, batch, cfg, opts, tcfg.remat, tcfg.accum_steps)
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm)
        adamw_update(ocfg, params, grads, state["opt"], state["step"])
        for p in leaves(params):  # free the gradients before the next step
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return step


@dataclass(frozen=True)
class _LeafPlan:
    """How the mesh step moves one leaf: ``gather``, the spec it is
    gathered over for compute (every split dim but those that
    tensor-parallel compute keeps local), and ``split``, the mesh axes of
    more than one rank that split it at rest, in the mesh's order."""

    gather: tuple
    split: tuple


def _leaf_plans(cfg, mesh, param_rules, tp):
    """A tree of ``_LeafPlan`` like the parameters, for tensor-parallel
    compute over ``tp`` (None: none)."""
    def plan(names, spec):
        local = tp is not None and tensor_parallel(names)
        axes = {a for part in spec for a in spec_axes(part) if mesh.shape[a] > 1}
        return _LeafPlan(tuple(None if local and part == tp else part for part in spec),
                         tuple(a for a in mesh.axis_names if a in axes))
    return map_specs(plan, abstract_train_state(cfg)["params"], mesh,
                     mesh_rules(mesh, param_rules))


def compute_gather(cfg, mesh, tp, param_rules: dict = PARAM_RULES):
    """``gather(params)``: the tree the model computes on, from this rank's
    shards (``local_params`` by ``param_rules``): each leaf gathered over
    the batch axes, and over ``tp`` (the tensor-parallel axis, or None)
    unless tensor-parallel compute keeps its block there
    (``specs.tensor_parallel``)."""
    plans = _leaf_plans(cfg, mesh, param_rules, tp)
    return lambda params: zip_params(lambda p, q: gather_leaf(p, q.gather, mesh),
                                     params, plans)


def _mean_block(g, spec, mesh, loss_axes, group, n):
    """This rank's block (by ``spec``) of the mean of every loss rank's
    ``g``, summed in rank order.  A dim split over the loss group's minor
    axis (``data``) is reduce-scattered, each rank keeping its own block
    (and its major axis's ranks, ``pod``, sharing theirs by an
    all-gather); the sum is taken whole where the spec splits otherwise."""
    if group is None:
        return local_block(g, spec, mesh)
    dims = [d for d, part in enumerate(spec) if set(spec_axes(part)) & set(loss_axes)]
    axis, major = loss_axes[-1], loss_axes[:-1]
    if len(dims) != 1 or spec_axes(spec[dims[0]]) != (axis,) or len(major) > 1:
        return local_block(ordered_sum(g, group, n) / n, spec, mesh)
    k = dims[0]
    n_a = mesh.shape[axis]
    n_o = n // n_a
    y = g.movedim(k, 0)
    block_shape = (y.shape[0] // n_a, *y.shape[1:])
    R = g.numel() // n_a
    m = -(-R // n_o)
    rows = y.reshape(n_a, R)
    if m * n_o != R:
        rows = torch.nn.functional.pad(rows, (0, m * n_o - R))
    # group rank o * n_a + a keeps piece o of block a
    piece = ordered_reduce_scatter(rows.view(n_a, n_o, m).transpose(0, 1).reshape(n, m),
                                   group, n)
    if n_o > 1:
        piece = gather_stack(piece, mesh.group(major), n_o).reshape(-1)
    block = (piece[:R].view(block_shape) / n).movedim(0, k)
    rest = tuple(None if d == k else part for d, part in enumerate(spec))
    return local_block(block, rest, mesh)


def _sharded_norm(grads, plan: list, mesh) -> torch.Tensor:
    """The global norm of gradients held as blocks: each leaf's squares
    summed over the axes that split it (one rank-ordered sum per axis, in
    the mesh's order, for all leaves split alike), a leaf that is
    replicated counted once; every rank gets the same bits."""
    sq = [torch.linalg.vector_norm(g.float()).square() for g in leaves(grads)]
    by_split = {}
    for i, q in enumerate(plan):
        if q.split:
            by_split.setdefault(q.split, []).append(i)
    for axes, idx in by_split.items():
        v = torch.stack([sq[i] for i in idx])
        for a in axes:
            v = ordered_sum(v, mesh.group((a,)), mesh.shape[a])
        for j, i in enumerate(idx):
            sq[i] = v[j]
    return torch.sqrt(sum(sq))


def _mesh_step(cfg, tcfg, opts, mesh, act_rules, param_rules, batch_axes):
    ocfg = tcfg.optimizer
    compress = tcfg.compress_pod_grads
    batch_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    # the ranks whose rows make up one loss: the batch's, or a pod's
    loss_axes = tuple(a for a in batch_axes if a != "pod") if compress else batch_axes
    loss_group, n_loss = mesh.group(loss_axes), mesh.size(loss_axes)
    if n_loss > 1 and loss_group is None:
        raise ValueError(f"the mesh has no group over {loss_axes}")
    pod_group, n_pods = mesh.group(("pod",)), mesh.shape.get("pod", 1)
    tp = tensor_axis(act_rules, mesh, loss_axes)
    plans = _leaf_plans(cfg, mesh, param_rules, tp)
    # as the reference, the compressed step takes each pod's gradient in
    # one pass (its accum_steps is not read)
    accum = 1 if compress else tcfg.accum_steps

    def step(state, batch):
        params = state["params"]
        plan = leaves(zip_params(lambda _p, q: q, params, plans))  # in params' order
        batch = batch_sharding(mesh, batch, batch_axes, accum)
        full = zip_params(lambda p, q: gather_leaf(p, q.gather, mesh), params, plans)
        for p in leaves(full):
            p.requires_grad_(True)
            p.grad = None
        with use_rules(mesh, act_rules, batch_axes=loss_axes):
            grads, loss, metrics = _grads_and_metrics(
                full, batch, cfg, opts, tcfg.remat, accum)
        grads = zip_params(lambda g, q: _mean_block(g, q.gather, mesh, loss_axes,
                                                    loss_group, n_loss), grads, plans)
        loss = _mean(loss, loss_group, n_loss)
        metrics = {k: _mean(v, loss_group, n_loss) for k, v in metrics.items()}
        if compress:
            # this pod's EF buffers, this rank's blocks of them
            ef = map_params(lambda _k, e: e[0], state["ef"])
            # each block's scale is the whole leaf's: the max over the ranks
            # that split it within the pod
            grads, new_ef = compressed_mean_over_axis(grads, ef, pod_group, [
                [(mesh.group((a,)), mesh.shape[a]) for a in q.split if a != "pod"]
                for q in plan])
            del ef
            state["ef"] = map_params(lambda _k, e: e[None], new_ef)
            del new_ef
            loss = _mean(loss, pod_group, n_pods)
            zero = torch.zeros((), device=loss.device)
            metrics = {"ce_loss": loss, "aux_loss": zero, "tokens": zero}
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm,
                                           norm=_sharded_norm(grads, plan, mesh))
        adamw_update(ocfg, params, grads, state["opt"], state["step"])
        for p in leaves(full):  # free the gradients and the gathered copies
            p.grad = None
        del full, grads
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return step
