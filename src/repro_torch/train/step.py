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
``model``) the step is data-parallel over ``pod`` x ``data``.  Every
parameter, moment and EF buffer is held at rest as this rank's shard
(``train_state_specs``: the reference's partition, dims the mesh axes do
not divide left whole).  ``step(state, global_batch)`` takes this rank's
rows (``batch_sharding``), gathers each leaf whole, computes the gradients
on its rows, and takes their mean over the batch ranks in rank order; it
clips on the whole tree and applies AdamW to the shard.  Compute within a
``model`` group is replicated: tensor-parallel compute is not ported.  The
loss is the global batch's (``sharding.ctx.loss_group``).  The compressed
variant takes each pod's gradient (the mean over its data ranks, the loss
over its rows, as the reference's per-pod ``vmap``), adds the pod's EF
buffer and combines the pods in int8 (``train.compress``).  Where one rank
holds every leaf whole, the step copies nothing: no gather buffer and no
second parameter tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..convert import map_params, zip_params
from ..launch.mesh import BATCH_AXES
from ..models.lm import ModelOptions, init_params, loss_fn
from ..sharding.collectives import gather_leaf, local_block, ordered_sum
from ..sharding.ctx import use_rules
from ..sharding.specs import PARAM_RULES, param_specs, spec_axes
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
        specs = param_specs(params, mesh, mesh_rules(mesh, rules))
        params = zip_params(lambda p, s: _own(local_block(p, s, mesh), p), params, specs)
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


def _own(block: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A block that owns its storage (the whole leaf where it is one)."""
    return whole if block is whole else block.clone()


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()) -> dict:
    """A train state of shapes and dtypes only (fake tensors: nothing is
    drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_train_state(cfg, tcfg, device="cpu")


def mesh_rules(mesh, rules: dict = PARAM_RULES) -> dict:
    """The rules whose mesh axes ``mesh`` has, as the reference's
    compressed step filters them."""
    return {k: v for k, v in rules.items()
            if all(a in mesh.axis_names for a in spec_axes(v))}


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


def _mesh_step(cfg, tcfg, opts, mesh, act_rules, param_rules, batch_axes):
    ocfg = tcfg.optimizer
    compress = tcfg.compress_pod_grads
    specs = param_specs(abstract_train_state(cfg)["params"], mesh,
                        mesh_rules(mesh, param_rules))
    batch_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    # the ranks whose rows make up one loss: the batch's, or a pod's
    loss_axes = tuple(a for a in batch_axes if a != "pod") if compress else batch_axes
    loss_group, n_loss = mesh.group(loss_axes), mesh.size(loss_axes)
    if n_loss > 1 and loss_group is None:
        raise ValueError(f"the mesh has no group over {loss_axes}")
    pod_group, n_pods = mesh.group(("pod",)), mesh.shape.get("pod", 1)
    # as the reference, the compressed step takes each pod's gradient in
    # one pass (its accum_steps is not read)
    accum = 1 if compress else tcfg.accum_steps

    def step(state, batch):
        params = state["params"]
        batch = batch_sharding(mesh, batch, batch_axes, accum)
        full = zip_params(lambda p, s: gather_leaf(p, s, mesh), params, specs)
        for p in leaves(full):
            p.requires_grad_(True)
            p.grad = None
        with use_rules(mesh, act_rules, batch_axes=loss_axes):
            grads, loss, metrics = _grads_and_metrics(
                full, batch, cfg, opts, tcfg.remat, accum)
        grads = map_params(lambda _k, g: _mean(g, loss_group, n_loss), grads)
        loss = _mean(loss, loss_group, n_loss)
        metrics = {k: _mean(v, loss_group, n_loss) for k, v in metrics.items()}
        if compress:
            # this pod's EF buffers, gathered whole within the pod
            ef = zip_params(lambda e, s: gather_leaf(e, (None,) + s, mesh)[0],
                            state["ef"], specs)
            grads, new_ef = compressed_mean_over_axis(grads, ef, pod_group)
            del ef
            state["ef"] = zip_params(
                lambda ne, s: _own(local_block(ne, s, mesh), ne)[None], new_ef, specs)
            del new_ef
            loss = _mean(loss, pod_group, n_pods)
            zero = torch.zeros((), device=loss.device)
            metrics = {"ce_loss": loss, "aux_loss": zero, "tokens": zero}
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm)
        local = zip_params(lambda g, s: local_block(g, s, mesh), grads, specs)
        adamw_update(ocfg, params, local, state["opt"], state["step"])
        for p in leaves(full):  # free the gradients and the gathered copies
            p.grad = None
        del full, grads, local
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return step
