"""The training step on one device, ported from ``repro/train/step.py``.

``make_train_step`` builds ``step(state, batch) -> (state, metrics)``: the
gradients of ``loss_fn`` (over ``accum_steps`` micro-batches, summed and
averaged as the reference's ``lax.scan`` does), clipped to the global norm
and applied by AdamW.  The state is updated in place and returned, as
``decode_step`` does with its cache: parameters, moments and gradients of
a full-size model do not fit twice on one card.  The reference's mesh
variant and its int8 error-feedback gradient compression come with the
port's multi-GPU slice.

A train state is ``{"params", "opt": {"m", "v"}, "step"}``: f32 parameters
that require grad, f32 moments, and ``step``, a 0-dim int32 tensor kept on
the CPU, so the update's step-dependent scalars need no device sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..convert import map_params
from ..models.lm import ModelOptions, init_params, loss_fn
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


def _multi_gpu(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with the port's multi-GPU slice")


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(), *,
                     seed: int = 0, device=None, params=None) -> dict:
    """A fresh train state: ``params`` if given (f32 tensors, e.g. the
    reference's through ``repro_torch.convert``), else ``init_params(cfg,
    seed, device)``; zero moments; step 0."""
    if tcfg.compress_pod_grads:
        raise _multi_gpu("compress_pod_grads (int8 error-feedback gradients)")
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    for p in leaves(params):
        if p.dtype != torch.float32:
            raise TypeError(f"train parameters must be float32, got {p.dtype}")
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32)}


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


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(),
                    opts: ModelOptions = ModelOptions(),
                    mesh: Optional[object] = None,
                    act_rules: Optional[dict] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.  ``batch`` holds
    ``tokens`` and ``labels`` (B,S) on any device; they move to the
    parameters' device.  ``metrics``: ``loss``, ``grad_norm``, ``ce_loss``,
    ``aux_loss``, ``tokens`` (tensors on that device)."""
    if mesh is not None or act_rules is not None:
        raise _multi_gpu("a device mesh (sharded training)")
    if tcfg.compress_pod_grads:
        raise _multi_gpu("compress_pod_grads (int8 error-feedback gradients)")
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
