"""The trainer PE's loop, ported from
``repro/platform/runtime.py::PERuntime._run_trainer``.

``run_trainer(rt)`` runs data-parallel training inside a streams job, step
for step as the reference does: a gradient step of ``loss_fn`` in f32 on
this channel's shard of the lcg stream (a pure function of ``(seed, step *
width + channel)``, so no data state is stored), the mean of the loss and
the flat gradients over the region's collective, clipping and AdamW, one
tuple out per step, and every ``interval`` steps a consistent-region
checkpoint of ``{"params", "opt"}`` as numpy trees.  A collective that
aborts for a new epoch (a peer restarted, or the width changed) reloads the
committed checkpoint and replays from its step, which is what makes a
recovered run end at the same bits as an uninterrupted one.

``rt`` is a PE runtime, used only through the surface the reference's
loop uses: ``meta``, ``job``, ``pe_id``, ``rest`` (``rest.ckpt``,
``get_cr_state``, ``notify_checkpoint``, ``report_metrics``,
``notify_source_done``), ``fabric.collective``, ``stop_event``, ``_drain``,
``_cr``, ``_emit``, ``_flush_all`` and ``load_metrics``.  The port imports
nothing of the platform: a collective's epoch abort is recognised by its
name and ``epoch``.  The checkpoint store may be either package's: the
payloads are numpy trees, which both write and read the same way.

The model runs on the app config's ``device`` (CUDA unless it says
``"cpu"``).  On the card the loop turns on
``torch.use_deterministic_algorithms`` for the rest of the process and
sets ``CUBLAS_WORKSPACE_CONFIG`` (cuBLAS reads it when its first handle
is made, so a process that trains on the card should set it before its
first CUDA call, as ``chip_smoke.py`` does at its top); the port's kernels
on this path sum in fixed orders and use no atomics.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..configs import reduced_config
from ..convert import params_to_numpy
from ..data import StreamSource
from ..device import resolve_device
from ..models.lm import ModelOptions, init_params, loss_fn
from ..train.optim import (
    OptimizerConfig,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
    leaves,
)

CUBLAS_WORKSPACE = ":4096:8"  # a deterministic cuBLAS workspace


def _epoch_aborted(exc: BaseException) -> bool:
    """A collective's abort for a new epoch (the fabric's ``EpochAborted``),
    known by its name and its ``epoch``."""
    return type(exc).__name__ == "EpochAborted" and hasattr(exc, "epoch")


def _state_to_numpy(params, opt) -> dict:
    return {"params": params_to_numpy(params),
            "opt": {name: params_to_numpy(opt[name]) for name in ("m", "v")}}


def run_trainer(rt) -> None:
    """The trainer PE's body: train until the app's ``steps``, a stop or a
    drain; on reaching ``steps``, report the source done."""
    op = rt.meta["operators"][0]
    cfg_app = op["config"]
    channel = op["channel"] if op["channel"] >= 0 else 0
    width = rt.meta.get("widths", {}).get("dp", 1)
    arch_cfg = (reduced_config(cfg_app["arch"])
                if isinstance(cfg_app.get("arch"), str) else cfg_app["arch"])
    device = resolve_device(cfg_app.get("device"))
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        torch.use_deterministic_algorithms(True)
    opts = ModelOptions(compute_dtype="float32")
    ocfg = OptimizerConfig(lr=cfg_app.get("lr", 1e-3), warmup_steps=10)
    batch_per_shard = cfg_app.get("batch_per_shard", 4)
    seq_len = cfg_app.get("seq_len", 64)
    max_steps = cfg_app.get("steps", 50)
    cr = rt._cr()
    region = (cr or {}).get("name", "dp")
    interval = (cr or {}).get("interval", 10)

    source = StreamSource(vocab_size=arch_cfg.vocab_size, batch=batch_per_shard,
                          seq_len=seq_len, seed=cfg_app.get("data_seed", 0),
                          mode="lcg", frontend_len=arch_cfg.frontend_len,
                          frontend_dim=arch_cfg.frontend_dim)
    params = init_params(arch_cfg, seed=cfg_app.get("param_seed", 7),
                         device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = init_opt_state(params)
    step = 0

    def load_committed():
        nonlocal step
        st = rt.rest.get_cr_state(rt.job, region) if cr else None
        if st and st.get("lastCommitted", -1) >= 0:
            cstep = st["lastCommitted"]
            payload, meta = rt.rest.ckpt.load_shard(
                rt.job, region, cstep, "params", like=_state_to_numpy(params, opt))
            with torch.no_grad():
                for dst, src in zip(leaves({"params": params, "opt": opt}),
                                    leaves(payload)):
                    dst.copy_(torch.from_numpy(np.asarray(src)))
            step = meta["step"]

    load_committed()
    group = rt.fabric.collective(rt.job, region, width)
    epoch = group.epoch

    while not rt.stop_event.is_set() and step < max_steps:
        if rt._drain is not None:
            # a retiring trainer stops at a step boundary; the region's
            # consistent-region replay covers anything uncommitted
            break
        step_t0 = time.monotonic()
        batch = {k: v.to(device) for k, v in source.batch_at(step * width + channel).items()}
        for p in leaves(params):
            p.grad = None
        loss, _metrics = loss_fn(params, arch_cfg, batch, opts, remat=False)
        loss.backward()
        flat_g = [p.grad for p in leaves(params)]
        try:
            reduced = group.allreduce_mean(
                ("step", step),
                [loss.detach().cpu().numpy()] + [g.cpu().numpy() for g in flat_g],
                epoch, rank=channel)
        except Exception as e:  # noqa: BLE001 — only an epoch abort is handled
            if not _epoch_aborted(e):
                raise
            epoch = e.epoch
            load_committed()
            continue
        mean_loss = float(reduced[0])
        # copies (on the card, the host-to-device copy itself): every rank
        # gets the same result arrays, and clipping scales in place
        grads = [torch.from_numpy(np.asarray(r, dtype=np.float32)).to(device, copy=True)
                 for r in reduced[1:]]
        grads, _ = clip_by_global_norm(grads, ocfg.clip_norm)
        adamw_update(ocfg, params, grads, opt, step)  # grads: a flat list in leaves order
        step += 1
        rt._emit(0, {"seq": step, "step": step, "loss": mean_loss})
        rt._flush_all()  # one tuple per step: nothing to amortize
        if cr and step % interval == 0:
            if channel == 0:  # replicas identical post-allreduce
                st = rt.rest.get_cr_state(rt.job, region)
                base = st.get("lastCommitted", -1) if st else -1
                rt.rest.ckpt.save_shard(rt.job, region, step, "params",
                                        arrays=_state_to_numpy(params, opt),
                                        meta={"step": step},
                                        base_step=base if base >= 0 else None)
            rt.rest.notify_checkpoint(rt.job, region, rt.pe_id, step)
        rt.rest.report_metrics(
            rt.job, rt.pe_id,
            rt.load_metrics({"step": step, "loss": mean_loss,
                             "stepTime": time.monotonic() - step_t0}))
    if step >= max_steps:
        rt.rest.notify_source_done(rt.job, rt.pe_id)

