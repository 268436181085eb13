"""RG-LRU linear recurrence: the wrappers of the CUDA kernels
``csrc/rglru_scan.cu`` (forward) and ``csrc/rglru_scan_bwd.cu`` (backward),
and ``rglru_scan``, the differentiable function made of the two.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py::rglru_scan``:
``h_t = exp(log_a_t) * h_{t-1} + b_t`` from ``h_{-1} = 0``, elementwise over
channels, in f32.  Unlike the TPU kernel it takes any B, S and C.  The
reference trains through its associative scan
(``repro/models/recurrent.py::rglru_seq``); the port's backward is the
reverse linear scan ``g_t = dh_t + a_{t+1} g_{t+1}``, with ``db = g`` and
``dlog_a_t = g_t * a_t * h_{t-1}``, from the forward's saved h.  Tensors on
the CPU take the plain versions (``ref.rglru_scan_ref``,
``ref.rglru_scan_bwd_ref``); CUDA tensors launch the kernels or raise.

A block of either kernel owns 32 channels of one batch row and walks the
sequence in stages of 128 time steps (the backward from the last), two
stages of loads in flight ahead of its scan; rows that are not whole
16-byte pieces from 16-byte aligned bases take 4-byte copies.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import rglru_scan_bwd_ref, rglru_scan_ref


def _check(name: str, **tensors) -> None:
    """The kernels' checks beyond ``check_inputs``: f32, one (B,S,C) shape."""
    _build.check_inputs(name, next(iter(tensors.values())).device, **tensors)
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError(f"{name}: {', '.join(tensors)} must be float32, got "
                        f"{', '.join(str(t.dtype) for t in tensors.values())}")
    shapes = {tuple(t.shape) for t in tensors.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 3:
        raise ValueError(f"{name}: {', '.join(tensors)} must be one (B,S,C) "
                         f"shape, got {sorted(shapes)}")


def rglru_scan_cost(n: int) -> _build.Cost:
    """Over n = B * S * C elements: log_a and b read, h written, f32; exp,
    multiply and add an element."""
    return _build.Cost(3 * n, 3 * n * 4)


def rglru_scan_bwd_cost(n: int) -> _build.Cost:
    """Over n = B * S * C elements: log_a, h and dh read, dlog_a and db
    written, f32; exp, FMA and two multiplies an element."""
    return _build.Cost(5 * n, 5 * n * 4)


def rglru_scan_fwd(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel: log_a, b (B,S,C) f32 -> h (B,S,C) f32."""
    with _build.counted("rglru_scan", lambda: rglru_scan_cost(log_a.numel())):
        name = "rglru_scan"
        if _build.on_cpu(name, log_a=log_a, b=b):
            return torch.empty_like(b) if _build.shapes_only() else rglru_scan_ref(log_a, b)
        _check(name, log_a=log_a, b=b)
        B, S, C = log_a.shape
        h = torch.empty_like(b)
        err = _build.library().repro_rglru_scan(
            log_a.device.index, log_a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S,
            C, _build.stream(log_a.device))
        _build.check(err, name)
        rglru_scan.launches += 1
        return h


def rglru_scan_bwd(log_a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> tuple:
    """The backward kernel: log_a, the forward's h and the output's
    gradient dh (B,S,C) f32 -> (dlog_a, db) (B,S,C) f32."""
    with _build.counted("rglru_scan_bwd", lambda: rglru_scan_bwd_cost(log_a.numel())):
        name = "rglru_scan_bwd"
        if _build.on_cpu(name, log_a=log_a, h=h, dh=dh):
            if _build.shapes_only():
                return torch.empty_like(h), torch.empty_like(h)
            return rglru_scan_bwd_ref(log_a, h, dh)
        _check(name, log_a=log_a, h=h, dh=dh)
        B, S, C = log_a.shape
        dlog_a, db = torch.empty_like(h), torch.empty_like(h)
        err = _build.library().repro_rglru_scan_bwd(
            log_a.device.index, log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
            dlog_a.data_ptr(), db.data_ptr(), B, S, C, _build.stream(log_a.device))
        _build.check(err, name)
        rglru_scan_bwd.launches += 1
        return dlog_a, db


class _RglruScan(torch.autograd.Function):
    """Forward: the scan kernel; backward: the reverse-scan kernel on the
    saved (log_a, h)."""

    @staticmethod
    def forward(ctx, log_a, b):
        h = rglru_scan_fwd(log_a, b)
        ctx.save_for_backward(log_a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        return rglru_scan_bwd(log_a, h, dh.contiguous())


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b (B,S,C) f32 -> h (B,S,C) f32, differentiable in both."""
    return _RglruScan.apply(log_a, b)


rglru_scan.launches = 0  # forward kernel launches since the count was last reset
rglru_scan_bwd.launches = 0  # backward kernel launches likewise
rglru_scan.cost = rglru_scan_cost
rglru_scan_bwd.cost = rglru_scan_bwd_cost
