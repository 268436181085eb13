"""RMSNorm: the wrapper of the CUDA kernel ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.  A
tensor on the CPU takes the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the kernel or raises.  On the card the call is
differentiable: its backward is ``ref.rmsnorm_bwd_ref`` in plain torch ops,
since the reference trains through its plain RMSNorm and has no backward
kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import rmsnorm_bwd_ref, rmsnorm_ref


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _build.check_inputs("rmsnorm", x.device, x=x, scale=scale)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: x dtype {x.dtype} is not float32/bfloat16")
    d = x.shape[-1]
    if d == 0 or scale.shape != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm: scale must be float32 of shape ({d},), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    out = torch.empty_like(x)
    err = _build.library().repro_rmsnorm(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        scale.data_ptr(), out.data_ptr(), x.numel() // d, d, eps,
        _build.stream(x.device))
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_ref(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm_cost(rows: int, d: int, dtype) -> _build.Cost:
    """x (rows, d) read and the output written in ``dtype``, the f32 scale
    read; a square, a sum, a scale and a multiply an element."""
    n = rows * d
    return _build.Cost(4 * n, 2 * n * dtype.itemsize + 4 * d)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) f32 or bf16; scale (d,) f32 -> same shape and dtype as x."""
    d = x.shape[-1]
    with _build.counted("rmsnorm", lambda: rmsnorm_cost(x.numel() // max(d, 1), d,
                                                        x.dtype)):
        if _build.on_cpu("rmsnorm", x=x, scale=scale):
            return rmsnorm_ref(x, scale, eps)
        return _RMSNorm.apply(x, scale, eps)


rmsnorm.launches = 0  # kernel launches since the count was last reset
rmsnorm.cost = rmsnorm_cost
