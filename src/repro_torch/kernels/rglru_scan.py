"""RG-LRU linear recurrence: the wrapper of the CUDA kernel
``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py::rglru_scan``:
``h_t = exp(log_a_t) * h_{t-1} + b_t`` from ``h_{-1} = 0``, elementwise over
channels, in f32.  Unlike the TPU kernel it takes any B, S and C.  A tensor
on the CPU takes the plain version (``ref.rglru_scan_ref``); a CUDA tensor
launches the kernel or raises.  Neither package has a backward for it, so
under grad mode inputs that require grad are refused.

A block of the kernel owns 32 channels of one batch row and walks the
sequence in stages of 128 time steps, two stages of loads in flight ahead of
its scan; rows that are not whole 16-byte pieces from 16-byte aligned bases
take 4-byte copies (``csrc/rglru_scan.cu``).
"""

from __future__ import annotations

import torch

from . import _build
from .ref import rglru_scan_ref


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b (B,S,C) f32 -> h (B,S,C) f32."""
    name = "rglru_scan"
    _build.refuse_grad(name, log_a=log_a, b=b)
    if _build.on_cpu(name, log_a=log_a, b=b):
        return rglru_scan_ref(log_a, b)
    _build.check_inputs(name, log_a.device, log_a=log_a, b=b)
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name}: log_a and b must be float32, got "
                        f"{log_a.dtype} and {b.dtype}")
    if log_a.dim() != 3 or b.shape != log_a.shape:
        raise ValueError(f"{name}: log_a {tuple(log_a.shape)} and b "
                         f"{tuple(b.shape)} must be one (B,S,C) shape")
    B, S, C = log_a.shape
    h = torch.empty_like(b)
    err = _build.library().repro_rglru_scan(
        log_a.device.index, log_a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S,
        C, _build.stream(log_a.device))
    _build.check(err, name)
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0  # kernel launches since the count was last reset
