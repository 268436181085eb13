"""Causal GQA flash attention (forward): the wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  K/V stay compact
(``KV`` heads, read through ``h // G``), any sequence length is taken (the
kernel masks the ragged last tile itself), and head dims up to 256.  A
tensor on the CPU takes the plain version (``ref.causal_attention_ref`` and
``ref.attention_lse_ref``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import attention_lse_ref, causal_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, return_lse: bool = False):
    """q (B,S,H,D); k, v (B,S,KV,D), all in one dtype -> out (B,S,H,D) in
    that dtype [, lse (B,S,H) f32]."""
    name = "flash_attention"
    if _build.on_cpu(name, q=q, k=k, v=v):
        out = causal_attention_ref(q, k, v, causal)
        return (out, attention_lse_ref(q, k, causal)) if return_lse else out
    _build.check_inputs(name, q.device, q=q, k=k, v=v)
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: q dtype {q.dtype} is not float32/bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k and v must have q's dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B,S,heads,D)")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if (k.shape != (B, S, KV, D) or v.shape != k.shape or KV == 0
            or H % KV):
        raise ValueError(f"{name}: shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    lib = _build.library()
    if not 0 < D <= lib.repro_flash_attention_max_head_dim():
        raise ValueError(f"{name}: head dim {D} is outside 1.."
                         f"{lib.repro_flash_attention_max_head_dim()}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = lib.repro_flash_attention(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        B, S, H, KV, D, int(causal), 1.0 / math.sqrt(D),
        _build.stream(q.device))
    _build.check(err, name)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches since the count was last reset
