"""Paged GQA decode attention: the wrapper of the CUDA kernel
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention``.  K/V live in
a block pool ``(num_blocks, block_size, KV, D)``; each sequence names its
blocks through a row of ``block_tables``.  Block 0 is the engine's scratch
block: unused table entries point at it, and ``lengths`` masks whatever it
holds.  A tensor on the CPU takes the plain version
(``ref.paged_decode_attention_ref``); a CUDA tensor launches the kernel or
raises.  The dense ``decode_attention`` kernel comes with the fixed-slot
engine.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import paged_decode_attention_ref

MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may opt into on sm_90


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """q (B,H,D); pools (num_blocks, block_size, KV, D) in q's dtype;
    block_tables (B,T) int32; lengths (B,) int32 -> (B,H,D) in q's dtype.

    Lengths above ``T * block_size`` attend to the whole table, as the TPU
    kernel does; every table entry below ``ceil(length / block_size)`` must
    name a block of the pool."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lengths)
    name = "paged_decode_attention"
    _build.check_inputs(name, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
                        block_tables=block_tables, lengths=lengths)
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: q dtype {q.dtype} is not float32/bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: pools must have q's dtype {q.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and lengths must be int32")
    B, H, D = q.shape
    _, bs, KV, Dk = k_pool.shape
    T = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (v_pool.shape != k_pool.shape or Dk != D or H % KV
            or block_tables.shape != (B, T) or lengths.shape != (B,)):
        raise ValueError(
            f"{name}: shapes do not fit: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    lib = _build.library()
    if lib.repro_paged_decode_smem_bytes(H // KV, D) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: G={H // KV}, D={D} needs more shared "
                         "memory than one block has")
    out = torch.empty_like(q)
    err = lib.repro_paged_decode_attention(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, KV, D, bs, T,
        1.0 / math.sqrt(D), _build.stream(q.device))
    _build.check(err, name)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0  # kernel launches since the last reset
