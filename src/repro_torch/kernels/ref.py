"""Plain PyTorch versions of the port's kernels.

Deliberately the simplest correct statements (quadratic attention with
explicit masks, no blocking, no online softmax), so a kernel bug cannot
hide in shared structure.  Ported from ``repro/kernels/ref.py``.  The
kernel wrappers run these for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernels against them.
"""

from __future__ import annotations

import math

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x (..., d); scale (d,) stored as a delta from 1.  f32 statistics,
    output in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q (B,H,D); caches (B,Smax,KV,D); lengths (B,) -> (B,H,D).

    A row with length 0 gives 0, as the decode kernels do
    (``acc / max(l, 1e-30)`` with ``acc == 0``); a plain softmax over an
    all-masked row would give NaN there."""
    B, H, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kf = k_cache.repeat_interleave(G, dim=2).float()
    vf = v_cache.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(D)
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, :]
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))
    return torch.einsum("bhk,bkhd->bhd", p, vf).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths):
    """q (B,H,D); pools (N,bs,KV,D); block_tables (B,T); lengths (B,).

    Gathers each sequence's blocks into a contiguous cache and defers to
    the dense version: the simplest statement of what paging must equal.
    """
    B = q.shape[0]
    _, _, KV, D = k_pool.shape
    tab = block_tables.long()
    kc = k_pool[tab].reshape(B, -1, KV, D)
    vc = v_pool[tab].reshape(B, -1, KV, D)
    return decode_attention_ref(q, kc, vc, lengths)
