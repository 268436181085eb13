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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients of ``rmsnorm_ref`` given the output's gradient ``dy``:
    (dx in x's dtype, dscale f32), in f32 statistics.  The reference's
    training path differentiates its plain RMSNorm and has no backward
    kernel; this is that derivative written out."""
    d = x.shape[-1]
    x32, g32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    dscale = (g32 * xhat).reshape(-1, d).sum(dim=0)
    gw = g32 * (1.0 + scale.float())
    dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale


def _attention_scores(q, k, causal: bool):
    """q (B,S,H,D); k (B,S,KV,D) -> f32 scores (B,H,S,S), scaled by
    1/sqrt(D), with the masked entries at -inf."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kf = k.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(D)
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) if causal else torch.ones(
        S, S, dtype=torch.bool, device=q.device)
    return s.masked_fill(~mask, float("-inf"))


def causal_attention_ref(q, k, v, causal: bool = True):
    """q (B,S,H,D); k,v (B,S,KV,D) -> (B,S,H,D).  Plain masked softmax
    attention with KV head h // G for query head h.  The reference's
    sliding-window mode comes with local attention."""
    s = _attention_scores(q, k, causal)
    G = q.shape[2] // k.shape[2]
    vf = v.repeat_interleave(G, dim=2).float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def attention_lse_ref(q, k, causal: bool = True):
    """The log-sum-exp of each query row's scaled, masked scores: (B,S,H)
    f32, what ``flash_attention(..., return_lse=True)`` returns beside its
    output."""
    s = _attention_scores(q, k, causal)
    return torch.logsumexp(s, dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = True):
    """The gradients of causal GQA attention from the forward's ``out`` and
    ``lse`` (B,S,H) and the output's gradient ``do``: (dq (B,S,H,D) in q's
    dtype, dk, dv (B,S,KV,D) in k's and v's).  Quadratic, in f32: with
    ``p = exp(s - lse)`` and ``delta = rowsum(do * out)``, ``ds = p * (do
    v^T - delta) * scale``, ``dq = ds k`` and dk, dv summed over each KV
    head's G query heads.  What the reference's two backward passes
    compute (``repro/kernels/flash_attention.py::flash_attention_bwd``)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf = k.repeat_interleave(G, dim=2).float()
    vf = v.repeat_interleave(G, dim=2).float()
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)  # (B,H,S)
    s = _attention_scores(q, k, causal)  # masked entries -inf: p = 0 there
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, S, KV, G, D).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, S, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
