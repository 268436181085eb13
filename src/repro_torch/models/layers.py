"""Shared model layers: norms, RoPE, attention, MLPs.

Ported from ``repro/models/layers.py``.  Parameters are plain nested dicts
of tensors; compute runs in the compute dtype with f32 accumulation where
the reference asks for it (``preferred_element_type=float32``).  Where the
reference annotates activations for XLA's partitioner, the MLP takes the
tensor-parallel group explicitly (``mlp_apply``).

Attention goes to the CUDA kernels: full-sequence causal attention to
``kernels.flash_attention_train`` (the flash forward kernel, and its
backward kernel under autograd; local attention to the same forward kernel
with a window) and decode over a dense cache or a local layer's ring buffer
to ``kernels.decode_attention`` (``causal_attention`` and
``cached_decode_attention`` below; ``impl="plain"`` picks their plain
versions on any device).  The reference's ``blockwise_causal_attention``
and ``tree_causal_attention`` are XLA formulations of the same function,
chunked so that XLA never builds an S x S score matrix; they are not
ported, because the kernel and its plain version take their place.
``local_band_attention`` is the reference's band decomposition of local
attention, the plain path of local layers.  ``decode_attention`` here is
the plain decode layer, which the paged engine's gather path and
``impl="plain"`` run.  ``seq_split_decode_attention`` is decode over a
cache whose positions a model group splits: each rank attends its slice,
and the partial outputs are merged by their log-sum-exps in rank order
(``kernels.merge_partials``).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels import decode_attention as decode_attention_kernel
from ..kernels import flash_attention_train, merge_partials
from ..kernels import rmsnorm as rmsnorm_kernel
from ..kernels.ref import causal_attention_ref, decode_attention_ref, merge_partials_ref
from ..sharding.collectives import all_to_all, copy_to_model, gather_stack, sum_over_model

NEG_INF = -1e30
ATTN_IMPLS = ("kernel", "plain")


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` (``torch.bmm`` for 3-D
    operands) with a backward: that call has no derivative of its own.  The
    gradients are two products in the operands' dtype, as the reference's
    transposed dots come out."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.mT if ctx.needs_input_grad[0] else None
        db = a.mT @ g if ctx.needs_input_grad[1] else None
        return da, db


def _card_path(a: torch.Tensor) -> bool:
    """Whether the products take the card's path: on CUDA tensors, and in a
    dry-run (``kernels._build.shapes_only``), which counts the card's ops
    on fake CPU tensors."""
    return a.is_cuda or _build.shapes_only()


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D ``b``, accumulated and returned in f32: the
    reference's ``preferred_element_type=jnp.float32``.  bf16 operands on the
    card keep their width (no f32 copy of a weight); on the CPU they are
    widened first.  f32 or f64 operands of one dtype multiply as they are."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return a @ b
    if _card_path(a):
        lead = a.shape[:-1]
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*lead, b.shape[-1])
    return a.float() @ b.float()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 3-D ``a`` (G,M,K) and ``b`` (G,K,N), accumulated and
    returned in f32, as ``matmul_f32``."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return torch.bmm(a, b)
    if _card_path(a):
        return _MatmulF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


# --------------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The RMSNorm kernel at a norm site: f32 statistics, ``(1 + scale)``."""
    return rmsnorm_kernel(x.contiguous(), scale.float(), eps)


def init_rmsnorm(d: int, device) -> dict:
    # stored as deltas from 1.0 (gemma convention); init 0 == unit scale
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------- rope


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> (sin, cos) each (..., head_dim/2) f32."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x (..., H, D); sin/cos (..., D/2): rotate the two halves in f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    sin = sin[..., None, :].float()
    cos = cos[..., None, :].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention


def decode_attention(q, k_cache, v_cache, lengths, window: int = 0) -> torch.Tensor:
    """Single-token attention against a cache, the plain path.

    q (B,H,D); caches (B,Smax,KV,D); lengths (B,) = tokens written.
    ``window`` > 0 marks a local layer's ring buffer: slot p holds a token
    when p < length (not yet wrapped) or always (wrapped).
    """
    B, H, D = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(D)
    valid = torch.arange(Smax, device=q.device)[None, :] < lengths[:, None]
    if window:
        valid = valid | (lengths[:, None] >= Smax)
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF,
                                                           device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def local_band_attention(q, k, v, window: int) -> torch.Tensor:
    """Sliding-window causal attention in O(S * window): the reference's
    band decomposition.  q (B,S,H,D); compact k, v (B,S,KV,D).  Chunks of
    ``min(window, S)`` queries (which must divide S) each attend their own
    chunk and the one before, masked to ``0 <= qpos - kpos < window``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    c = min(window, S)
    if S % c:
        raise ValueError(f"local attention: the window chunk {c} does not "
                         f"divide the sequence {S}")
    nc = S // c
    qs, ks, vs = (x.reshape(B, nc, c, H, D) for x in (q, k, v))
    kcat = torch.cat([torch.roll(ks, 1, dims=1), ks], dim=2)  # (B,nc,2c,H,D)
    vcat = torch.cat([torch.roll(vs, 1, dims=1), vs], dim=2)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qs.float(), kcat.float()) * (1.0 / math.sqrt(D))
    a = torch.arange(c, device=q.device)
    b = torch.arange(2 * c, device=q.device)
    rel = (a[:, None] + c) - b[None, :]  # qpos - kpos in the 2c frame
    base = (rel >= 0) & (rel < window)  # (c, 2c)
    mask = base[None].expand(nc, c, 2 * c).clone()
    mask[0] &= (b >= c)[None, :]  # the first chunk has no chunk before it
    s = torch.where(mask[None, :, None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnhqk,bnkhd->bnhqd", p, vcat.float())  # (B,nc,H,c,D)
    return out.permute(0, 1, 3, 2, 4).reshape(B, S, H, D).to(q.dtype)


def causal_attention(q, k, v, impl: str = "kernel",
                     window: int = 0) -> torch.Tensor:
    """Causal attention over a full sequence: q (B,S,H,D), compact k, v
    (B,S,KV,D) -> (B,S,H,D), through the flash kernels (``impl="kernel"``:
    the forward kernel, and the backward kernel when differentiated) or
    their plain version (``"plain"``).  ``window`` > 0 is local attention:
    the windowed flash forward, or ``local_band_attention``."""
    if impl == "plain":
        if window:
            return local_band_attention(q, k, v, window)
        return causal_attention_ref(q, k, v)
    return flash_attention_train(q.contiguous(), k.contiguous(), v.contiguous(),
                                 window=window)


def cached_decode_attention(q, k_cache, v_cache, lengths, impl: str = "kernel",
                            window: int = 0, return_lse: bool = False):
    """One token per row against a dense cache, positions below
    ``min(lengths, Smax)`` valid: the dense decode kernel
    (``impl="kernel"``) or the plain layer ``decode_attention``.  A local
    layer's ring buffer (``window`` > 0) takes the same kernel: its valid
    slots are those below ``min(lengths, Smax)`` too, and the softmax does
    not depend on the order of the slots.  ``return_lse``: also each row's
    log-sum-exp (B,H) f32, from the kernel or from its plain version
    ``decode_attention_ref``."""
    if impl == "plain":
        if return_lse:
            return decode_attention_ref(q, k_cache, v_cache, lengths, return_lse=True)
        return decode_attention(q, k_cache, v_cache, lengths, window)
    return decode_attention_kernel(q.contiguous(), k_cache, v_cache,
                                   lengths.to(torch.int32), return_lse)


def seq_split_decode_attention(q, k_slice, v_slice, lengths, positions: int, group,
                               n: int, idx: int, impl: str = "kernel",
                               heads_split: bool = False) -> torch.Tensor:
    """One token per row against rank ``idx``'s slice of a cache whose
    ``positions`` a model group of n ranks splits (flash-decode, split-K
    over the cache sequence): it holds positions (or a ring buffer's slots)
    [idx P / n, (idx + 1) P / n) of P, and positions below
    ``min(lengths, P)`` are valid.  q: this rank's query heads (B,H,D),
    every head unless ``heads_split``; slices (B, P / n, KV, D) with every
    KV head.  Returns (B,H,D) in q's dtype.

    The rank attends over its slice with local lengths ``clamp(min(lengths,
    P) - idx P / n, 0, P / n)``, keeping each row's log-sum-exp; a slice
    with no valid position gives 0 and weighs nothing.  Heads whole: every
    rank gathers every rank's (output, log-sum-exp) and merges them in rank
    order, so every rank holds the same bits.  Heads split: the ranks'
    query heads are gathered first, each rank attends all of them over its
    slice and sends each rank its heads' partials (an all-to-all), which
    that rank merges.  The partials travel as f32, their collectives
    counted under ``merge_partials``."""
    B, H, D = q.shape
    size = k_slice.shape[1]
    local = torch.clamp(torch.clamp(lengths, max=positions) - idx * size, 0, size)
    if heads_split:  # (n, B, H, D) -> (B, n H, D): every head, in order
        q = gather_stack(q, group, n).permute(1, 0, 2, 3).reshape(B, n * H, D)
    o, lse = cached_decode_attention(q, k_slice, v_slice, local, impl, return_lse=True)
    part = torch.cat([o.to(lse.dtype), lse[..., None]], dim=-1)
    if heads_split:  # block j (rank j's heads) to rank j
        part = all_to_all(part.view(B, n, H, D + 1).transpose(0, 1).contiguous(), group, n,
                          "merge_partials")
    else:
        part = gather_stack(part, group, n, "merge_partials")
    merge = merge_partials if impl == "kernel" else merge_partials_ref
    return merge(part[..., :D].contiguous(), part[..., D].contiguous()).to(q.dtype)


# ----------------------------------------------------------------------- mlp


def act_fn(name: str):
    return {"silu": F.silu, "gelu": partial(F.gelu, approximate="tanh")}[name]


def mlp_apply(params: dict, x: torch.Tensor, act: str, gated: bool,
              group=None, n: int = 1) -> torch.Tensor:
    """The MLP on x (..., d) in its dtype.  With a model ``group`` of n
    ranks, ``params`` hold this rank's columns of ``w_up``/``w_gate`` and
    rows of ``w_down`` (column- then row-parallel): the f32 partial
    products are summed over the group in rank order and rounded once."""
    dt = x.dtype
    x = copy_to_model(x, group, n)
    u = matmul_f32(x, params["w_up"].to(dt))
    if gated:
        g = matmul_f32(x, params["w_gate"].to(dt))
        h = (act_fn(act)(g) * u).to(dt)
    else:
        h = act_fn(act)(u).to(dt)
    if group is None:
        return h @ params["w_down"].to(dt)
    return sum_over_model(matmul_f32(h, params["w_down"].to(dt)), group, n).to(dt)


def init_mlp(gen: torch.Generator, d: int, d_ff: int, gated: bool,
             out_scale: float = 1.0) -> dict:
    p = {
        "w_up": dense_init(gen, (d, d_ff)),
        "w_down": dense_init(gen, (d_ff, d), scale=out_scale),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (d, d_ff))
    return p


def dense_init(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    """Normal weights with std ``scale / sqrt(shape[-2])``, as the reference
    draws them, on the generator's device."""
    fan_in = max(shape[-2] if len(shape) >= 2 else 1, 1)
    std = scale / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * std
