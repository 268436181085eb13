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
is an XLA formulation of the same function, chunked so that XLA never
builds an S x S score matrix; it is not ported, because the kernel and its
plain version take its place.  Its exact-causal option,
``tree_causal_attention`` (``ModelOptions.tree_attention``), is the plain
path's option here: the kernel already walks each query only up to the
diagonal.  ``local_band_attention`` is the reference's band decomposition of local
attention, the plain path of local layers.  ``decode_attention`` here is
the plain decode layer, which the paged engine's gather path and
``impl="plain"`` run.  ``seq_split_decode_attention`` is decode over a
cache whose positions a model group splits: each rank attends its slice,
and the partial outputs are merged by their log-sum-exps in rank order
(``kernels.merge_partials``).

Under sequence parallelism (``sharding.ctx.stream_group``) the residual
stream holds this rank's positions: ``block_in`` gives a block its whole
sequence and ``block_out`` gives back the rank's positions of its output,
and ``stream_leaf`` passes a replicated leaf that the rank reads on its
positions only (a norm's scale), whose gradient is then a part of the
whole one.
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
from ..sharding.collectives import (
    all_to_all,
    copy_to_model,
    gather_over_model,
    gather_stack,
    gather_whole_over_model,
    scatter_sum_over_model,
    split_over_model,
    sum_over_model,
)
from ..sharding.ctx import stream_group

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


# ------------------------------------------------------ sequence parallelism


def block_in(x: torch.Tensor, group=None, n: int = 1) -> torch.Tensor:
    """A block's input (B,S,...) from the residual stream, for a block
    whose leaves a model ``group`` of n ranks splits (column-parallel in)
    or, with ``group`` None, whole.  With the stream whole:
    ``copy_to_model`` (the ranks' gradients summed, where split).  With the
    stream split over the sequence (``stream_group``): the whole sequence,
    gathered, whose gradient is this rank's block of the ranks' partial
    gradients summed (``gather_over_model``) for a split block, or of the
    whole gradient that every rank computes alike for a whole block
    (``gather_whole_over_model``)."""
    sg, sn, sidx = stream_group()
    if sg is None:
        return copy_to_model(x, group, n)
    if group is None:
        return gather_whole_over_model(x, sg, sn, sidx, 1)
    return gather_over_model(x, group, n, 1)


def block_out(y: torch.Tensor, group=None, n: int = 1) -> torch.Tensor:
    """A block's output to the residual stream, as ``block_in`` took its
    input: the ranks' partials (row-parallel) summed in rank order, over
    the whole sequence (``sum_over_model``) or as this rank's positions of
    the sum (``scatter_sum_over_model``); a whole block's output as it is,
    or its rank's positions (``split_over_model``)."""
    sg, sn, sidx = stream_group()
    if sg is None:
        return sum_over_model(y, group, n)
    if group is None:
        return split_over_model(y, sg, sn, sidx, 1)
    return scatter_sum_over_model(y, group, n, 1)


def stream_leaf(leaf: torch.Tensor) -> torch.Tensor:
    """A replicated leaf read on the residual stream (a norm's scale):
    where the stream holds this rank's positions, each rank computes only
    their part of its gradient, so the parts are summed over the model
    group in rank order (``copy_to_model``); otherwise the leaf itself."""
    sg, sn, _ = stream_group()
    return copy_to_model(leaf, sg, sn)


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


def _online_update(m, l, acc, scores, v_blk):
    """One online-softmax step: scores (..., q, k) f32, already masked;
    v_blk (..., k, D) broadcasting against the scores' leading dims; m, l
    (..., q) and acc (..., q, D) f32."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + p @ v_blk.float()
    return m_new, l_new, acc_new


def tree_causal_attention(q, k, v, chunk: int = 512) -> torch.Tensor:
    """The reference's binary-tree causal decomposition, exact: masked
    diagonal blocks of ``min(chunk, S)`` queries, then log2(S / chunk)
    levels of unmasked cross attention (the top half of every span of
    chunks attends its bottom half), merged by online softmax.  q
    (B,S,H,D); compact k, v (B,S,KV,D).  Its scores number S chunk (the
    diagonal blocks) + S^2 / 2 - S chunk / 2 (the levels), which the
    reference's docstring rounds to S chunk + S^2 / 2; the chunk must
    divide S into a power of two of chunks (the reference asserts the
    first, and its halving levels need the second)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    c = min(chunk, S)
    nc = S // c
    if S % c or nc & (nc - 1):
        raise ValueError(f"tree attention: chunks of {c} do not split the sequence {S} "
                         "into a power of two of chunks")
    scale = 1.0 / math.sqrt(D)
    qs, ks, vs = (x.reshape(B, nc, c, H, D).float() for x in (q, k, v))
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qs, ks) * scale
    diag = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    s = torch.where(diag, s, torch.full((), NEG_INF, device=q.device))
    m = torch.full((B, nc, H, c), NEG_INF, device=q.device)
    l = torch.zeros((B, nc, H, c), device=q.device)
    acc = torch.zeros((B, nc, H, c, D), device=q.device)
    m, l, acc = _online_update(m, l, acc, s, vs.transpose(2, 3))
    span = 2
    while span <= nc:
        ns, half = nc // span, span // 2
        q_top = qs.reshape(B, ns, span, c, H, D)[:, :, half:]
        k_bot, v_bot = (x.reshape(B, ns, span, c, H, D)[:, :, :half].reshape(
            B, ns, half * c, H, D) for x in (ks, vs))
        s = torch.einsum("bntqhd,bnkhd->bnthqk", q_top, k_bot) * scale
        m_s, l_s = m.view(B, ns, span, H, c), l.view(B, ns, span, H, c)
        a_s = acc.view(B, ns, span, H, c, D)
        top = _online_update(m_s[:, :, half:], l_s[:, :, half:], a_s[:, :, half:], s,
                             v_bot.transpose(2, 3)[:, :, None])
        m, l, acc = (torch.cat([x[:, :, :half], t], dim=2).reshape(y.shape)
                     for x, t, y in zip((m_s, l_s, a_s), top, (m, l, acc)))
        span *= 2
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(2, 3).reshape(B, S, H, D).to(q.dtype)


def causal_attention(q, k, v, impl: str = "kernel", window: int = 0,
                     tree_chunk: int = 0) -> torch.Tensor:
    """Causal attention over a full sequence: q (B,S,H,D), compact k, v
    (B,S,KV,D) -> (B,S,H,D), through the flash kernels (``impl="kernel"``:
    the forward kernel, and the backward kernel when differentiated) or
    their plain version (``"plain"``).  ``window`` > 0 is local attention:
    the windowed flash forward, or ``local_band_attention``.  ``tree_chunk``
    > 0 makes the plain path of global attention the reference's
    ``tree_causal_attention`` in chunks of it; the kernel, which already
    does only the causal work, takes no option."""
    if impl == "plain":
        if window:
            return local_band_attention(q, k, v, window)
        if tree_chunk:
            return tree_causal_attention(q, k, v, tree_chunk)
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
    products are summed over the group in rank order and rounded once.
    Where the stream holds this rank's positions, x (B,S,d) is them, and so
    is the output (``block_in``, ``block_out``)."""
    dt = x.dtype
    y = mlp_partial(params, block_in(x, group, n), act, gated, group is not None)
    return block_out(y, group, n).to(dt)


def mlp_partial(params: dict, x: torch.Tensor, act: str, gated: bool,
                partial: bool) -> torch.Tensor:
    """The MLP's product on x in its dtype, or, where ``partial`` (the
    leaves a rank's columns and rows), this rank's f32 partial of it."""
    dt = x.dtype
    u = matmul_f32(x, params["w_up"].to(dt))
    if gated:
        g = matmul_f32(x, params["w_gate"].to(dt))
        h = (act_fn(act)(g) * u).to(dt)
    else:
        h = act_fn(act)(u).to(dt)
    if not partial:
        return h @ params["w_down"].to(dt)
    return matmul_f32(h, params["w_down"].to(dt))


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
