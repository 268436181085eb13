"""Causal GQA flash attention: the wrappers of the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward), and ``flash_attention_train``, the differentiable function made
of the two.

They replace the Pallas TPU kernels ``flash_attention``,
``flash_attention_bwd`` and the custom VJP ``flash_attention_train`` of
``repro/kernels/flash_attention.py``.  K/V stay compact (``KV`` heads, read
through ``h // G``), any sequence length is taken (the kernels mask the
ragged last tile themselves), head dims up to 256, and a sliding window
(``window`` > 0, the local attention of recurrentgemma) in both.  A
tensor on the CPU takes the plain version (``ref.causal_attention_ref``,
``ref.attention_lse_ref``, ``ref.flash_attention_bwd_ref``); a CUDA tensor
launches the kernel or raises.  ``route`` names the variant a call takes:
bf16 on the tensor cores, the f32 backward on the tensor cores as split
TF32 (its scores on the CUDA cores, the forward's bits), or the CUDA-core
kernels for the rest, the f32 forward among them (its scores must round as
plain f32's do, ``csrc/flash_attention.cu``).
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .ref import attention_lse_ref, causal_attention_ref, flash_attention_bwd_ref


ROWS = 64  # (position, head) rows of a query tile in the kernels
# the variants, by the code repro_flash_attention_route returns
ROUTES = ("cuda-cores", "bf16-tensor-cores", "f32-tensor-cores")


def _dkv_splits(B: int, S: int, H: int, KV: int, key_tile: int,
                sms: int, window: int = 0, paired: bool = False) -> int:
    """How many query ranges a tensor-core dk/dv pass (bf16: 64-key tiles;
    f32: 32) cuts each key tile's work into: as many as keep its ``ceil(S /
    key_tile) * B * KV * nsplit`` blocks within one wave of the card's SMs
    (one block per SM, for its shared memory; ``paired``: the f32 pass,
    whose blocks each take two key tiles, i and n - 1 - i), at least 1 and
    at most the query tiles of the first key tile (``S * G / ROWS``,
    rounded up, for every head chunk; with a window, those of the
    ``key_tile + window - 1`` queries that see a key of the tile).  The
    splits' f32 partials are summed in order by the kernel's last pass."""
    G = H // KV
    gc = min(G, ROWS)
    span = min(S, key_tile + window - 1) if window > 0 else S
    tiles = -(-G // gc) * -(-span // (ROWS // gc))
    key_tiles = -(-S // key_tile)
    blocks = (-(-key_tiles // 2) if paired else key_tiles) * B * KV
    return max(1, min(sms // max(1, blocks), tiles))


@functools.lru_cache(maxsize=64)
def _dq_splits(B: int, S: int, H: int, KV: int, key_tile: int, sms: int,
               causal: bool = True, window: int = 0) -> int:
    """How many key ranges the f32 tensor-core dq pass cuts each query
    tile's key tiles into (1, 2 or 4).  Under causal masking a q tile's key
    tiles grow with its position, so with one block per q tile the heaviest
    block walks about twice the mean work of an SM (one block an SM, for
    its shared memory); the ranges bring the heaviest block near that mean.
    Their f32 partials are summed in order by a last pass."""
    G = H // KV
    gc = min(G, ROWS)
    bq = ROWS // gc
    heaviest = total = 0
    for q0 in range(0, S, bq):
        end = min(S, q0 + bq) if causal else S
        first = max(0, q0 - window + 1) // key_tile if window > 0 else 0
        n = -(-end // key_tile) - first
        heaviest, total = max(heaviest, n), total + n
    per_sm = total * B * KV * -(-G // gc) / sms
    return max(1, min(4, heaviest, int(heaviest / max(per_sm, 1e-9) + 0.5)))


def _check_shapes(name: str, q, k, v) -> tuple:
    """(B, S, H, KV, D) of CUDA inputs the kernels take; raises otherwise."""
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
    limit = _build.library().repro_flash_attention_max_head_dim()
    if not 0 < D <= limit:
        raise ValueError(f"{name}: head dim {D} is outside 1..{limit}")
    return B, S, H, KV, D


def route(q, k, v, do=None, *, backward: bool = False) -> str:
    """The variant ``flash_attention(q, k, v)`` takes on these inputs, or
    with ``backward`` the variant ``flash_attention_bwd(q, k, v, out, lse,
    do)`` takes: "plain" for CPU tensors, else one of ``ROUTES`` (the C
    entries' own rule: bf16 with D a multiple of 16 goes to the tensor
    cores, and in the backward f32 with D a multiple of 8, each up to D 256
    on rows that start on 16-byte boundaries; the CUDA-core kernels take
    the rest).  ``do`` (the backward's) counts in the alignment only."""
    if backward and do is None:
        raise ValueError("route: the backward's route needs its do")
    tensors = dict(q=q, k=k, v=v) if do is None else dict(q=q, k=k, v=v, do=do)
    if _build.on_cpu("route", **tensors):
        return "plain"
    code = _build.library().repro_flash_attention_route(
        _build.DTYPE_CODES[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if do is None else do.data_ptr(), int(backward))
    return ROUTES[code]


def attention_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs that attention over S positions computes:
    causal, within ``window`` if > 0 (query i sees keys j with i - window <
    j); the masked rest is not work."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    if causal:
        return window * (window + 1) // 2 + (S - window) * window
    return S * S - (S - window) * (S - window + 1) // 2


def flash_attention_cost(B: int, S: int, H: int, KV: int, D: int, dtype, *,
                         causal: bool = True, window: int = 0,
                         lse: bool = False) -> _build.Cost:
    """q read and out written (B,S,H,D), k, v read (B,S,KV,D), in
    ``dtype``, and the f32 lse (B,S,H) written with ``lse``; q k^T and P v,
    2 D flops each, over the pairs the mask leaves."""
    es = dtype.itemsize
    nbytes = (2 * B * S * H + 2 * B * S * KV) * D * es + (4 * B * S * H if lse else 0)
    return _build.Cost(4 * B * H * D * attention_pairs(S, causal, window), nbytes)


def flash_attention_bwd_cost(B: int, S: int, H: int, KV: int, D: int, dtype, *,
                             causal: bool = True, window: int = 0) -> _build.Cost:
    """q, out, do, k, v and the f32 lse read, dq, dk, dv written; five
    products of 2 D flops each (the scores again, dP, dV, dQ, dK) over the
    forward's pairs.  ``delta = rowsum(do * out)``, which the wrapper takes
    outside the kernel, is not counted."""
    es = dtype.itemsize
    q, kv = B * S * H * D, B * S * KV * D
    nbytes = (3 * q + 2 * kv) * es + 4 * B * S * H + (q + 2 * kv) * es
    return _build.Cost(10 * B * H * D * attention_pairs(S, causal, window), nbytes)


def _cost_args(q, k) -> tuple:
    """(B, S, H, KV, D, dtype) of 4-dim q, k (zeros where they are not)."""
    if q.dim() != 4 or k.dim() != 4:
        return 0, 0, 0, 0, 0, q.dtype
    return (*q.shape[:3], k.shape[2], q.shape[3], q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, return_lse: bool = False,
                    window: int = 0):
    """q (B,S,H,D); k, v (B,S,KV,D), all in one dtype -> out (B,S,H,D) in
    that dtype [, lse (B,S,H) f32].  ``window`` > 0: query i sees keys j
    with i - window < j only."""
    name = "flash_attention"
    if window < 0:
        raise ValueError(f"{name}: window {window} is negative")
    with _build.counted(name, lambda: flash_attention_cost(
            *_cost_args(q, k), causal=causal, window=window, lse=return_lse)):
        if _build.on_cpu(name, q=q, k=k, v=v):
            out = causal_attention_ref(q, k, v, causal, window)
            return ((out, attention_lse_ref(q, k, causal, window)) if return_lse
                    else out)
        _build.check_inputs(name, q.device, q=q, k=k, v=v)
        B, S, H, KV, D = _check_shapes(name, q, k, v)
        out = torch.empty_like(q)
        lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
               if return_lse else None)
        err = _build.library().repro_flash_attention(
            q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, S, H, KV, D, int(causal), int(window), 1.0 / math.sqrt(D),
            _build.stream(q.device))
        _build.check(err, name)
        flash_attention.launches += 1
        return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches since the count was last reset
flash_attention.cost = flash_attention_cost


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0):
    """The backward of ``flash_attention``: q, out, do (B,S,H,D) and k, v
    (B,S,KV,D) in one dtype, lse (B,S,H) f32 from the forward, and the
    forward's ``window`` -> (dq in q's dtype, dk, dv in k's).  ``delta =
    rowsum(do * out)`` is taken in f32 here, as the reference takes it
    outside its kernels; the kernel's
    passes then write dq and the group-summed dk, dv, deterministically
    (on the tensor cores the dk/dv pass may be cut into query ranges, and
    in f32 the dq pass into key ranges, whose f32 partials a last pass sums
    in order: ``_dkv_splits``, ``_dq_splits``)."""
    name = "flash_attention_bwd"
    if window < 0:
        raise ValueError(f"{name}: window {window} is negative")
    with _build.counted(name, lambda: flash_attention_bwd_cost(
            *_cost_args(q, k), causal=causal, window=window)):
        if _build.on_cpu(name, q=q, k=k, v=v, out=out, lse=lse, do=do):
            return flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
        _build.check_inputs(name, q.device, q=q, k=k, v=v, out=out, lse=lse, do=do)
        B, S, H, KV, D = _check_shapes(name, q, k, v)
        if out.shape != q.shape or do.shape != q.shape:
            raise ValueError(f"{name}: out {tuple(out.shape)} and do "
                             f"{tuple(do.shape)} must have q's shape {tuple(q.shape)}")
        if out.dtype != q.dtype or do.dtype != q.dtype:
            raise TypeError(f"{name}: out and do must have q's dtype {q.dtype}")
        if lse.shape != (B, S, H) or lse.dtype != torch.float32:
            raise ValueError(f"{name}: lse must be float32 of shape {(B, S, H)}, "
                             f"got {lse.dtype} {tuple(lse.shape)}")
        delta = (do.float() * out.float()).sum(dim=-1)  # (B,S,H) f32
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        lib = _build.library()
        sms = _build.sm_count(q.device.index)
        nsplit, part, nsplit_dq, part_dq = 1, None, 1, None
        variant = route(q, k, v, do, backward=True)
        if variant == "bf16-tensor-cores":
            nsplit = _dkv_splits(B, S, H, KV, lib.repro_flash_attention_bwd_key_tile(), sms,
                                 window)
        elif variant == "f32-tensor-cores":
            tile = lib.repro_flash_attention_bwd_f32_key_tile()
            nsplit = _dkv_splits(B, S, H, KV, tile, sms, window, paired=True)
            nsplit_dq = _dq_splits(B, S, H, KV, tile, sms, causal, window)
            if nsplit_dq > 1:  # f32 partial dq of each key range
                part_dq = torch.empty((nsplit_dq, B, S, H, D), dtype=torch.float32,
                                      device=q.device)
        if nsplit > 1:  # f32 partial dk, dv of each split
            part = torch.empty((2, nsplit, B, S, KV, D), dtype=torch.float32,
                               device=q.device)
        err = lib.repro_flash_attention_bwd(
            q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), nsplit,
            None if part_dq is None else part_dq.data_ptr(), nsplit_dq, B, S, H, KV, D,
            int(causal), int(window), 1.0 / math.sqrt(D), _build.stream(q.device))
        _build.check(err, name)
        flash_attention_bwd.launches += 1
        return dq, dk, dv


flash_attention_bwd.launches = 0  # calls that launched the kernel's two passes
flash_attention_bwd.cost = flash_attention_bwd_cost


class _FlashAttentionTrain(torch.autograd.Function):
    """Forward: the flash kernel with its LSE; backward: the flash backward
    kernel on the saved (q, k, v, out, lse), with the forward's window."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True,
                                   window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, causal: bool = True, window: int = 0):
    """Differentiable flash attention: ``flash_attention`` forward, the
    backward kernel in backward, both with the sliding ``window`` when it is
    > 0 (local attention).  q (B,S,H,D); k, v (B,S,KV,D) -> (B,S,H,D)."""
    return _FlashAttentionTrain.apply(q, k, v, causal, window)
