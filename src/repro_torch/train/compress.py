"""Cross-pod gradient compression (int8 + error feedback), ported from
``repro/train/compress.py``.

Pods are pure data-parallel replicas, so the only cross-pod traffic is the
gradient combine; quantizing it to int8 cuts wire bytes 4x against f32.
Per-tensor symmetric int8 quantization with an error-feedback buffer
(residual accumulation): each pod sends its int8 payload and one f32
scale per tensor, and every pod dequantizes and takes the mean locally,
in pod order.  The EF buffer keeps the scheme unbiased over time (Seide et
al. 1-bit SGD; Karimireddy et al. EF-SGD).  EF state is per pod: a leading
pod dim, one entry per pod.

The reference's combine is XLA, not a Pallas kernel, so these are plain
tensor ops.  Rounding is to nearest, ties to even, as ``jnp.round``.
"""

from __future__ import annotations

import torch

from ..convert import map_params, zip_params
from ..sharding.collectives import gather_stack, group_size, ordered_max


def quantize_int8(g: torch.Tensor, amax=None):
    """Symmetric per-tensor int8.  Returns (q int8, scale f32 scalar).
    ``amax``: the tensor's largest magnitude, where ``g`` is a block of it
    (by default ``g``'s own)."""
    g32 = g.float()
    if amax is None:
        amax = g32.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_mean(qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The mean over the leading pod dim of each pod's dequantized payload;
    ``scales`` broadcast against ``qs``."""
    return torch.mean(qs.float() * scales, dim=0)


def _map_pairs(fn, a, b):
    """Two trees shaped like ``a``: the first and the second items of
    ``fn`` on the matching leaves of ``a`` and ``b``."""
    seconds = []

    def first(x, y):
        f, s = fn(x, y)
        seconds.append(s)
        return f

    firsts = zip_params(first, a, b)
    it = iter(seconds)
    return firsts, zip_params(lambda _x, _y: next(it), a, b)


def compressed_mean_over_axis(grads, ef, group, splits=None):
    """The EF-compressed mean over the pods of ``group`` (None for one
    pod): grads/ef are matching trees of this pod's values.  Each leaf
    is corrected by its buffer and quantized; the int8 payloads and the
    scales are all-gathered and the mean is taken locally in pod order.
    ``splits``, if given: per leaf (in ``leaves`` order) the (group, n)
    pairs over which this pod's ranks hold blocks of it, over which the
    largest magnitude is taken, so that each block takes the whole leaf's
    scale.  Returns (mean grads f32, new ef)."""
    n = group_size(group)
    splits = iter(splits) if splits is not None else None

    def one(g, e):
        corrected = g.float() + e
        amax = None
        if splits is not None:
            amax = corrected.abs().max()
            for split_group, k in next(splits):
                amax = ordered_max(amax, split_group, k)
        q, scale = quantize_int8(corrected, amax)
        new_e = corrected - q.float() * scale
        qs = gather_stack(q, group, n)  # int8 on the wire
        ss = gather_stack(scale.reshape(1), group, n)
        return _dequant_mean(qs, ss.reshape((n,) + (1,) * g.dim())), new_e

    return _map_pairs(one, grads, ef)


def init_ef_state(params, num_pods: int):
    """Error-feedback buffers, one per pod (leading pod dim)."""
    return map_params(lambda _k, p: torch.zeros((num_pods, *p.shape),
                                                dtype=torch.float32, device=p.device),
                      params)


def ef_quantize_mean(grads_g, ef):
    """The EF-compressed combine on one device: grads_g / ef are trees
    with a leading pod dim (npods, ...).  Returns (mean grads (no pod
    dim), new ef (pod dim))."""

    def one(g, e):
        corrected = g.float() + e
        amax = corrected.abs().amax(dim=tuple(range(1, corrected.dim())), keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / 127.0  # (npods, 1, 1, ...)
        q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
        new_e = corrected - q.float() * scale
        return _dequant_mean(q, scale), new_e

    return _map_pairs(one, grads_g, ef)
