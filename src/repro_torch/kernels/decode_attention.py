"""GQA decode attention, dense and paged: the wrappers of the CUDA kernels
``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu``.

``decode_attention`` replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``: one token per
sequence against a dense cache ``(B, Smax, KV, D)``, split along the cache
axis across thread blocks and combined in a second pass.  bf16 that the
tensor cores take runs on them; f32, and the rest of bf16, run the CUDA-core
split body ``csrc/decode_split.cuh``, which the paged f32 path shares.

``decode_attention(..., return_lse=True)`` also returns each row's
log-sum-exp, which the combine pass writes, and ``merge_partials`` merges
the outputs of ranks that each attended a slice of one cache (the
flash-decode split of a decode cache over the sequence, which XLA writes
into the reference's sharded program): it launches the same combine pass,
the ranks as its splits.

``paged_decode_attention`` replaces
``repro/kernels/decode_attention.py::paged_decode_attention``.  K/V live in
a block pool ``(num_blocks, block_size, KV, D)``; each sequence names its
blocks through a row of ``block_tables``.  Block 0 is the engine's scratch
block: unused table entries point at it, and ``lengths`` masks whatever it
holds.  It is split along the table's positions as the dense kernel is
along the cache axis, and shares its combine pass; f32 pools run the dense
kernel's CUDA-core split body, with the page lookup as the row address.
Every split plan is made from the shapes alone: reading ``lengths`` on the
host would sync every decode step.

A tensor on the CPU takes the plain version (``ref.decode_attention_ref``,
``ref.paged_decode_attention_ref``); a CUDA tensor launches the kernel or
raises.  Neither kernel has a backward, here or in the reference: under
grad mode both wrappers refuse inputs that require grad, on either device.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import (
    NEG_INF,
    decode_attention_ref,
    merge_partials_ref,
    paged_decode_attention_ref,
)

BLOCKS_PER_SM = 2  # paged bf16: split the table until the grid holds this many blocks per SM
# the dense kernel's split plans: (step: chunks are whole multiples of it,
# the fewest steps a chunk takes, blocks per SM the grid aims at).  The
# tensor-core variant: 16-key mma steps, one 64-key tile a block or more,
# one block per SM (chunks of one or two steps filled more SMs at the
# serving shapes and measured slower: scripts/bench_attention.py,
# PERF.md).  The CUDA-core split body (f32, or bf16 the tensor cores do not
# take; csrc/decode_split.cuh): stages of 32 keys (a 16-key tile for each
# of its two key groups), one or more a block, two blocks per SM (chunks
# of 64 keys or more were no faster at gemma-2b's and qwen3-14b's shapes
# and slower at the serving shapes: PERF.md).
TC_PLAN = (16, 4, 1)
CUDA_CORE_PLAN = (32, 1, 2)


def _splits(B: int, KV: int, Smax: int, sms: int, plan: tuple) -> tuple:
    """``(chunk, nsplit)`` of the dense kernel, from the shapes alone: cut
    the cache axis into ``nsplit`` chunks of ``chunk`` positions, a whole
    number of the plan's steps and at least its fewest, as short as still
    gives the grid of ``nsplit * KV * B`` blocks no more than one wave of
    the plan's blocks per SM on ``sms`` SMs."""
    step, min_steps, per_sm = plan
    steps = max(1, -(-Smax // step))
    want = max(1, -(-per_sm * sms // max(1, B * KV)))
    chunk = max(min_steps, -(-steps // min(steps, want))) * step
    return chunk, max(1, -(-Smax // chunk))


def _paged_splits(B: int, KV: int, T: int, bs: int, tile_max: int,
                  sms: int) -> tuple:
    """``(chunk, tile, nsplit)`` for a table of ``T`` pages of ``bs``
    positions: ``nsplit`` chunks of ``chunk`` positions cover ``T * bs``,
    each a whole number of pages and of ``tile``-token tiles (``tile <=
    tile_max``).  Chunks are as long as still gives the grid of ``nsplit *
    KV * B`` blocks ``BLOCKS_PER_SM`` per SM or more, where the table has
    that many pages; otherwise one page each."""
    want = -(-BLOCKS_PER_SM * sms // max(1, B * KV))
    chunk = max(1, T // want) * bs
    if chunk > tile_max:  # whole tiles of tile_max tokens, still whole pages
        step = math.lcm(bs, tile_max)
        chunk = max(step, chunk // step * step)
    return chunk, min(chunk, tile_max), max(1, -(-(T * bs) // chunk))


def _paged_cuda_core_splits(B: int, KV: int, T: int, bs: int, sms: int) -> tuple:
    """``(chunk, nsplit)`` of the paged f32 path (the CUDA-core split body):
    ``CUDA_CORE_PLAN`` over the table's ``T * bs`` positions with pages as
    the step, so a chunk is whole pages and at least as many keys as the
    dense plan's fewest."""
    step, min_steps, per_sm = CUDA_CORE_PLAN
    return _splits(B, KV, T * bs, sms, (bs, -(-step * min_steps // bs), per_sm))


def decode_attention_cost(B: int, H: int, KV: int, D: int, Smax: int, dtype,
                          lengths=None, lse: bool = False) -> _build.Cost:
    """q read and out written (B,H,D), the K and V rows below each length
    read (B,Smax,KV,D), in ``dtype``, and the int32 lengths (and the f32
    log-sum-exps written, with ``lse``); q k and p v, 2 D flops each, a
    valid position and head.  ``lengths`` are the rows' lengths where the
    caller knows them (ints); without them every row reads its whole cache,
    as a count from shapes alone must take it."""
    es = dtype.itemsize
    valid = B * Smax if lengths is None else sum(min(int(n), Smax) for n in lengths)
    return _build.Cost(4 * valid * H * D, 2 * B * H * D * es + 2 * valid * KV * D * es
                       + 4 * B + (4 * B * H if lse else 0))


def merge_partials_cost(n: int, B: int, H: int, D: int, dtype) -> _build.Cost:
    """n partial outputs (n,B,H,D) in ``dtype`` and their f32 log-sum-exps
    read, the (B,H,D) merge written; a multiply and an add an element of
    each partial."""
    es = dtype.itemsize
    return _build.Cost(2 * n * B * H * D, n * B * H * (D * es + 4) + B * H * D * es)


def paged_decode_attention_cost(B: int, H: int, KV: int, D: int, bs: int, T: int,
                                dtype, lengths=None) -> _build.Cost:
    """As ``decode_attention_cost`` over a table of T pages of ``bs``
    positions: the K and V pages each length needs, their table entries
    and the lengths read (every page of every row without ``lengths``)."""
    es = dtype.itemsize
    if lengths is None:
        pages, valid = B * T, B * T * bs
    else:
        used = [min(int(n), T * bs) for n in lengths]
        pages, valid = sum(-(-n // bs) for n in used), sum(used)
    return _build.Cost(4 * valid * H * D, 2 * B * H * D * es
                       + 2 * pages * bs * KV * D * es + 4 * (pages + B))


def _dims(x: torch.Tensor, n: int) -> tuple:
    """The shape of an n-dim tensor, zeros for any other (which the
    wrappers refuse)."""
    return tuple(x.shape) if x.dim() == n else (0,) * n


def _call_cost(q, kv, tables=None, lse: bool = False) -> _build.Cost:
    """A wrapper call's cost from its shapes: dense with ``tables`` None."""
    (B, H, D), (_, s, KV, _) = _dims(q, 3), _dims(kv, 4)
    if tables is None:
        return decode_attention_cost(B, H, KV, D, s, q.dtype, lse=lse)
    return paged_decode_attention_cost(B, H, KV, D, s, _dims(tables, 2)[1], q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, return_lse: bool = False):
    """q (B,H,D); caches (B,Smax,KV,D) in q's dtype; lengths (B,) int32 ->
    (B,H,D) in q's dtype, and with ``return_lse`` each row's log-sum-exp of
    its scaled scores, (B,H) f32 (-1e30 for a row with no valid position).

    Positions below ``min(length, Smax)`` are valid, as in the model's plain
    decode layer: a length above Smax attends to the whole cache, and a
    length of 0 gives 0."""
    name = "decode_attention"
    _build.refuse_grad(name, q=q, k_cache=k_cache, v_cache=v_cache)
    with _build.counted(name, lambda: _call_cost(q, k_cache, lse=return_lse)):
        if _build.on_cpu(name, q=q, k_cache=k_cache, v_cache=v_cache,
                         lengths=lengths):
            return decode_attention_ref(q, k_cache, v_cache, lengths, return_lse)
        _build.check_inputs(name, q.device, q=q, k_cache=k_cache, v_cache=v_cache,
                            lengths=lengths)
        if q.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name}: q dtype {q.dtype} is not float32/bfloat16")
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise TypeError(f"{name}: caches must have q's dtype {q.dtype}")
        if lengths.dtype != torch.int32:
            raise TypeError(f"{name}: lengths must be int32")
        if q.dim() != 3 or k_cache.dim() != 4:
            raise ValueError(f"{name}: q must be (B,H,D) and caches (B,Smax,KV,D)")
        B, H, D = q.shape
        Smax, KV = k_cache.shape[1], k_cache.shape[2]
        if (k_cache.shape != (B, Smax, KV, D) or v_cache.shape != k_cache.shape
                or KV == 0 or H % KV or lengths.shape != (B,)):
            raise ValueError(
                f"{name}: shapes do not fit: q {tuple(q.shape)}, caches "
                f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, lengths "
                f"{tuple(lengths.shape)}")
        lib = _build.library()
        code = _build.DTYPE_CODES[q.dtype]
        tc = lib.repro_decode_attention_tensor_cores(
            code, H // KV, D, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
        chunk, nsplit = _splits(B, KV, Smax, _build.sm_count(q.device.index),
                                TC_PLAN if tc else CUDA_CORE_PLAN)
        if not 0 <= lib.repro_decode_attention_smem_bytes(
                code, H // KV, D, chunk) <= _build.MAX_SMEM_BYTES:
            raise ValueError(f"{name}: G={H // KV}, D={D} needs more shared "
                             "memory than one block has")
        part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                              device=q.device)
        out = torch.empty_like(q)
        lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
               if return_lse else None)
        err = lib.repro_decode_attention(
            q.device.index, code, q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, KV, D,
            Smax, chunk, nsplit, 1.0 / math.sqrt(D), _build.stream(q.device))
        _build.check(err, name)
        decode_attention.launches += 1
        return (out, lse) if return_lse else out


decode_attention.launches = 0  # kernel launches since the last reset
decode_attention.cost = decode_attention_cost


def merge_partials(o, lse):
    """o (n,B,H,D) f32 or bf16, lse (n,B,H) f32: rank r's output and
    log-sum-exp over its slice of the cache (``decode_attention(...,
    return_lse=True)``) -> (B,H,D) in o's dtype, their rank-ordered merge
    (``ref.merge_partials_ref``).  On the card, the combine pass of the
    decode kernels with the ranks as its splits: o_r as a split's
    normalised accumulator, ``m = lse_r``, ``l = 1`` (0 for an empty
    slice), so every rank that merges the same partials gets the same
    bits."""
    name = "merge_partials"
    _build.refuse_grad(name, o=o)
    with _build.counted(name, lambda: merge_partials_cost(*_dims(o, 4), o.dtype)):
        if _build.on_cpu(name, o=o, lse=lse):
            return merge_partials_ref(o, lse)
        _build.check_inputs(name, o.device, o=o, lse=lse)
        if o.dtype not in _build.DTYPE_CODES or lse.dtype != torch.float32:
            raise TypeError(f"{name}: o must be float32/bfloat16 and lse float32, got "
                            f"{o.dtype} and {lse.dtype}")
        if o.dim() != 4 or lse.shape != o.shape[:3]:
            raise ValueError(f"{name}: shapes do not fit: o {tuple(o.shape)}, lse "
                             f"{tuple(lse.shape)}")
        n, B, H, D = o.shape
        # the combine pass's layout: (B, H, splits, D) and (B, H, splits, 2)
        acc = o.permute(1, 2, 0, 3).float().contiguous()
        ml = torch.stack([lse, (lse > NEG_INF).float()], -1).permute(1, 2, 0, 3).contiguous()
        out = torch.empty((B, H, D), dtype=o.dtype, device=o.device)
        err = _build.library().repro_decode_merge(
            o.device.index, _build.DTYPE_CODES[o.dtype], acc.data_ptr(), ml.data_ptr(),
            out.data_ptr(), B, H, D, n, _build.stream(o.device))
        _build.check(err, name)
        merge_partials.launches += 1
        return out


merge_partials.launches = 0  # kernel launches since the last reset
merge_partials.cost = merge_partials_cost


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """q (B,H,D); pools (num_blocks, block_size, KV, D) in q's dtype;
    block_tables (B,T) int32; lengths (B,) int32 -> (B,H,D) in q's dtype.

    Lengths above ``T * block_size`` attend to the whole table, as the TPU
    kernel does; every table entry below ``ceil(length / block_size)`` must
    name a block of the pool."""
    name = "paged_decode_attention"
    _build.refuse_grad(name, q=q, k_pool=k_pool, v_pool=v_pool)
    with _build.counted(name, lambda: _call_cost(q, k_pool, block_tables)):
        if _build.on_cpu(name, q=q, k_pool=k_pool, v_pool=v_pool,
                         block_tables=block_tables, lengths=lengths):
            return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                              lengths)
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
        sms = _build.sm_count(q.device.index)
        if q.dtype == torch.float32:  # the CUDA-core split body (no tiles to plan)
            (chunk, nsplit), tile = _paged_cuda_core_splits(B, KV, T, bs, sms), 0
        else:
            chunk, tile, nsplit = _paged_splits(
                B, KV, T, bs, lib.repro_paged_decode_max_tile(), sms)
        code = _build.DTYPE_CODES[q.dtype]
        if not 0 <= lib.repro_paged_decode_smem_bytes(
                code, H // KV, D, tile, chunk, bs) <= _build.MAX_SMEM_BYTES:
            raise ValueError(f"{name}: G={H // KV}, D={D} needs more shared "
                             "memory than one block has")
        part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                              device=q.device)
        out = torch.empty_like(q)
        err = lib.repro_paged_decode_attention(
            q.device.index, code, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, H, KV, D,
            bs, T, chunk, tile, nsplit, 1.0 / math.sqrt(D),
            _build.stream(q.device))
        _build.check(err, name)
        paged_decode_attention.launches += 1
        return out


paged_decode_attention.launches = 0  # kernel launches since the last reset
paged_decode_attention.cost = paged_decode_attention_cost
