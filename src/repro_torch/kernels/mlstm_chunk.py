"""Chunkwise stabilized mLSTM: the wrappers of the CUDA kernels
``csrc/mlstm_chunk.cu`` (forward) and ``csrc/mlstm_chunk_bwd.cu``
(backward), and ``mlstm_chunk``, the differentiable function made of the
two.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_chunk.py::mlstm_chunk``,
which computes ``repro/models/recurrent.py::mlstm_chunk_recurrence``.  Unlike
the TPU kernel it can also return the final carry ``(C, n, m)``, so the
prefill runs it too.  The chunk is ``min(chunk, S)`` and must divide S, the
reference's rule.  As in the TPU kernel's wrapper, the forget gate's log
sigmoid is taken here, outside the kernel, so autograd carries the
gradient of ``log_f`` back to ``f_pre``.  Tensors on the CPU take the plain
version (``ref.mlstm_chunk_ref``, differentiated by autograd); CUDA tensors
launch the kernels or raise.  The reference trains through XLA's
derivative of its chunk recurrence; the port's backward kernel is the
gradient with respect to q, k, v, log_i and log_f, walking the chunks in
reverse (its header says how).  The final carry is a prefill's state and
has no backward kernel: asking the kernel for it from inputs that require
grad raises.

The forward runs in two passes on the caller's stream (one call, one count
in ``.launches``): a state pass writes the carry entering every chunk to a
workspace that this wrapper allocates, and an output pass reads it.  The
grids and the workspace come from the shapes alone (``_plan``).  Under
autograd the workspace and each row's denominator stay for the backward,
which reads the carries from it rather than running the recurrence again.
The backward writes dq, dk, dv in q's dtype itself, in six passes on the
grids of ``_bwd_plan`` (five for a single chunk): bf16 inputs on the
tensor cores, f32 inputs on the CUDA cores, both on one scratch the
library sizes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .ref import mlstm_chunk_ref

# as in csrc/mlstm_chunk.cu: a state-pass block holds a STATE_TILE[0] x
# STATE_TILE[1] tile of C (dk rows x value columns); an output-pass block
# writes VALUE_TILE value columns of h for the rows of its row part: bf16
# blocks take a whole chunk, f32 ones (ROW_PARTS of them a chunk and value
# tile) the chunk's 32-row tiles p and 3 - p
STATE_TILE = {torch.bfloat16: (64, 96), torch.float32: (64, 64)}
VALUE_TILE = {torch.bfloat16: 192, torch.float32: 192}
ROW_PARTS = {torch.bfloat16: 1, torch.float32: 2}
# as in csrc/mlstm_chunk_bwd.cu, which refuses another plan: the backward's
# column tile of dk, the rows of a rows-pass block, and the scores pass's
# blocks a chunk
BWD_TILE, BWD_ROW_GROUP, BWD_SCORE_BLOCKS = 64, 16, 4


def _plan(B: int, S: int, H: int, dk: int, c: int, dtype) -> tuple:
    """``(state_tiles, state_e_tiles, value_tiles, workspace_floats)`` for
    chunks of ``c``: the state pass's grid is (B * H, state_tiles,
    state_e_tiles) tiles of C, the output pass's (B * H, S / c,
    value_tiles * ROW_PARTS[dtype]); the workspace holds, for every
    (batch, head, chunk), the carry entering that chunk with dk rounded up
    to 16 (dkp): C (dkp^2 floats: row-major for f32 inputs, in mma fragment
    order for bf16), n (dkp) and m; for f32 inputs then the state pass's
    ticket counter and a flag for every (chunk, batch x head, tile of C),
    as int32 in float slots (its chained scan: one block per chunk and
    tile, grid (S / c) * B * H * state_tiles^2 with the final carry)."""
    dkp = -(-dk // 16) * 16
    rows, cols = STATE_TILE[dtype]
    tiles = -(-dk // rows)
    sync = 1 + B * H * (S // c) * tiles * tiles if dtype == torch.float32 else 0
    return (tiles, -(-dk // cols), -(-dk // VALUE_TILE[dtype]),
            B * H * (S // c) * (dkp * dkp + dkp + 1) + sync)


def _bwd_plan(B: int, S: int, H: int, dk: int, c: int) -> dict:
    """The backward's grids, pass by pass, for chunks of ``c``: rows (B * H,
    S / c, row groups of BWD_ROW_GROUP), moves (B * H, chunks 1 .., dk tiles
    x value tiles of BWD_TILE; none for one chunk), state (B * H, dk tiles,
    value tiles), scores (B * H, S / c, BWD_SCORE_BLOCKS tile pairs), grads
    (B * H, S / c, dq | dk | dv x column tiles), gates (B * H, S / c)."""
    tiles = -(-dk // BWD_TILE)
    return {"rows": (B * H, S // c, -(-c // BWD_ROW_GROUP)),
            "moves": (B * H, S // c - 1, tiles * tiles),
            "state": (B * H, tiles, tiles),
            "scores": (B * H, S // c, BWD_SCORE_BLOCKS),
            "grads": (B * H, S // c, 3 * tiles),
            "gates": (B * H, S // c, 1)}


def mlstm_chunk_flops(B: int, S: int, H: int, dk: int, chunk: int) -> float:
    """The forward's products that the data needs: per chunk and (batch,
    head), q k^T and W v over the lower triangle (2 c (c + 1) dk), q C and
    the C update (4 c dk^2)."""
    c = max(1, min(chunk, S))
    return (S // c) * B * H * (2 * c * (c + 1) * dk + 4 * c * dk * dk)


def mlstm_chunk_cost(B: int, S: int, H: int, dk: int, dtype, *, chunk: int = 128,
                     final: bool = False) -> _build.Cost:
    """q, k, v (B,S,H,dk) in ``dtype`` and the f32 gates (B,S,H) read, h
    (B,S,H,dk) f32 written, and with ``final`` the final carry (C, n, m);
    ``mlstm_chunk_flops`` of work, whose rate follows ``dtype``."""
    n, g = B * S * H * dk, B * S * H
    nbytes = (3 * n * dtype.itemsize + 2 * g * 4 + 4 * n
              + (B * H * (dk * dk + dk + 1) * 4 if final else 0))
    return _build.Cost(mlstm_chunk_flops(B, S, H, dk, chunk), nbytes)


def mlstm_chunk_bwd_flops(B: int, S: int, H: int, dk: int, chunk: int) -> float:
    """The backward's products that the data needs: per chunk and (batch,
    head), five over the lower triangle (S, dh v^T, dS k, dS^T q, W^T dnum:
    5 c (c + 1) dk), three of c dk^2 (C dnum, G v, G^T k: 6 c dk^2) and the
    carry gradient's move (2 c dk^2, all chunks but the first)."""
    c = max(1, min(chunk, S))
    nc = S // c
    return B * H * (nc * (5 * c * (c + 1) * dk + 6 * c * dk * dk)
                    + max(0, nc - 1) * 2 * c * dk * dk)


def mlstm_chunk_bwd_cost(B: int, S: int, H: int, dk: int, dtype, *,
                         chunk: int = 128) -> _build.Cost:
    """q, k, v in ``dtype``, the f32 gates, h, dh, the denominators and the
    forward's carries (its workspace, ``_plan``) read; dq, dk, dv in
    ``dtype`` and the gates' f32 gradients written."""
    n, g = B * S * H * dk, B * S * H
    c = max(1, min(chunk, S))
    ws = _plan(B, S, H, dk, c, dtype if dtype in STATE_TILE else torch.float32)[3]
    es = dtype.itemsize
    nbytes = 6 * n * es + 4 * g * 4 + 2 * n * 4 + g * 4 + ws * 4
    return _build.Cost(mlstm_chunk_bwd_flops(B, S, H, dk, chunk), nbytes)


def _cost_args(q) -> tuple:
    """(B, S, H, dk, dtype) of a 4-dim q (zeros for another)."""
    return (*(q.shape if q.dim() == 4 else (0, 0, 0, 0)), q.dtype)


def _check(name, q, k, v, i_pre, f_pre, chunk: int) -> tuple:
    """(B, S, H, dk, c) of CUDA inputs the kernels take; raises otherwise."""
    _build.check_inputs(name, q.device, q=q, k=k, v=v, i_pre=i_pre,
                        f_pre=f_pre)
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: q dtype {q.dtype} is not float32/bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k and v must have q's dtype {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B,S,H,dk)")
    B, S, H, dk = q.shape
    if (k.shape != q.shape or v.shape != q.shape or i_pre.shape != (B, S, H)
            or f_pre.shape != (B, S, H)):
        raise ValueError(f"{name}: shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
                         f"{tuple(i_pre.shape)}/{tuple(f_pre.shape)}")
    c = min(chunk, S)
    if c <= 0 or S % c:
        raise ValueError(f"{name}: chunk {c} does not divide the sequence {S}")
    lib = _build.library()
    if not 0 < dk <= lib.repro_mlstm_chunk_max_dk():
        raise ValueError(f"{name}: dk {dk} is outside "
                         f"1..{lib.repro_mlstm_chunk_max_dk()}")
    if c > lib.repro_mlstm_chunk_max_chunk():
        raise ValueError(f"{name}: chunk {c} is above "
                         f"{lib.repro_mlstm_chunk_max_chunk()}")
    return B, S, H, dk, c


def mlstm_chunk_fwd(q, k, v, log_i, log_f, *, chunk: int = 128,
                    return_final: bool = False, keep: bool = False):
    """The forward kernel on CUDA tensors: q, k, v (B,S,H,dk) in one dtype
    (f32 or bf16); log_i, log_f (B,S,H) f32 (log_f a log sigmoid) -> h
    (B,S,H,dk) f32, the final carry ``(C (B,H,dk,dk), n (B,H,dk), m (B,H))``
    f32 or None, and with ``keep`` the workspace and each row's denominator
    (B,S,H) for the backward (else None, None)."""
    name = "mlstm_chunk"
    B, S, H, dk, c = _check(name, q, k, v, log_i, log_f, chunk)
    dev = q.device
    h = torch.empty((B, S, H, dk), dtype=torch.float32, device=dev)
    den = (torch.empty((B, S, H), dtype=torch.float32, device=dev) if keep
           else None)
    final = None
    if return_final:
        final = (torch.empty((B, H, dk, dk), dtype=torch.float32, device=dev),
                 torch.empty((B, H, dk), dtype=torch.float32, device=dev),
                 torch.empty((B, H), dtype=torch.float32, device=dev))
    C_ptr, n_ptr, m_ptr = ((None, None, None) if final is None
                           else tuple(t.data_ptr() for t in final))
    state_tiles, state_e_tiles, value_tiles, ws_floats = _plan(B, S, H, dk, c,
                                                               q.dtype)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=dev)
    err = _build.library().repro_mlstm_chunk(
        dev.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), log_i.data_ptr(), log_f.data_ptr(), h.data_ptr(),
        None if den is None else den.data_ptr(), C_ptr, n_ptr, m_ptr,
        ws.data_ptr(), B, S, H, dk, c, state_tiles, state_e_tiles,
        value_tiles, 1.0 / math.sqrt(dk), _build.stream(dev))
    _build.check(err, name)
    mlstm_chunk.launches += 1
    return h, final, (ws, den) if keep else (None, None)


def mlstm_chunk_bwd(q, k, v, log_i, log_f, ws, den, h, dh, *,
                    chunk: int = 128) -> tuple:
    """The backward kernel on CUDA tensors: the forward's inputs (q, k, v,
    log_i, log_f as ``mlstm_chunk_fwd`` took them), its workspace ``ws``,
    denominators ``den`` and output ``h``, and the output's gradient ``dh``
    (B,S,H,dk) f32 -> (dq, dk, dv in q's dtype, written by the kernel;
    dlog_i, dlog_f f32)."""
    name = "mlstm_chunk_bwd"
    with _build.counted(name, lambda: mlstm_chunk_bwd_cost(*_cost_args(q), chunk=chunk)):
        B, S, H, dk, c = _check(name, q, k, v, log_i, log_f, chunk)
        _build.check_inputs(name, q.device, ws=ws, den=den, h=h, dh=dh)
        if dh.shape != h.shape or dh.dtype != torch.float32:
            raise ValueError(f"{name}: dh must be float32 of h's shape "
                             f"{tuple(h.shape)}, got {dh.dtype} {tuple(dh.shape)}")
        dev = q.device
        lib = _build.library()
        grads = [torch.empty((B, S, H, dk), dtype=q.dtype, device=dev)
                 for _ in range(3)]
        dlog = [torch.empty((B, S, H), dtype=torch.float32, device=dev)
                for _ in range(2)]
        code = _build.DTYPE_CODES[q.dtype]
        scratch = torch.empty(lib.repro_mlstm_chunk_bwd_scratch(B, S, H, dk, c),
                              dtype=torch.uint8, device=dev)
        plan = _bwd_plan(B, S, H, dk, c)
        err = lib.repro_mlstm_chunk_bwd(
            dev.index, code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            log_i.data_ptr(), log_f.data_ptr(), ws.data_ptr(), den.data_ptr(),
            h.data_ptr(), dh.data_ptr(), *(t.data_ptr() for t in grads + dlog),
            scratch.data_ptr(), B, S, H, dk, c, plan["state"][1], plan["rows"][2],
            plan["scores"][2], 1.0 / math.sqrt(dk), _build.stream(dev))
        _build.check(err, name)
        mlstm_chunk_bwd.launches += 1
        return (*grads, *dlog)


class _MlstmChunk(torch.autograd.Function):
    """Forward: the chunk kernel, keeping its workspace and denominators;
    backward: the backward kernel on them."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, chunk):
        h, _final, (ws, den) = mlstm_chunk_fwd(q, k, v, log_i, log_f,
                                               chunk=chunk, keep=True)
        ctx.save_for_backward(q, k, v, log_i, log_f, ws, den, h)
        ctx.chunk = chunk
        return h

    @staticmethod
    def backward(ctx, dh):
        q, k, v, log_i, log_f, ws, den, h = ctx.saved_tensors
        grads = mlstm_chunk_bwd(q, k, v, log_i, log_f, ws, den, h,
                                dh.contiguous(), chunk=ctx.chunk)
        return (*grads, None)


class _ShapesOnly(torch.autograd.Function):
    """The dry-run's stand-in (``_build.shapes_only``): h of its shape and
    dtype, and in backward the inputs' gradients, counted as one call of
    the backward kernel, as the card runs it; nothing is computed."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, chunk):
        ctx.chunk, ctx.inputs = chunk, [(x.shape, x.dtype) for x in (q, k, v, i_pre, f_pre)]
        return q.new_empty(q.shape, dtype=torch.float32)

    @staticmethod
    def backward(ctx, dh):
        (shape, dtype), chunk = ctx.inputs[0], ctx.chunk
        with _build.counted("mlstm_chunk_bwd", lambda: mlstm_chunk_bwd_cost(
                *shape, dtype, chunk=chunk)):
            return (*(dh.new_empty(s, dtype=d) for s, d in ctx.inputs), None)


def mlstm_chunk(q, k, v, i_pre, f_pre, *, chunk: int = 128,
                return_final: bool = False):
    """q, k, v (B,S,H,dk) in one dtype (f32 or bf16); i_pre, f_pre (B,S,H)
    -> h (B,S,H,dk) f32 [, (C (B,H,dk,dk), n (B,H,dk), m (B,H)) f32],
    differentiable in all five inputs (h only)."""
    name = "mlstm_chunk"
    with _build.counted(name, lambda: mlstm_chunk_cost(*_cost_args(q), chunk=chunk,
                                                       final=return_final)):
        return _mlstm_chunk(q, k, v, i_pre, f_pre, chunk, return_final)


def _mlstm_chunk(q, k, v, i_pre, f_pre, chunk: int, return_final: bool):
    name = "mlstm_chunk"
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, i_pre, f_pre))
    if _build.on_cpu(name, q=q, k=k, v=v, i_pre=i_pre, f_pre=f_pre):
        if _build.shapes_only():
            h = _ShapesOnly.apply(q, k, v, i_pre, f_pre, chunk)
            if not return_final:
                return h
            B, _, H, dk = q.shape
            return h, (q.new_empty((B, H, dk, dk), dtype=torch.float32),
                       q.new_empty((B, H, dk), dtype=torch.float32),
                       q.new_empty((B, H), dtype=torch.float32))
        return mlstm_chunk_ref(q, k, v, i_pre, f_pre, chunk=chunk,
                               return_final=return_final)
    log_i = i_pre.float().contiguous()
    log_f = F.logsigmoid(f_pre.float()).contiguous()
    if not grad:
        h, final, _ = mlstm_chunk_fwd(q, k, v, log_i, log_f, chunk=chunk,
                                      return_final=return_final)
        return (h, final) if return_final else h
    if return_final:
        raise ValueError(f"{name}: the final carry is a prefill's state and "
                         "has no backward; ask for it under torch.no_grad()")
    return _MlstmChunk.apply(q, k, v, log_i, log_f, chunk)


mlstm_chunk.launches = 0  # forward kernel launches since the count was last reset
mlstm_chunk_bwd.launches = 0  # backward kernel launches likewise
mlstm_chunk.cost = mlstm_chunk_cost
mlstm_chunk_bwd.cost = mlstm_chunk_bwd_cost
