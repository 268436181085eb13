"""Chunkwise stabilized mLSTM: the wrapper of the CUDA kernel
``csrc/mlstm_chunk.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_chunk.py::mlstm_chunk``,
which computes ``repro/models/recurrent.py::mlstm_chunk_recurrence``.  Unlike
the TPU kernel it can also return the final carry ``(C, n, m)``, so the
prefill runs it too.  The chunk is ``min(chunk, S)`` and must divide S, the
reference's rule.  As in the TPU kernel's wrapper, the forget gate's log
sigmoid is taken here, outside the kernel.  A tensor on the CPU takes the
plain version (``ref.mlstm_chunk_ref``); a CUDA tensor launches the kernel
or raises.  Neither package has a backward for it, so under grad mode
inputs that require grad are refused.

The kernel runs in two passes on the caller's stream (one call, one count
in ``.launches``): a state pass writes the carry entering every chunk to a
workspace that this wrapper allocates, and an output pass reads it.  The
grids and the workspace come from the shapes alone (``_plan``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .ref import mlstm_chunk_ref

# as in csrc/mlstm_chunk.cu: a state-pass block holds a STATE_TILE[0] x
# STATE_TILE[1] tile of C (dk rows x value columns); an output-pass block
# writes VALUE_TILE value columns of h
STATE_TILE = {torch.bfloat16: (64, 96), torch.float32: (64, 64)}
VALUE_TILE = {torch.bfloat16: 192, torch.float32: 32}


def _plan(B: int, S: int, H: int, dk: int, c: int, dtype) -> tuple:
    """``(state_tiles, state_e_tiles, value_tiles, workspace_floats)`` for
    chunks of ``c``: the state pass's grid is (B * H, state_tiles,
    state_e_tiles) tiles of C, the output pass's (B * H, S / c,
    value_tiles); the workspace holds, for every (batch, head, chunk), the
    carry entering that chunk with dk rounded up to 16 (dkp): C (dkp^2
    floats: row-major for f32 inputs, in mma fragment order for bf16), n
    (dkp) and m."""
    dkp = -(-dk // 16) * 16
    rows, cols = STATE_TILE[dtype]
    return (-(-dk // rows), -(-dk // cols), -(-dk // VALUE_TILE[dtype]),
            B * H * (S // c) * (dkp * dkp + dkp + 1))


def mlstm_chunk(q, k, v, i_pre, f_pre, *, chunk: int = 128,
                return_final: bool = False):
    """q, k, v (B,S,H,dk) in one dtype (f32 or bf16); i_pre, f_pre (B,S,H)
    -> h (B,S,H,dk) f32 [, (C (B,H,dk,dk), n (B,H,dk), m (B,H)) f32]."""
    name = "mlstm_chunk"
    _build.refuse_grad(name, q=q, k=k, v=v, i_pre=i_pre, f_pre=f_pre)
    if _build.on_cpu(name, q=q, k=k, v=v, i_pre=i_pre, f_pre=f_pre):
        return mlstm_chunk_ref(q, k, v, i_pre, f_pre, chunk=chunk,
                               return_final=return_final)
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
    log_i = i_pre.float().contiguous()
    log_f = F.logsigmoid(f_pre.float()).contiguous()
    h = torch.empty((B, S, H, dk), dtype=torch.float32, device=q.device)
    final = None
    if return_final:
        final = (torch.empty((B, H, dk, dk), dtype=torch.float32, device=q.device),
                 torch.empty((B, H, dk), dtype=torch.float32, device=q.device),
                 torch.empty((B, H), dtype=torch.float32, device=q.device))
    C_ptr, n_ptr, m_ptr = ((None, None, None) if final is None
                           else tuple(t.data_ptr() for t in final))
    state_tiles, state_e_tiles, value_tiles, ws_floats = _plan(B, S, H, dk, c,
                                                               q.dtype)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    err = lib.repro_mlstm_chunk(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), log_i.data_ptr(), log_f.data_ptr(), h.data_ptr(), C_ptr,
        n_ptr, m_ptr, ws.data_ptr(), B, S, H, dk, c, state_tiles, state_e_tiles,
        value_tiles, 1.0 / math.sqrt(dk), _build.stream(q.device))
    _build.check(err, name)
    mlstm_chunk.launches += 1
    return (h, final) if return_final else h


mlstm_chunk.launches = 0  # kernel launches since the count was last reset
