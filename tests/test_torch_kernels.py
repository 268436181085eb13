"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode, as ``tests/test_kernels.py`` runs them.  The same
numpy inputs go through both.  ``test_torch_gpu.py`` holds the CUDA kernels
against the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro_torch import kernels as tk

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (both
    frameworks round f32 to bf16 to nearest even)."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------ rmsnorm


@pytest.mark.parametrize("shape", [(7, 128), (2, 33, 256), (1, 512),
                                   (8, 2048), (64, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    xj, xt = _both(x, dtype)
    want = jk.rmsnorm(xj, jnp.asarray(scale), block_rows=16, interpret=True)
    got = tk.rmsnorm(xt, torch.from_numpy(scale))
    assert got.dtype == TDT[dtype] and got.shape == xt.shape
    _close(got, want, TOL[dtype])


# ------------------------------------------------------------- paged decode


def _paged_inputs(B, H, KV, D, bs, T, seed, lengths=None):
    """Shuffled non-identity tables, ragged lengths, unused entries on
    scratch block 0 (as ``test_paged_decode_attention_parity``)."""
    rng = np.random.default_rng(seed)
    n = B * T + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n, bs, KV, D)).astype(np.float32)
    vp = rng.standard_normal((n, bs, KV, D)).astype(np.float32)
    tables = (rng.permutation(n - 1) + 1).reshape(B, T).astype(np.int32)
    if lengths is None:
        lengths = [max(1, (T * bs) // (i + 1) - 3) for i in range(B)]
    lengths = np.asarray(lengths, np.int32)
    used = -(-lengths // bs)
    tables = np.where(np.arange(T)[None, :] < used[:, None], tables, 0)
    return q, kp, vp, tables.astype(np.int32), lengths


PAGED_CASES = [
    (2, 8, 2, 64, 16, 8, None),          # GQA
    (3, 4, 1, 128, 32, 4, None),         # MQA
    (1, 4, 4, 64, 8, 16, None),          # MHA
    (3, 4, 2, 32, 4, 4, [9, 0, 16]),     # an empty sequence, a full table
    (2, 4, 1, 32, 2, 8, [3, 16]),        # block size 2
]


@pytest.mark.parametrize("B,H,KV,D,bs,T,lengths", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_matches_pallas(B, H, KV, D, bs, T, lengths,
                                               dtype):
    q, kp, vp, tables, lens = _paged_inputs(B, H, KV, D, bs, T, B * H + bs,
                                            lengths)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kp, vp))
    want = jk.paged_decode_attention(qj, kj, vj, jnp.asarray(tables),
                                     jnp.asarray(lens), interpret=True)
    got = tk.paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                    torch.from_numpy(lens))
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    _close(got, want, TOL[dtype])
    if 0 in lens.tolist():  # an empty sequence attends to nothing: 0
        assert not got[lens.tolist().index(0)].any()


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything that is not a CUDA
    tensor either is refused, never computed some other way."""
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        tk.rmsnorm(x, torch.zeros(8, device="meta"))
    q = torch.empty(1, 2, 8, device="meta")
    pool = torch.empty(2, 4, 1, 8, device="meta")
    idx = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tk.paged_decode_attention(q, pool, pool, idx, idx[0])
