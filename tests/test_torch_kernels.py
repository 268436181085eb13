"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode, as ``tests/test_kernels.py`` runs them.  The same
numpy inputs go through both.  ``test_torch_gpu.py`` holds the CUDA kernels
against the plain versions on the card.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.kernels import ref as jref
from repro.models import layers as jlayers
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


# The split plans are pure Python on shapes; the kernels' own limits, which
# the wrappers read from the built library on the card: a paged tile holds
# at most 32 tokens, a dk/dv key tile 64 keys (32 in the f32 tensor-core
# variant).  H100: 132 SMs.
PAGED_TILE_MAX, BWD_KEY_TILE, BWD_F32_KEY_TILE, H100_SMS = 32, 64, 32, 132


@pytest.mark.parametrize("B,KV,T,bs", [
    (8, 1, 64, 16),     # gemma-2b, 1024 positions
    (8, 8, 64, 16),     # qwen3-14b
    (8, 1, 255, 16),    # the paged serve's table (256 blocks)
    (1, 1, 1, 16),      # a single page
    (1, 1, 1, 2),
    (2, 1, 8, 2),       # block size 2
    (3, 2, 4, 32),      # block size 32
    (1, 1, 40, 64),     # pages larger than a tile
    (2, 1, 10, 48),     # a page size that does not divide the tile
    (64, 8, 2048, 16),  # a batch that fills the card without splitting
])
def test_paged_split_plan_covers_the_table(B, KV, T, bs):
    from repro_torch.kernels.decode_attention import BLOCKS_PER_SM, _paged_splits
    chunk, tile, nsplit = _paged_splits(B, KV, T, bs, PAGED_TILE_MAX, H100_SMS)
    assert chunk % bs == 0 and chunk % tile == 0  # whole pages, whole tiles
    assert 1 <= tile <= PAGED_TILE_MAX
    assert nsplit * chunk >= T * bs > (nsplit - 1) * chunk  # covers, no empty tail
    # two blocks per SM or more wherever the table has the pages for it
    if T * bs // max(bs, tile) * B * KV >= BLOCKS_PER_SM * H100_SMS:
        assert nsplit * B * KV >= BLOCKS_PER_SM * H100_SMS


def test_paged_split_plan_at_the_model_shapes():
    from repro_torch.kernels.decode_attention import _paged_splits
    chunk, tile, nsplit = _paged_splits(8, 1, 64, 16, PAGED_TILE_MAX, H100_SMS)
    assert nsplit * 8 * 1 >= 2 * H100_SMS  # gemma-2b: 8 sequences, one KV head
    assert (chunk, tile, nsplit) == (16, 16, 64)
    assert _paged_splits(8, 8, 64, 16, PAGED_TILE_MAX, H100_SMS)[2] * 64 >= 2 * H100_SMS
    for bs in (2, 16, 32):  # a single-page table takes one split
        assert _paged_splits(1, 1, 1, bs, PAGED_TILE_MAX, H100_SMS) == (bs, bs, 1)


@pytest.mark.parametrize("variant", ["tensor_cores", "cuda_cores"])
@pytest.mark.parametrize("B,KV,Smax", [
    (8, 1, 1024),     # gemma-2b, batch 8
    (4, 1, 256),      # the fixed-slot serve (4 slots, max_len 256)
    (1, 1, 1024),     # decode after a 1024-token prefill
    (1, 1, 2048),     # recurrentgemma-9b's local ring
    (8, 8, 1024),     # qwen3-14b
    (3, 2, 100),      # Smax off the step
    (1, 1, 1),        # one position
    (64, 8, 4096),    # a batch that fills the card without splitting
])
def test_dense_split_plan_covers_the_cache(B, KV, Smax, variant):
    from repro_torch.kernels.decode_attention import CUDA_CORE_PLAN, TC_PLAN, _splits
    plan = TC_PLAN if variant == "tensor_cores" else CUDA_CORE_PLAN
    step, min_steps, per_sm = plan
    chunk, nsplit = _splits(B, KV, Smax, H100_SMS, plan)
    assert chunk % step == 0 and chunk >= min_steps * step  # whole steps, the fewest or more
    assert nsplit * chunk >= Smax > (nsplit - 1) * chunk  # covers, no empty tail
    # at most one wave of blocks (one split fewer is under it) ...
    assert nsplit == 1 or (nsplit - 1) * B * KV < per_sm * H100_SMS
    # ... from the shortest chunk that keeps it: one step shorter and the
    # grid would pass a wave
    if chunk > min_steps * step:
        assert -(-Smax // (chunk - step)) * B * KV > per_sm * H100_SMS


def test_dense_split_plan_at_the_serving_shapes():
    from repro_torch.kernels.decode_attention import CUDA_CORE_PLAN, TC_PLAN, _splits
    # (B, KV, Smax) -> (chunk, blocks) of the tensor-core variant: one
    # 64-key tile a block where the cache is short (the plan before this
    # one: 32, 32, 64 and 256 blocks)
    for (B, KV, Smax), want in {(4, 1, 256): (64, 16), (1, 1, 1024): (64, 16),
                                (1, 1, 2048): (64, 32), (8, 1, 1024): (64, 128),
                                (8, 8, 1024): (352, 192)}.items():
        chunk, nsplit = _splits(B, KV, Smax, H100_SMS, TC_PLAN)
        assert (chunk, nsplit * B * KV) == want, (B, KV, Smax)
    # the CUDA-core split body (f32): one 32-key stage a block or more, two
    # blocks per SM
    for (B, KV, Smax), want in {(4, 1, 256): (32, 32), (1, 1, 1024): (32, 32),
                                (1, 1, 2048): (32, 64), (8, 1, 1024): (32, 256)}.items():
        chunk, nsplit = _splits(B, KV, Smax, H100_SMS, CUDA_CORE_PLAN)
        assert (chunk, nsplit * B * KV) == want, (B, KV, Smax)


@pytest.mark.parametrize("B,KV,T,bs", [
    (8, 1, 64, 16),     # gemma-2b, 1024 positions
    (8, 8, 64, 16),     # qwen3-14b
    (8, 1, 255, 16),    # the paged serve's table (256 blocks)
    (4, 1, 16, 16),     # the f32 engine checks' 256 positions
    (1, 1, 1, 16),      # a single page
    (2, 1, 8, 2),       # block size 2
    (4, 1, 64, 2),
    (3, 2, 4, 32),      # block size 32
    (1, 1, 40, 64),     # pages of 64
    (2, 1, 10, 48),     # pages of 48: no whole number of them makes 32 keys
    (64, 8, 2048, 16),  # a batch that fills the card without splitting
])
def test_paged_cuda_core_plan_covers_the_table(B, KV, T, bs):
    """The paged f32 plan: chunks of whole pages, at least one 32-key stage
    (or the whole table), that cover the table with no empty tail, as short
    as keep the grid within one wave of two blocks per SM."""
    from repro_torch.kernels.decode_attention import CUDA_CORE_PLAN, _paged_cuda_core_splits
    tile, min_tiles, per_sm = CUDA_CORE_PLAN
    chunk, nsplit = _paged_cuda_core_splits(B, KV, T, bs, H100_SMS)
    assert chunk % bs == 0  # whole pages
    assert chunk >= min(tile * min_tiles, T * bs) or nsplit == 1
    assert chunk - bs < tile * min_tiles or nsplit == 1 or (
        -(-T * bs // (chunk - bs)) * B * KV > per_sm * H100_SMS)  # no shorter chunk keeps one wave
    assert nsplit * chunk >= T * bs > (nsplit - 1) * chunk  # covers, no empty tail
    assert nsplit == 1 or (nsplit - 1) * B * KV < per_sm * H100_SMS


def test_cuda_core_split_plans_at_the_f32_shapes():
    """(chunk, blocks) of the f32 split body, dense and paged, at gemma-2b's
    and qwen3-14b's kernel shapes and the f32 engine checks' shapes: the
    fixed-slot serve (B 4, Smax 256), decode after a 1024-token prefill (B
    1), recurrentgemma-9b's ring (B 1, Smax 2048, 16 heads); paged with
    16-token pages."""
    from repro_torch.kernels.decode_attention import (
        CUDA_CORE_PLAN,
        _paged_cuda_core_splits,
        _paged_splits,
        _splits,
    )
    dense = {(8, 1, 1024): (32, 256), (8, 8, 1024): (224, 320), (4, 1, 256): (32, 32),
             (1, 1, 1024): (32, 32), (1, 1, 2048): (32, 64)}
    paged = {(8, 1, 1024): (32, 256), (8, 8, 1024): (208, 320), (4, 1, 256): (32, 32),
             (1, 1, 1024): (32, 32), (1, 1, 2048): (32, 64)}
    for (B, KV, Smax), want in dense.items():
        chunk, nsplit = _splits(B, KV, Smax, H100_SMS, CUDA_CORE_PLAN)
        assert (chunk, nsplit * B * KV) == want, (B, KV, Smax)
    for (B, KV, Smax), want in paged.items():  # qwen3-14b: whole pages of 16
        chunk, nsplit = _paged_cuda_core_splits(B, KV, Smax // 16, 16, H100_SMS)
        assert (chunk, nsplit * B * KV) == want, (B, KV, Smax)
    # the bf16 paged plan is unchanged: one page a block at gemma-2b's shape
    assert _paged_splits(8, 1, 64, 16, PAGED_TILE_MAX, H100_SMS) == (16, 16, 64)
    # pages of 48 and of 2
    assert _paged_cuda_core_splits(2, 1, 10, 48, H100_SMS) == (48, 10)
    assert _paged_cuda_core_splits(4, 1, 64, 2, H100_SMS) == (32, 4)


@pytest.mark.parametrize("B,S,H,KV", [
    (1, 1024, 8, 1),    # gemma-2b, one sequence
    (2, 1024, 8, 1),    # gemma-2b's train step
    (1, 2048, 40, 8),   # qwen3-14b
    (1, 77, 80, 1),     # two head chunks
    (2, 128, 4, 4),     # MHA
    (1, 100000, 8, 1),  # long enough to fill the card alone
])
def test_dkv_split_plan_fills_one_wave(B, S, H, KV):
    """Both tensor-core dk/dv passes' plans: bf16 (a block per 64-key
    tile) and f32 (a block per pair of 32-key tiles)."""
    from repro_torch.kernels.flash_attention import ROWS, _dkv_splits
    for key_tile, paired in ((BWD_KEY_TILE, False), (BWD_F32_KEY_TILE, True)):
        nsplit = _dkv_splits(B, S, H, KV, key_tile, H100_SMS, paired=paired)
        key_tiles = -(-S // key_tile)
        blocks = (-(-key_tiles // 2) if paired else key_tiles) * B * KV
        G = H // KV
        tiles = -(-G // min(G, ROWS)) * -(-S // (ROWS // min(G, ROWS)))
        assert 1 <= nsplit <= tiles
        assert nsplit == 1 or nsplit * blocks <= H100_SMS  # one block per SM
        assert (nsplit + 1) * blocks > H100_SMS or nsplit == tiles
    if (B, S, H, KV) == (1, 1024, 8, 1):
        assert _dkv_splits(B, S, H, KV, BWD_KEY_TILE, H100_SMS) == 8  # 16 key tiles x 8
        # 16 pairs of key tiles x 8
        assert _dkv_splits(B, S, H, KV, BWD_F32_KEY_TILE, H100_SMS, paired=True) == 8
    if (B, S, H, KV) == (2, 1024, 8, 1):  # the f32 pass at the train step's batch
        assert _dkv_splits(B, S, H, KV, BWD_F32_KEY_TILE, H100_SMS, paired=True) == 4


@pytest.mark.parametrize("B,S,H,KV,window,want", [
    (1, 1024, 8, 1, 0, 2),      # gemma-2b: the heaviest q tile walks 32 key tiles, the mean SM 16
    (2, 512, 8, 1, 0, 2),       # the trainer PE's attention
    (1, 2048, 40, 8, 0, 1),     # qwen3-14b: 1,368 q tiles, many waves
    (1, 4096, 16, 1, 2048, 1),  # recurrentgemma-9b's windowed layers: even work
    (1, 1, 8, 1, 0, 1),         # one token: one key tile
])
def test_dq_split_plan_brings_the_heaviest_block_to_the_mean(B, S, H, KV, window, want):
    """The f32 dq pass's key ranges: 1, 2 or 4, no more than the heaviest
    q tile's key tiles, chosen so its block does about the work of the mean
    SM."""
    from repro_torch.kernels.flash_attention import _dq_splits
    assert _dq_splits(B, S, H, KV, BWD_F32_KEY_TILE, H100_SMS, True, window) == want


def test_flash_route_is_the_plain_version_on_the_cpu():
    """``flash_route`` names the plain version for CPU tensors (any dtype
    and head dim, forward or backward), refuses a CPU tensor beside one
    elsewhere, as the wrappers do, and a backward without its do; on the
    card it reads the C entries' rule."""
    from repro_torch.kernels.flash_attention import ROUTES
    route = tk.flash_route
    q = torch.zeros(1, 4, 2, 72)
    assert route(q, q[:, :, :1], q[:, :, :1]) == "plain"
    assert route(q.bfloat16(), q.bfloat16(), q.bfloat16()) == "plain"
    assert route(q, q, q, q, backward=True) == "plain"
    assert ROUTES == ("cuda-cores", "bf16-tensor-cores", "f32-tensor-cores")
    with pytest.raises(ValueError):
        route(q, q, q, torch.empty(1, 4, 2, 72, device="meta"), backward=True)
    with pytest.raises(ValueError):
        route(q, q, q, backward=True)


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
    cache = torch.empty(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError):
        tk.decode_attention(q, cache, cache, idx[0])
    seq = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        tk.flash_attention(seq, seq[:, :, :1], seq[:, :, :1])
    # a CPU tensor beside one elsewhere takes neither path
    with pytest.raises(ValueError):
        tk.rmsnorm(torch.zeros(2, 8), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError):
        tk.decode_attention(torch.zeros(1, 2, 8), cache, cache, idx[0])
    with pytest.raises(ValueError):
        tk.flash_attention(torch.zeros(1, 4, 2, 8), seq, seq)
    with pytest.raises(ValueError):
        tk.paged_decode_attention(torch.zeros(1, 2, 8), pool, pool, idx, idx[0])


# ---------------------------------------------------------- flash attention

# the sweep of tests/test_kernels.py::test_flash_attention_sweep
FLASH_CASES = [
    (1, 128, 4, 4, 64),   # MHA
    (2, 256, 8, 2, 64),   # GQA
    (1, 256, 4, 1, 128),  # MQA
    (2, 128, 4, 4, 32),
]


@pytest.mark.parametrize("B,S,H,KV,D", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(B, S, H, KV, D, dtype, causal):
    """Output and LSE against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(B * S + H * KV + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want, want_lse = jk.flash_attention(qj, kj, vj, block_q=64, block_k=64,
                                        causal=causal, interpret=True,
                                        return_lse=True)
    got, lse = tk.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, S, H)
    _close(got, want, TOL[dtype])
    _close(lse, want_lse, TOL[dtype])
    assert torch.equal(tk.flash_attention(qt, kt, vt, causal=causal), got)


@pytest.mark.parametrize("block_q,block_k", [(32, 128), (128, 32), (64, 64)])
def test_flash_attention_matches_pallas_block_shapes(block_q, block_k):
    """The cases of tests/test_kernels.py::test_flash_attention_block_shapes:
    the port has one tiling, the Pallas kernel three."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 256, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    want = jk.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              block_q=block_q, block_k=block_k, interpret=True)
    got = tk.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("S,H,KV,D", [(100, 4, 2, 32), (37, 8, 1, 64),
                                      (1, 5, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_reference(S, H, KV, D, dtype):
    """Sequence lengths the Pallas kernel's ``S % block`` assert refuses,
    against the JAX oracle ``ref.causal_attention_ref``; the LSE against
    a log-sum-exp of JAX's masked scores."""
    rng = np.random.default_rng(S + H + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, S, H, D), (2, S, KV, D), (2, S, KV, D)))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    got, lse = tk.flash_attention(qt, kt, vt, return_lse=True)
    _close(got, jref.causal_attention_ref(qj, kj, vj), TOL[dtype])
    kf = jnp.repeat(kj, H // KV, axis=2).astype(jnp.float32)
    s = jnp.einsum("bqhd,bkhd->bqhk", qj.astype(jnp.float32), kf) / np.sqrt(D)
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, :, None, :], s, -jnp.inf)
    _close(lse, jax.scipy.special.logsumexp(s, axis=-1), TOL[dtype])


# ------------------------------------------------------------- dense decode


@pytest.mark.parametrize("B,H,KV,D,Smax,block_k,lengths", [
    # tests/test_kernels.py::test_decode_attention_sweep
    (2, 8, 2, 64, 512, 128, None),
    (3, 4, 1, 128, 1024, 128, None),
    (1, 4, 4, 64, 256, 128, None),
    # ::test_decode_attention_unaligned_cache (Smax off block_k)
    (2, 4, 2, 64, 384, 256, "unaligned"),
    (1, 4, 4, 64, 100, 128, "unaligned"),
    (2, 8, 2, 64, 260, 128, "unaligned"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(B, H, KV, D, Smax, block_k, lengths,
                                         dtype):
    rng = np.random.default_rng(B * H + D + Smax)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, D), (B, Smax, KV, D), (B, Smax, KV, D)))
    if lengths is None:
        lens = np.asarray([Smax // (i + 1) for i in range(B)], np.int32)
    else:
        lens = np.asarray([Smax - 7 * i for i in range(B)], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kc, vc))
    want = jk.decode_attention(qj, kj, vj, jnp.asarray(lens), block_k=block_k,
                               interpret=True)
    got = tk.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert got.dtype == TDT[dtype] and got.shape == (B, H, D)
    _close(got, want, TOL[dtype])


def test_decode_attention_lengths_past_the_cache_match_the_model_layer():
    """A length above Smax attends to the whole cache, as JAX's plain
    ``layers.decode_attention`` (what its ``decode_step`` runs) reads it;
    ragged lengths below Smax too."""
    rng = np.random.default_rng(9)
    B, H, KV, D, Smax = 4, 8, 2, 32, 48
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, D), (B, Smax, KV, D), (B, Smax, KV, D)))
    lens = np.asarray([Smax + 1, 300, 17, 1], np.int32)
    want = jlayers.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, lens)))
    got = tk.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, lens)))
    _close(got, want, 2e-5)
    zero = tk.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                               torch.zeros(B, dtype=torch.int32))
    assert not zero.any()  # an empty row attends to nothing: 0


# ------------------------ f32 summation order of the CUDA-core decode body
#
# ``csrc/decode_split.cuh``'s arithmetic in numpy: each lane's partial dot
# product over its slice of D (pieces of min(E, 4) elements at lane + 32 j)
# as one FMA chain, the 32 lanes added in the butterfly's fixed tree (lane
# pairs by bits 2, 1, 0, 3, 4), the online softmax per 16-key tile (p summed
# over kb on each of 8 lanes, then by lane bits 0, 1, 2), P V as a 16-term
# FMA chain a tile and O = fma(O, corr, pv); two key groups, each taking
# every other 16-key tile of a chunk, merged (O = fma(O1, w1, O0 w0)); the
# splits' partials, then the combine pass in split order.  The paged path runs the same arithmetic on
# rows it looks up, so the emulation gathers its pages into a cache.


def _pairs(x, axis):
    """x's two halves along ``axis`` added in f32."""
    return (np.take(x, 0, axis=axis) + np.take(x, 1, axis=axis)).astype(np.float32)

def _decode_split_order(q, kc, vc, lens, chunk):
    """(B, H, D) f32 as the CUDA-core split body with chunks of ``chunk``
    positions and the combine pass compute it (``_fma`` as above)."""
    f32 = np.float32
    B, H, D = q.shape
    S, KV = kc.shape[1:3]
    G = H // KV
    E = 1
    while 32 * E < D:
        E *= 2
    W, TK = min(E, 4), (16 if E <= 8 else 8)
    Dp = 32 * E
    idx = np.array([[W * (l + 32 * j) + w for j in range(E // W) for w in range(W)]
                    for l in range(32)])
    Sp = -(-max(S, 1) // TK) * TK + chunk
    pad = lambda x, n: np.concatenate([x, np.zeros(x.shape[:-1] + (n - x.shape[-1],), f32)], -1)
    qg = pad(q, Dp).reshape(B, KV, G, Dp)
    kp = np.zeros((B, KV, Sp, Dp), f32)
    kp[:, :, :S, :D] = kc.transpose(0, 2, 1, 3)
    vp = np.zeros((B, KV, Sp, D), f32)
    vp[:, :, :S] = vc.transpose(0, 2, 1, 3)
    acc = np.zeros((B, KV, G, Sp, 32), f32)
    for e in range(E):
        acc = _fma(acc, qg[..., idx[:, e]][:, :, :, None, :], kp[..., idx[:, e]][:, :, None])
    x = acc.reshape(B, KV, G, Sp, 2, 2, 2, 2, 2)  # lane bits 4 3 2 1 0
    x = _pairs(x, -3)   # bit 2
    x = _pairs(x, -2)   # bit 1
    x = _pairs(x, -1)   # bit 0
    x = _pairs(x, -1)   # bit 3
    s = (_pairs(x, -1) * f32(1.0 / math.sqrt(D))).astype(f32)  # bit 4, then the scale
    L = np.minimum(np.maximum(np.asarray(lens), 0), S)[:, None, None]
    groups = 2 if E <= 16 else 1
    stage = groups * TK
    nsplit = -(-S // chunk)
    parts = []
    for c in range(nsplit):
        start = c * chunk
        end = np.minimum(start + chunk, L)  # (B, 1, 1)
        states = []
        for kg in range(groups):  # key group kg: keys kg TK .. + TK - 1 of each stage
            m = np.full((B, KV, G), -1e30, f32)
            l = np.zeros((B, KV, G), f32)
            o = np.zeros((B, KV, G, D), f32)
            for t0 in range(start + kg * TK, start + chunk, stage):
                live = t0 < end
                if not live.any():
                    break
                valid = (t0 + np.arange(TK))[None, None, None, :] < end[..., None]
                sc = np.where(valid, s[..., t0:t0 + TK], f32(-1e30))
                mn = np.maximum(m, sc.max(-1))
                corr = np.exp((m - mn).astype(f32)).astype(f32)
                p = np.where(valid, np.exp((sc - mn[..., None]).astype(f32)), f32(0)).astype(f32)
                lane = p[..., 0:8]
                for kb in range(1, TK // 8):
                    lane = (lane + p[..., 8 * kb:8 * kb + 8]).astype(f32)
                y = lane.reshape(B, KV, G, 2, 2, 2)  # bits 2 1 0
                ps = _pairs(_pairs(_pairs(y, -1), -1), -1)
                pv = np.zeros_like(o)
                for r in range(TK):
                    pv = _fma(pv, p[..., r, None], vp[:, :, None, t0 + r])
                lv = live[..., None]
                o = np.where(lv, _fma(pv, o, corr[..., None]), o)
                l = np.where(live, _fma(ps, l, corr), l)
                m = np.where(live, mn, m)
            states.append((o, m, l))
        o, m, l = states[0]
        for o1, m1, l1 in states[1:]:  # key group 1 merged into key group 0
            mn = np.maximum(m, m1)
            w0 = np.exp((m - mn).astype(f32)).astype(f32)
            w1 = np.exp((m1 - mn).astype(f32)).astype(f32)
            o = _fma((o * w0[..., None]).astype(f32), o1, w1[..., None])
            l = _fma((l * w0).astype(f32), l1, w1)
            m = mn
        parts.append((o, m, l))
    m_all = np.max([m for _, m, _ in parts], axis=0)
    den = np.zeros((B, KV, G), f32)
    num = np.zeros((B, KV, G, D), f32)
    for o, m, l in parts:
        full = l > 0
        w = np.exp((m - m_all).astype(f32)).astype(f32)
        den = np.where(full, _fma(den, l, w), den)
        num = np.where(full[..., None], _fma(num, o, w[..., None]), num)
    out = (num / np.maximum(den, f32(1e-30))[..., None]).astype(f32)
    return out.reshape(B, H, D)


def _f64_decode(q, kc, vc, lens):
    """The decode of ``ref.decode_attention_ref`` in f64."""
    B, H, D = q.shape
    S, KV = kc.shape[1:3]
    k, v = (np.repeat(x.astype(np.float64), H // KV, axis=2) for x in (kc, vc))
    s = np.einsum("bhd,bkhd->bhk", q.astype(np.float64), k) / math.sqrt(D)
    valid = (np.arange(S)[None, :] < np.asarray(lens)[:, None])[:, None, :]
    s = np.where(valid, s, -np.inf)
    top = s.max(-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(top), top, 0))
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-300)
    return np.einsum("bhk,bkhd->bhd", p, v)


@pytest.mark.parametrize("B,H,KV,D,Smax,lengths", [
    (2, 8, 2, 64, 100, [100, 33]),         # GQA, ragged, off the tiles
    (3, 10, 2, 36, 70, [70, 0, 17]),       # G = 5, D 36 (two elements a lane), empty
    (2, 4, 1, 512, 40, [40, 9]),           # D 512: 8-key tiles
    (1, 32, 1, 64, 200, [129]),            # G = 32: two passes over the chunk
    (4, 8, 1, 256, 256, [256, 0, 63, 65]),  # the fixed-slot serve's shape
])
def test_f32_decode_split_order_matches_pallas(B, H, KV, D, Smax, lengths):
    """The CUDA-core body's sum order, at its plan's chunk and at a chunk of
    one tile, against the JAX kernel within f32's 2e-5."""
    from repro_torch.kernels.decode_attention import CUDA_CORE_PLAN, _splits
    rng = np.random.default_rng(B * H + D)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, D), (B, Smax, KV, D), (B, Smax, KV, D)))
    lens = np.asarray(lengths, np.int32)
    want = jk.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, lens)), block_k=32,
                               interpret=True)
    for chunk in (_splits(B, KV, Smax, H100_SMS, CUDA_CORE_PLAN)[0], 16):
        got = _decode_split_order(q, kc, vc, lens, chunk)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
        assert not got[lens == 0].any()


@pytest.mark.parametrize("B,H,KV,D,bs,T,lengths", PAGED_CASES)
def test_f32_paged_split_order_matches_pallas(B, H, KV, D, bs, T, lengths):
    """The same body over a paged pool (its rows gathered by the table, at
    the paged f32 plan's chunk) against the JAX paged kernel."""
    from repro_torch.kernels.decode_attention import _paged_cuda_core_splits
    q, kp, vp, tables, lens = _paged_inputs(B, H, KV, D, bs, T, B * H + bs, lengths)
    want = jk.paged_decode_attention(*(jnp.asarray(a) for a in (q, kp, vp, tables, lens)),
                                     interpret=True)
    kc, vc = (x[tables].reshape(B, T * bs, KV, D) for x in (kp, vp))
    chunk, _ = _paged_cuda_core_splits(B, KV, T, bs, H100_SMS)
    got = _decode_split_order(q, kc, vc, lens, chunk)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H,KV,D", [(8, 8, 1, 256), (8, 40, 8, 128)])
def test_f32_decode_split_order_near_f64(B, H, KV, D):
    """At gemma-2b's and qwen3-14b's shapes (Smax 1024, ragged lengths as
    ``chip_smoke.check_decode``'s), the body's sum order leaves no more
    elements off the correctly rounded f64 result than plain f32 does."""
    from repro_torch.kernels.decode_attention import CUDA_CORE_PLAN, _splits
    Smax = 1024
    rng = np.random.default_rng(D)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, D), (B, Smax, KV, D), (B, Smax, KV, D)))
    lens = np.asarray([Smax + 1] + [max(1, Smax - (Smax * i) // B) for i in range(1, B)],
                      np.int32)
    got = _decode_split_order(q, kc, vc, lens, _splits(B, KV, Smax, H100_SMS, CUDA_CORE_PLAN)[0])
    plain = tk.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, lens))).numpy()
    exact = _f64_decode(q, kc, vc, np.minimum(lens, Smax)).astype(np.float32)
    assert np.isfinite(got).all()
    assert (got != exact).sum() <= (plain != exact).sum()


# ---------------------------------------------------- local (windowed) flash


@pytest.mark.parametrize("S,H,KV,D,window", [(256, 2, 2, 32, 64), (100, 4, 1, 32, 30),
                                             (40, 4, 2, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_flash_matches_reference(S, H, KV, D, window, dtype):
    """The windowed flash wrapper (its plain version on the CPU) against
    the JAX oracle's sliding-window mode, any S and window; the LSE against
    the oracle's scores."""
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((2, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, KV, D)).astype(np.float32) for _ in range(2))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    got, lse = tk.flash_attention(qt, kt, vt, window=window, return_lse=True)
    _close(got, jref.causal_attention_ref(qj, kj, vj, window=window), TOL[dtype])
    G = H // KV
    s = np.einsum("bqhd,bkhd->bhqk", _np32(qj), np.repeat(_np32(kj), G, 2)) / np.sqrt(D)
    i = np.arange(S)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    s = np.where(mask, s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.transpose(0, 2, 1),
                               atol=2e-5, rtol=2e-5)


def _np32(a) -> np.ndarray:
    return np.asarray(a.astype(jnp.float32))


# ------------------------------- split-TF32 error model of the f32 flash backward
#
# The f32 tensor-core variant of csrc/flash_attention_bwd.cu recomputes
# the scores S as the f32 CUDA-core forward does (one FMA chain over the
# head dim), and forms every other product from tensor-core products of
# TF32 terms (csrc/tf32.cuh): each operand in hi + lo, dP as all four
# products of terms, the gradient products (dS K, dS^T Q, P^T dO) as lo hi
# + hi lo + hi hi.  The emulation below models it: the chain's FMAs through
# f64 (each product exact, one rounding to f64, then to f32), TF32 rounding
# on the low 13 bits (ties away from zero, as the kernel's cvt.rna, or to
# even), each tensor-core product exact and its sum into the accumulator
# truncated toward zero, and runs of 8-deep steps summed that way before an
# f32 add: one step in dP, 32 keys in dS K, 64 rows in P^T dO and dS^T Q.
# With whole-depth runs instead the truncation compounds: at D = 256 and
# scores in the hundreds the gradients then part from f64 by more than
# this test allows.  The forward's out and lse come from the same chain's
# scores, as the kernels' do.


def _tf32(x: torch.Tensor, ties: str) -> torch.Tensor:
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if ties == "away":
        u = (u + 0x1000) & 0xFFFFE000
    else:
        u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def _rz(x64: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero."""
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, run: int, terms: int, order: int,
             ties: str) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) from TF32 terms: the products of terms
    (i, j) with i + j <= order, smallest first; K is zero-padded to whole
    steps of 8, as the kernels zero-fill rows past S."""
    pad = -a.shape[-1] % 8
    a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))
    ta, tb = [], []
    for x, out in ((a, ta), (b, tb)):
        for _ in range(terms):
            out.append(_tf32(x, ties))
            x = x - out[-1]
    pairs = [(i, o - i) for o in range(order, -1, -1) for i in range(terms - 1, -1, -1)
             if 0 <= o - i < terms]
    steps = a.shape[-1] // 8
    acc = None
    for r0 in range(0, steps, run):
        c = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for ks in range(r0, min(steps, r0 + run)):
            sl = slice(8 * ks, 8 * ks + 8)
            for i, j in pairs:
                c = _rz(c.double() + ta[i][..., sl].double() @ tb[j][..., sl, :].double())
        acc = c if acc is None else acc + c
    return acc


def _chain_scores(q, kg):
    """q kg^T (..., S, S) as the f32 kernels' FMA chain over the head dim,
    in order from zero."""
    s = torch.zeros(q.shape[:-1] + kg.shape[-2:-1], dtype=torch.float32)
    for d in range(q.shape[-1]):
        s = (s.double() + q[..., d, None].double() * kg[..., None, :, d].double()).float()
    return s


def _band(S, window):
    i = torch.arange(S)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window if window else True)


def _emulated_flash_fwd(q, k, v, window):
    """out, lse of causal GQA attention on (B, H, S, D) f32 tensors from the
    chain's scores, softmax in f32."""
    G, D, S = q.shape[1] // k.shape[1], q.shape[-1], q.shape[2]
    sc = _chain_scores(q, k.repeat_interleave(G, 1)) * (1.0 / math.sqrt(D))
    sc = sc.masked_fill(~_band(S, window), float("-inf"))
    return torch.softmax(sc, -1) @ v.repeat_interleave(G, 1), torch.logsumexp(sc, -1)


def _emulated_flash_bwd(q, k, v, out, lse, do, window, ties):
    """dq, dk, dv of causal GQA attention on (B, H, S, D) f32 tensors (k, v,
    dk, dv with KV heads) from the forward's out and lse, as the f32
    backward kernel: the chain's scores, split-TF32 products, f32
    elsewhere."""
    G, D, S = q.shape[1] // k.shape[1], q.shape[-1], q.shape[2]
    scale = 1.0 / math.sqrt(D)
    kg, vg = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    mask = _band(S, window)
    delta = (do * out).sum(-1, keepdim=True)
    sc = _chain_scores(q, kg) * scale
    p = torch.where(mask, torch.exp(sc - lse[..., None]), torch.zeros(()))
    ds = p * (_mm_tf32(do, vg.transpose(-1, -2), 1, 2, 2, ties) - delta) * scale
    dq = _mm_tf32(ds, kg, 4, 2, 1, ties)
    fold = lambda x: x.unflatten(1, (k.shape[1], G)).sum(2)  # noqa: E731
    dk = fold(_mm_tf32(ds.transpose(-1, -2), q, 8, 2, 1, ties))
    dv = fold(_mm_tf32(p.transpose(-1, -2), do, 8, 2, 1, ties))
    return dq, dk, dv


def _exact_flash(q, k, v, do, window):
    """The same in f64 through autograd."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    G, S = q.shape[1] // k.shape[1], q.shape[2]
    s = q @ k.repeat_interleave(G, 1).transpose(-1, -2) / math.sqrt(q.shape[-1])
    i = torch.arange(S)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window if window else True)
    s = s.masked_fill(~mask, float("-inf"))
    out = torch.softmax(s, -1) @ v.repeat_interleave(G, 1)
    out.backward(do.double())
    return out.detach(), torch.logsumexp(s, -1).detach(), q.grad, k.grad, v.grad


def _off(got, want, atol, rtol) -> int:
    return int(((got.double() - want).abs() > atol + rtol * want.abs()).sum())


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 96, 4, 1, 64, 0),   # MQA
    (2, 70, 4, 2, 40, 0),   # GQA, ragged, D an odd multiple of 8
    (1, 80, 2, 1, 32, 30),  # windowed
    (1, 200, 4, 1, 256, 0),  # gemma-2b's head dim: whole-depth runs would fail here
])
@pytest.mark.parametrize("score_std", [1.0, 100.0])
@pytest.mark.parametrize("ties", ["away", "even"])
def test_split_tf32_flash_error_model(B, S, H, KV, D, window, score_std, ties):
    """The emulated f32 backward kernel (dq, dk, dv) from the emulated f32
    forward's out and lse, held to the f64 gradients at the f32 kernels'
    tolerance, 5e-5 + 5e-4 rel.  Scores of unit size: every element
    within.  Scores in the hundreds (q and k of std 10, near-hard
    attention, as the reference's init gives): there plain f32 itself
    leaves elements off f64 (the port's plain backward,
    ``ref.flash_attention_bwd_ref``, from the same out and lse: checked
    below), so the largest error is held within 5e-4 of the largest
    entry."""
    rng = np.random.default_rng(S + D + window)
    amp = math.sqrt(score_std)
    q = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32) * amp)
    k = torch.from_numpy(rng.standard_normal((B, KV, S, D)).astype(np.float32) * amp)
    v, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             for sh in ((B, KV, S, D), (B, H, S, D)))
    want = _exact_flash(q, k, v, do, window)[2:]
    # the plain f32 forward and backward, (B, S, heads, D) as the wrappers take them
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    out = tk.ref.causal_attention_ref(qs, ks, vs, True, window)
    lse = tk.ref.attention_lse_ref(qs, ks, True, window)
    plain = [g.transpose(1, 2) for g in tk.ref.flash_attention_bwd_ref(
        qs, ks, vs, out, lse, dos, True, window)]
    got = _emulated_flash_bwd(q, k, v, *_emulated_flash_fwd(q, k, v, window), do, window, ties)
    for name, g, w, pl in zip(("dq", "dk", "dv"), got, want, plain):
        assert torch.isfinite(g).all(), name
        if score_std == 1.0:
            assert _off(g, w, 5e-5, 5e-4) == 0, name
        else:
            rel = ((g.double() - w).abs().max() / w.abs().max()).item()
            assert rel <= 5e-4, (name, rel)
    if score_std != 1.0 and D == 256:  # where plain f32 itself misses element-wise
        assert sum(_off(pl, w, 5e-5, 5e-4) for pl, w in zip(plain, want)) > 0


# ------------------------------------------------------------ rg-lru scan


@pytest.mark.parametrize("B,S,C,bt", [(2, 128, 128, 16), (4, 64, 256, 8),
                                      (1, 256, 128, 64)])
def test_rglru_scan_matches_pallas(B, S, C, bt):
    """At test_rglru_scan_sweep's shapes and inputs: the wrapper (its plain
    version on the CPU) and the plain version itself against the Pallas
    kernel in interpret mode and the JAX oracle, 1e-5 as there."""
    rng = np.random.default_rng(S + C)
    log_a = (-np.abs(rng.standard_normal((B, S, C))) * 0.2).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    want = jk.rglru_scan(jnp.asarray(log_a), jnp.asarray(b), block_b=min(2, B),
                         block_c=128, block_t=bt, interpret=True)
    oracle = jref.rglru_scan_ref(jnp.asarray(log_a), jnp.asarray(b))
    got = tk.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, C)
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ mlstm chunk

# 5e-5 abs + 5e-4 rel, as tests/test_kernels.py::test_mlstm_chunk_sweep
MLSTM_ATOL, MLSTM_RTOL = 5e-5, 5e-4


def _mlstm_inputs(B, S, H, dk, seed):
    """test_mlstm_chunk_sweep's inputs: i_pre ~ N - 2, f_pre ~ N + 3."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, dk)).astype(np.float32) for _ in range(3))
    i_pre = (rng.standard_normal((B, S, H)) - 2.0).astype(np.float32)
    f_pre = (rng.standard_normal((B, S, H)) + 3.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


@pytest.mark.parametrize("B,S,H,dk,chunk", [
    (1, 64, 2, 32, 16), (2, 128, 2, 64, 32), (1, 128, 4, 32, 64),
])
def test_mlstm_chunk_matches_pallas(B, S, H, dk, chunk):
    """The wrapper (its plain version on the CPU) against the Pallas kernel
    in interpret mode and against the sequential oracle of both packages;
    its final carry against the model's recurrence with ``return_final``."""
    from repro.models.recurrent import mlstm_chunk_recurrence

    inputs = _mlstm_inputs(B, S, H, dk, S + dk)
    jin = [jnp.asarray(a) for a in inputs]
    tin = [torch.from_numpy(a) for a in inputs]
    got, final = tk.mlstm_chunk(*tin, chunk=chunk, return_final=True)
    want = jk.mlstm_chunk(*jin, chunk=chunk, interpret=True)
    oracle = jref.mlstm_ref(*jin)
    for w in (want, oracle, tk.ref.mlstm_ref(*tin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=MLSTM_ATOL,
                                   rtol=MLSTM_RTOL)
    _, wfinal = mlstm_chunk_recurrence(*jin, chunk=chunk, return_final=True)
    for g, w in zip(final, wfinal):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MLSTM_ATOL,
                                   rtol=MLSTM_RTOL)
    assert torch.equal(tk.mlstm_chunk(*tin, chunk=chunk), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dk,chunk", [
    (1, 2048, 4, 384, 128),  # xlstm-125m's prefill
    (2, 256, 4, 384, 128),   # two batches, two chunks
    (1, 384, 2, 64, 128),    # dk one tile wide
    (1, 60, 2, 100, 20),     # dk off the tiles, chunk off 16
    (2, 96, 4, 64, 96),      # one chunk
    (1, 64, 2, 32, 16),      # dk under a tile
    (1, 8, 1, 512, 8),       # the widest dk the kernel takes
    (3, 7, 2, 1, 7),         # one column
])
def test_mlstm_plan_covers_every_column_and_chunk(B, S, H, dk, chunk, dtype):
    """The two passes' grids and the workspace, planned in the wrapper from
    the shapes: the state pass's tiles cover every dk row and value column
    of C once, the output pass's every value column of h, and the
    workspace holds one carry (C, n, m) for every (batch, head, chunk), with
    dk rounded up to whole 16 x 16 units of C."""
    from repro_torch.kernels.mlstm_chunk import ROW_PARTS, STATE_TILE, VALUE_TILE, _plan
    tdt = TDT[dtype]
    c = min(chunk, S)
    state_tiles, state_e_tiles, value_tiles, ws_floats = _plan(B, S, H, dk, c, tdt)
    # the tiles (consecutive, of a fixed width) reach past every dk row and
    # value column of C and of h, and none lies wholly past dk
    for tiles, width in ((state_tiles, STATE_TILE[tdt][0]), (state_e_tiles, STATE_TILE[tdt][1]),
                         (value_tiles, VALUE_TILE[tdt])):
        assert tiles * width >= dk > (tiles - 1) * width
    assert S % c == 0 and (S // c) * c == S  # the output grid's chunks tile S
    dkp = -(-dk // 16) * 16  # C in whole 16 x 16 units
    # f32: then the chained state pass's ticket counter and one flag per
    # (chunk, batch x head, tile of C)
    sync = 1 + B * H * (S // c) * state_tiles ** 2 if dtype == "float32" else 0
    assert ws_floats == B * H * (S // c) * (dkp * dkp + dkp + 1) + sync
    # the output pass's row parts (f32: the 32-row tiles p and 3 - p) take
    # every row of a chunk once; a chunk's q k^T is formed once a value tile
    parts = [_f32_out_rows(p, c) for p in range(ROW_PARTS[tdt])] if dtype == "float32" else [
        list(range(c))]
    assert sorted(r for part in parts for r in part) == list(range(c))
    assert value_tiles == -(-dk // 192)
    if dtype == "float32":
        for p in range(ROW_PARTS[tdt]):
            tiles = _causal_tiles(p, 3 - p, 32)
            assert len(tiles) == 68  # threads 192 .. 259 of csrc/mlstm_chunk.cu's output pass
            _assert_covers_causal(tiles, [rr for rr in _f32_out_rows(p, 128)], 32)
        if c == 128:  # the two parts' causal work is equal
            assert len({sum(r + 1 for r in _f32_out_rows(p, c)) for p in range(2)}) == 1
        if (B, S, H, dk, chunk) == (1, 2048, 4, 384, 128):  # xlstm's prefill fills the card
            assert (S // c) * B * H * state_tiles * state_e_tiles >= 132
            assert B * H * (S // c) * value_tiles * ROW_PARTS[tdt] >= 132


def _f32_out_rows(p: int, c: int) -> list:
    """The chunk rows of f32 output-pass row part p (csrc/mlstm_chunk.cu):
    its local rows 0 .. 31 are 32-row tile p, 32 .. 63 tile 3 - p; rows
    past c are idle."""
    return [r for r in list(range(32 * p, 32 * p + 32)) + list(range(32 * (3 - p), 128 - 32 * p))
            if r < c]


def _causal_tiles(lo: int, hi: int, tile: int) -> list:
    """The 8 x 8 tiles (local row band, column band) of the causal scores
    of two row tiles of ``tile`` rows, lo then hi, in the order the f32
    kernels hand them to their threads: each 8-row band up to its diagonal
    band."""
    out = []
    for half, t in enumerate((lo, hi)):
        for band in range(tile // 8):
            out += [((tile // 8) * half + band, cb) for cb in range(t * tile // 8 + band + 1)]
    return out


def _assert_covers_causal(tiles: list, rows: list, tile: int) -> None:
    """Every (local row r, column j <= chunk row of r) lies in exactly one
    8 x 8 tile, and no tile lies wholly above the diagonal."""
    seen = collections.Counter()
    for rb, cb in tiles:
        assert 8 * cb <= rows[8 * rb + 7] if 8 * rb + 7 < len(rows) else True
        for r in range(8 * rb, 8 * rb + 8):
            for j in range(8 * cb, 8 * cb + 8):
                if r < len(rows) and j <= rows[r]:
                    seen[(r, j)] += 1
    want = {(r, j) for r in range(len(rows)) for j in range(rows[r] + 1)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("B,S,H,dk,chunk", [
    (2, 1024, 4, 384, 128),  # xlstm-125m's training shape
    (1, 60, 2, 100, 20),     # dk off the tiles, chunk off 16
    (2, 96, 4, 64, 96),      # one chunk
    (1, 8, 1, 512, 8),       # the widest dk the kernel takes
    (3, 7, 2, 1, 7),         # one column
])
def test_mlstm_bwd_plan_covers_every_column_and_chunk(B, S, H, dk, chunk):
    """The backward's grids, planned in the wrapper from the shapes: the
    rows pass's groups cover every row of a chunk once, the moves and state
    passes' tiles every (dk row, value column) of the carry gradient, the grads
    pass's every column of dq, dk and dv, and the scores and gates passes
    every chunk; at xlstm-125m's shape each pass with real work launches at
    least one block per SM of the H100 (132)."""
    from repro_torch.kernels.mlstm_chunk import (BWD_ROW_GROUP, BWD_SCORE_BLOCKS,
                                                 BWD_TILE, _bwd_plan)
    c = min(chunk, S)
    plan = _bwd_plan(B, S, H, dk, c)
    nc = S // c
    groups = plan["rows"][2]
    assert groups * BWD_ROW_GROUP >= c > (groups - 1) * BWD_ROW_GROUP
    tiles = plan["state"][1]
    assert tiles * BWD_TILE >= dk > (tiles - 1) * BWD_TILE
    assert plan["state"] == (B * H, tiles, tiles)
    assert plan["moves"] == (B * H, nc - 1, tiles * tiles)  # chunk 0's move has no use
    assert plan["grads"] == (B * H, nc, 3 * tiles)  # dq, dk, dv x column tiles
    # the scores pass's blocks pair 16-row tiles z and 7 - z: every tile once
    pairs = sorted(t for z in range(BWD_SCORE_BLOCKS) for t in (z, 7 - z))
    assert pairs == list(range(2 * BWD_SCORE_BLOCKS)) and 16 * len(pairs) >= 128
    for name in ("rows", "scores", "gates"):
        assert plan[name][:2] == (B * H, nc)
    if (B, S, H, dk, chunk) == (2, 1024, 4, 384, 128):
        for name in ("rows", "moves", "state", "scores", "grads"):
            assert math.prod(plan[name]) >= 132, (name, plan[name])
    # f32 inputs run the same grids; a scores block's 34 threads of S (and
    # 34 of P) hold the causal 8 x 8 tiles of its two 16-row tiles, every
    # (i, j <= i) once; a grads block's 128 threads, rows tr + 16 a and
    # columns tc + 8 b, hold its 128 x 64 output once
    for z in range(BWD_SCORE_BLOCKS):
        tiles = _causal_tiles(z, 7 - z, 16)
        assert len(tiles) == 34
        _assert_covers_causal(tiles, list(range(16 * z, 16 * z + 16))
                              + list(range(16 * (7 - z), 16 * (8 - z))), 16)
    cells = collections.Counter((tr + 16 * a, tc + 8 * b) for tr in range(16) for tc in range(8)
                                for a in range(8) for b in range(8))
    assert set(cells) == {(r, col) for r in range(128) for col in range(BWD_TILE)}
    assert set(cells.values()) == {1}


# ------------------------ split-bf16 error model of the mLSTM backward
#
# csrc/mlstm_chunk_bwd.cu runs every product of the chunk backward on bf16
# tensor cores: q, k, v in bf16 enter as one exact term, every f32 operand
# (and q, k, v for f32 inputs) as three bf16 terms hi + mid + lo; an f32 x
# f32 product takes the six term products of order <= 2, an f32 x bf16 one
# three, in the kernel's order (by B's term from the smallest, then by A's);
# each 16-deep k-step's term products are summed by
# the tensor cores (exact products, the sum into the accumulator truncated
# toward zero) and then added to f32 running sums.  The emulation below
# runs the kernel header's equations with products so formed, from the
# forward's f32 den and carries, on inputs whose normalizers cancel: q
# scaled by 1000, so |h| reaches 1e3-1e4 where den cancels against the
# floor exp(-m_i).  With two terms (hi + lo, 16 bits) the products part
# from f64 by 10 to 40 times as much as f32 sums do.


def _bf16_terms(x: torch.Tensor, n: int) -> list:
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _mm_split(a: torch.Tensor, b: torch.Tensor, ta: int, tb: int) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in f32 from ta x tb bf16 terms, as
    the kernel's tensor cores form it; ta = tb = 0 is an f32 product, and
    a, b f64 give the exact one."""
    if ta == 0 or a.dtype == torch.float64:
        return a @ b
    pad = -a.shape[-1] % 16
    a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))
    A, Bt = _bf16_terms(a, ta), _bf16_terms(b, tb)
    order = max(ta, tb) - 1
    pairs = [(x, y) for y in range(tb - 1, -1, -1) for x in range(ta - 1, -1, -1)
             if x + y <= order]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for ks in range(a.shape[-1] // 16):
        sl = slice(16 * ks, 16 * ks + 16)
        part = torch.zeros_like(acc)
        for x, y in pairs:
            part = _rz(part.double() + A[x][..., sl].double() @ Bt[y][..., sl, :].double())
        acc = acc + part
    return acc


def _mlstm_fwd_state(q, k, v, log_i, log_f, c):
    """h, den and the carries (C, n, m) entering every chunk (m also
    leaving the last), as the forward kernel keeps them; q unscaled."""
    B, S, H, dk = q.shape
    scale = 1.0 / math.sqrt(dk)
    tri = torch.ones((c, c), dtype=torch.bool).tril()
    C, n, m = q.new_zeros((B, H, dk, dk)), q.new_zeros((B, H, dk)), q.new_zeros((B, H))
    hs, dens, carries = [], [], []
    for qt, kt, vt, li, lf in zip(*(tk.ref._by_chunk(x, c)
                                    for x in (q * scale, k, v, log_i, log_f))):
        carries.append((C, n, m))
        cs = torch.cumsum(lf, -1)
        D = (cs[..., :, None] - cs[..., None, :] + li[..., None, :]).masked_fill(~tri, -math.inf)
        mi = torch.maximum(D.amax(-1), cs + m[..., None])
        W = (qt @ kt.transpose(-1, -2)) * torch.exp(D - mi[..., None])
        inter = torch.exp(cs + m[..., None] - mi)
        den = W.sum(-1) + inter * (qt * n[..., None, :]).sum(-1)
        hs.append((W @ vt + inter[..., None] * (qt @ C))
                  / torch.maximum(den.abs(), torch.exp(-mi))[..., None])
        dens.append(den)
        dec = cs[..., -1:] - cs + li
        mn = torch.maximum(m + cs[..., -1], dec.amax(-1))
        wn, decay = torch.exp(dec - mn[..., None]), torch.exp(m + cs[..., -1] - mn)
        C = decay[..., None, None] * C + (kt * wn[..., None]).transpose(-1, -2) @ vt
        n = decay[..., None] * n + (wn[..., None] * kt).sum(-2)
        m = mn
    carries.append((None, None, m))
    return tk.ref._unchunk(hs), tk.ref._unchunk(dens), carries


def _mlstm_bwd_equations(q, k, v, log_i, log_f, h, den, carries, dh, c, tq, tf):
    """The kernel header's chunk backward (``ref.mlstm_chunk_bwd_state_ref``)
    with products of tq-term q, k, v and tf-term f32 operands
    (``_mm_split``; 0 terms: plain products)."""
    terms = {"in": tq, "f32": tf}
    return tk.ref.mlstm_chunk_bwd_state_ref(
        q, k, v, log_i, log_f, h, den, carries, dh, chunk=c,
        mm=lambda a, b, ka, kb: _mm_split(a, b, terms[ka], terms[kb]))


def _mlstm_bwd_inputs(dtype: str, seed: int = 2, H: int = 2):
    """(1, 256, H, 64): test_mlstm_chunk_sweep's gates (i_pre ~ N - 2,
    f_pre ~ N + 3) with q scaled by 1000, so the normalizers cancel; q, k,
    v rounded to ``dtype`` and held as f32."""
    rng = np.random.default_rng(seed)
    q, k, v, dh = (torch.from_numpy(rng.standard_normal((1, 256, H, 64)).astype(np.float32))
                   for _ in range(4))
    i_pre = torch.from_numpy((rng.standard_normal((1, 256, H)) - 2.0).astype(np.float32))
    f_pre = torch.from_numpy((rng.standard_normal((1, 256, H)) + 3.0).astype(np.float32))
    q, k, v = ((x * s).to(TDT[dtype]).float() for x, s in ((q, 1000.0), (k, 1.0), (v, 1.0)))
    return q, k, v, i_pre, torch.nn.functional.logsigmoid(f_pre), dh


def _rel(got, want) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def test_mlstm_bwd_state_ref_matches_autograd():
    """The plain version of the backward kernel's equations from the
    forward's saved state, in f64 from an f64 forward, against autograd
    through the chunk recurrence in f64: the same gradients to rounding."""
    q, k, v, log_i, log_f, dh = (x.double() for x in _mlstm_bwd_inputs("float32"))
    h, den, carries = _mlstm_fwd_state(q, k, v, log_i, log_f, 64)
    got = tk.ref.mlstm_chunk_bwd_state_ref(q, k, v, log_i, log_f, h, den, carries, dh, chunk=64)
    want = tk.ref.mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, chunk=64)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-12


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_bf16_mlstm_bwd_error_model(dtype):
    """The emulated backward kernel (three terms) against the plain f32
    version within MLSTM_ATOL + MLSTM_RTOL of each gradient's largest entry,
    and no farther from the f64 gradient than twice the plain version."""
    c = 64
    q, k, v, log_i, log_f, dh = _mlstm_bwd_inputs(dtype)
    h, den, carries = _mlstm_fwd_state(q, k, v, log_i, log_f, c)
    assert 1e3 <= h.abs().max().item() <= 1e4  # the normalizers cancel
    tq = 1 if dtype == "bfloat16" else 3
    got = _mlstm_bwd_equations(q, k, v, log_i, log_f, h, den, carries, dh, c, tq, 3)
    plain = tk.ref.mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, chunk=c)
    exact = tk.ref.mlstm_chunk_bwd_ref(*(x.double() for x in (q, k, v, log_i, log_f, dh)),
                                       chunk=c)
    for name, g, p, e in zip(("dq", "dk", "dv", "dlog_i", "dlog_f"), got, plain, exact):
        assert torch.isfinite(g).all(), name
        big = p.abs().max().item()
        assert (g - p).abs().max().item() <= MLSTM_ATOL + MLSTM_RTOL * big, name
        assert _rel(g, e) <= 2 * _rel(p, e), (name, _rel(g, e), _rel(p, e))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_bf16_mlstm_bwd_needs_three_terms(dtype):
    """From one forward's f32 den and carries, the equations' own rounding
    against their f64 evaluation: three terms stay within twice f32
    products' distance on every gradient (or 1e-6 of its largest entry);
    two terms (hi + lo) miss that on dq, dk and dv."""
    c = 64
    q, k, v, log_i, log_f, dh = _mlstm_bwd_inputs(dtype)
    fwd = _mlstm_fwd_state(q, k, v, log_i, log_f, c)
    wide = lambda x: x.double() if torch.is_tensor(x) else x  # noqa: E731
    exact = _mlstm_bwd_equations(
        *(x.double() for x in (q, k, v, log_i, log_f, fwd[0], fwd[1])),
        [tuple(wide(y) for y in cr) for cr in fwd[2]], dh.double(), c, 0, 0)
    f32 = _mlstm_bwd_equations(q, k, v, log_i, log_f, *fwd, dh, c, 0, 0)
    tq = 1 if dtype == "bfloat16" else 3
    three = _mlstm_bwd_equations(q, k, v, log_i, log_f, *fwd, dh, c, tq, 3)
    two = _mlstm_bwd_equations(q, k, v, log_i, log_f, *fwd, dh, c, min(tq, 2), 2)
    for i, name in enumerate(("dq", "dk", "dv", "dlog_i", "dlog_f")):
        assert _rel(three[i], exact[i]) <= max(2 * _rel(f32[i], exact[i]), 1e-6), name
        if i < 3:
            assert _rel(two[i], exact[i]) > max(2 * _rel(f32[i], exact[i]), 1e-6), name


# ------------------------- f32 summation orders of the mLSTM CUDA kernels
#
# f32 inputs run both mLSTM kernels on the CUDA cores, every product an f32
# FMA chain in a fixed order (csrc/mlstm_chunk.cu, csrc/mlstm_chunk_bwd.cu,
# "f32 passes" and namespace cc).  The emulation below forms each sum in
# that order, one rounding an FMA (the product of two f32 is exact in f64),
# and holds it, at xlstm-125m's reduced width (4 heads of 64, chunk 128),
# on inputs whose normalizers cancel (q scaled by 1000), against f64: no
# farther than twice plain f32's distance, as the split-bf16 emulation
# above is held.


def _fma(acc, a, b):
    """acc + a b in f32 with one rounding."""
    return (acc.astype(np.float64) + a.astype(np.float64) * b).astype(np.float32)


def _chunks_np(x, c):
    """(B, S, H, ...) torch -> (S / c) numpy arrays (B, H, c, ...)."""
    return [t.numpy() for t in tk.ref._by_chunk(x, c)]


def _blocked(acc, step, n, term):
    """acc plus the terms term(0 .. n - 1), each run of ``step`` of them an
    FMA chain from 0 added to acc."""
    for t0 in range(0, n, step):
        part = np.zeros_like(acc)
        for t in range(t0, min(n, t0 + step)):
            part = _fma(part, *term(t))
        acc = (acc + part).astype(np.float32)
    return acc


def _mlstm_fwd_f32_order(q, k, v, log_i, log_f, c):
    """h (B, S, H, dk) and the final (C, n) as the f32 kernels sum them:
    the state pass's C' = fma(decay, C, u), u = sum_j k_j (w_j v_j)^T in
    32-term FMA chains added to a running sum, n likewise; the output
    pass's q k^T, q C and q.n over dk (q scaled first)
    in 16-term FMA chains added to running sums, inter q C plus W v in
    32-term chains likewise, the row sums as 16 chains of 8 (lane j mod 4,
    then runs of 8) added in pairs, den = fma(inter, q.n, rowsum)."""
    B, S, H, dk = q.shape
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(dk))
    tri = np.tril(np.ones((c, c), dtype=bool))
    C, n, m = (np.zeros(s, f32) for s in ((B, H, dk, dk), (B, H, dk), (B, H)))
    hs = []
    for Q, K, V, LI, LF in zip(*(_chunks_np(x, c) for x in (q, k, v, log_i, log_f))):
        Q = (Q * scale).astype(f32)
        cs = np.cumsum(LF, -1, dtype=f32)
        D = np.where(tri, cs[..., :, None] - cs[..., None, :] + LI[..., None, :], -np.inf)
        mi = np.maximum(D.max(-1), cs + m[..., None]).astype(f32)
        E = np.where(tri, np.exp((D - mi[..., None]).astype(f32)), f32(0)).astype(f32)
        inter = np.exp((cs + m[..., None] - mi).astype(f32)).astype(f32)
        Sm = _blocked(np.zeros((B, H, c, c), f32), 16, dk,
                      lambda d: (Q[..., :, None, d], K[..., None, :, d]))
        qc = _blocked(np.zeros((B, H, c, dk), f32), 16, dk,
                      lambda d: (Q[..., :, d, None], C[..., None, d, :]))
        qn = _blocked(np.zeros((B, H, c), f32), 16, dk, lambda d: (Q[..., d], n[..., None, d]))
        W = (Sm * E).astype(f32)
        acc = _blocked((qc * inter[..., None]).astype(f32), 32, c,
                       lambda j: (W[..., :, j, None], V[..., None, j, :]))
        lanes = []
        for r in range(4):  # lane r: j = r + 4 (8 x + y), four chains of 8 added in pairs
            ch = []
            for x in range(4):
                y8 = np.zeros((B, H, c), f32)
                for y in range(8):
                    if r + 4 * (8 * x + y) < c:
                        y8 = (y8 + W[..., r + 4 * (8 * x + y)]).astype(f32)
                ch.append(y8)
            lanes.append(((ch[0] + ch[1]).astype(f32) + (ch[2] + ch[3]).astype(f32)).astype(f32))
        rs = ((lanes[0] + lanes[1]).astype(f32) + (lanes[2] + lanes[3]).astype(f32)).astype(f32)
        den = _fma(rs, inter, qn)
        lim = np.maximum(np.abs(den), np.exp(-mi).astype(f32))
        hs.append(torch.from_numpy((acc / lim[..., None]).astype(f32)))
        total = cs[..., -1]
        dec = (total[..., None] - cs + LI).astype(f32)
        mn = np.maximum(m + total, dec.max(-1)).astype(f32)
        w = np.exp((dec - mn[..., None]).astype(f32)).astype(f32)
        decay = np.exp((m + total - mn).astype(f32)).astype(f32)
        ve = (w[..., None] * V).astype(f32)
        u = _blocked(np.zeros((B, H, dk, dk), f32), 32, c,
                     lambda j: (K[..., j, :, None], ve[..., j, None, :]))
        un = _blocked(np.zeros((B, H, dk), f32), 32, c, lambda j: (w[..., j, None], K[..., j, :]))
        C = _fma(u, decay[..., None, None], C)
        n = _fma(un, decay[..., None], n)
        m = mn
    return tk.ref._unchunk(hs), torch.from_numpy(C), torch.from_numpy(n)


def test_f32_mlstm_forward_summation_order_near_f64():
    """The f32 forward kernel's summation orders (h, the final C and n) no
    farther from f64 than twice plain f32's (``mlstm_chunk_ref``)."""
    q, k, v, _log_i, _log_f, _dh = _mlstm_bwd_inputs("float32", seed=5, H=4)
    rng = np.random.default_rng(6)
    i_pre = torch.from_numpy((rng.standard_normal((1, 256, 4)) - 2.0).astype(np.float32))
    f_pre = torch.from_numpy((rng.standard_normal((1, 256, 4)) + 3.0).astype(np.float32))
    got = _mlstm_fwd_f32_order(q, k, v, i_pre, torch.nn.functional.logsigmoid(f_pre), 128)
    h, (C, n, _m) = tk.ref.mlstm_chunk_ref(q, k, v, i_pre, f_pre, chunk=128, return_final=True)
    he, (Ce, ne, _me) = tk.ref.mlstm_chunk_ref(*(x.double() for x in (q, k, v, i_pre, f_pre)),
                                               chunk=128, return_final=True)
    assert 1e3 <= he.abs().max().item()  # the normalizers cancel
    for name, g, p, e in zip(("h", "C", "n"), got, (h, C, n), (he, Ce, ne)):
        assert torch.isfinite(g).all(), name
        assert _rel(g, e) <= 2 * _rel(p, e), (name, _rel(g, e), _rel(p, e))


def _mlstm_bwd_f32_order(q, k, v, log_i, log_f, h, den, carries, dh, c):
    """dq, dk, dv as the f32 backward kernels sum them, from the forward's
    f32 state: G's moves U = u^T q and dn's as FMA chains over positions,
    walked back as fma(decay, G, U); S = q k^T and P = dnum v^T as FMA
    chains over dk; then each grads output an FMA chain over dk (dq: C
    dnum; dk: G v; dv: G^T k), turned into inter (. + dden n), w (. + dn)
    or w ., and the chain carried on over positions (dS k; dS^T (scale q);
    W^T dnum)."""
    B, S, H, dk = q.shape
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(dk))
    nc = S // c
    tri = np.tril(np.ones((c, c), dtype=bool))
    Q, K, V, LI, LF, DEN, Hh, DH = (_chunks_np(x, c) for x in (q, k, v, log_i, log_f, den, h, dh))
    rows = []
    for t in range(nc):
        cs, m = np.cumsum(LF[t], -1, dtype=f32), carries[t][2].numpy()
        D = np.where(tri, cs[..., :, None] - cs[..., None, :] + LI[t][..., None, :], -np.inf)
        mi = np.maximum(D.max(-1), cs + m[..., None]).astype(f32)
        floor = np.exp(-mi).astype(f32)
        lim = np.maximum(np.abs(DEN[t]), floor)
        on = (np.abs(DEN[t]) >= floor) & (DEN[t] != 0)
        dden = np.where(on, -(DH[t] * Hh[t]).sum(-1, dtype=f32) / np.where(on, DEN[t], 1), 0)
        if t + 1 < nc:
            mn = carries[t + 1][2].numpy()
            w = np.exp((cs[..., -1:] - cs + LI[t] - mn[..., None]).astype(f32)).astype(f32)
            decay = np.exp((m + cs[..., -1] - mn).astype(f32)).astype(f32)
        else:
            w, decay = np.zeros_like(cs), np.zeros_like(m)
        inter = np.exp((cs + m[..., None] - mi).astype(f32)).astype(f32)
        rows.append(dict(inter=inter, dden=dden.astype(f32), dnum=(DH[t] / lim[..., None]).astype(f32),
                         w=w, decay=decay,
                         E=np.where(tri, np.exp((D - mi[..., None]).astype(f32)), 0).astype(f32)))
    Gs, G, dn = [None] * nc, np.zeros((B, H, dk, dk), f32), np.zeros((B, H, dk), f32)
    for t in range(nc - 1, -1, -1):
        Gs[t] = (G, dn)
        if t == 0:
            break
        r = rows[t]
        u = (r["dnum"] * (scale * r["inter"]).astype(f32)[..., None]).astype(f32)
        U, un = np.zeros((B, H, dk, dk), f32), np.zeros((B, H, dk), f32)
        for i in range(c):
            U = _fma(U, Q[t][..., i, :, None], u[..., i, None, :])
            un = _fma(un, r["dden"][..., i, None],
                      (r["inter"][..., i, None] * (Q[t][..., i, :] * scale).astype(f32)).astype(f32))
        G = _fma(U, r["decay"][..., None, None], G)
        dn = _fma(un, r["decay"][..., None], dn)
    out = [[] for _ in range(3)]
    for t in range(nc):
        r, (C, n, _m), (G, dnv) = rows[t], carries[t], Gs[t]
        C, n = C.numpy(), n.numpy()
        Sm, P = np.zeros((B, H, c, c), f32), np.zeros((B, H, c, c), f32)
        for d in range(dk):
            Sm = _fma(Sm, Q[t][..., :, None, d], K[t][..., None, :, d])
            P = _fma(P, r["dnum"][..., :, None, d], V[t][..., None, :, d])
        W = ((Sm * scale).astype(f32) * r["E"]).astype(f32)
        dW = np.where(tri, (P + r["dden"][..., None]).astype(f32), 0).astype(f32)
        dS = (dW * r["E"]).astype(f32)
        qs = (Q[t] * scale).astype(f32)
        a0, a1, a2 = (np.zeros((B, H, c, dk), f32) for _ in range(3))
        for f in range(dk):
            a0 = _fma(a0, r["dnum"][..., :, f, None], C[..., None, :, f])  # C dnum: C[d][e]
            a1 = _fma(a1, V[t][..., :, f, None], G[..., None, :, f])        # G v
            a2 = _fma(a2, K[t][..., :, f, None], G[..., None, f, :])        # G^T k
        a0 = (r["inter"][..., None] * _fma(a0, r["dden"][..., None], n[..., None, :])).astype(f32)
        a1 = (r["w"][..., None] * (a1 + dnv[..., None, :]).astype(f32)).astype(f32)
        a2 = (r["w"][..., None] * a2).astype(f32)
        for j in range(c):
            a0 = _fma(a0, dS[..., :, j, None], K[t][..., None, j, :])
            a1 = _fma(a1, dS[..., j, :, None], qs[..., None, j, :])
            a2 = _fma(a2, W[..., j, :, None], r["dnum"][..., None, j, :])
        out[0].append(torch.from_numpy((a0 * scale).astype(f32)))
        out[1].append(torch.from_numpy(a1))
        out[2].append(torch.from_numpy(a2))
    return [tk.ref._unchunk(x) for x in out]


def test_f32_mlstm_backward_summation_order_near_f64():
    """From one forward's f32 den and carries, the f32 backward kernels'
    summation orders for dq, dk and dv no farther from the f64 evaluation
    of the same equations than twice the plain f32 evaluation
    (``ref.mlstm_chunk_bwd_state_ref``)."""
    c = 128
    q, k, v, log_i, log_f, dh = _mlstm_bwd_inputs("float32", seed=7, H=4)
    h, den, carries = _mlstm_fwd_state(q, k, v, log_i, log_f, c)
    assert 1e3 <= h.abs().max().item()  # the normalizers cancel
    got = _mlstm_bwd_f32_order(q, k, v, log_i, log_f, h, den, carries, dh, c)
    plain = tk.ref.mlstm_chunk_bwd_state_ref(q, k, v, log_i, log_f, h, den, carries, dh, chunk=c)
    wide = lambda x: x.double() if torch.is_tensor(x) else x  # noqa: E731
    exact = tk.ref.mlstm_chunk_bwd_state_ref(
        *(x.double() for x in (q, k, v, log_i, log_f, h, den)),
        [tuple(wide(y) for y in cr) for cr in carries], dh.double(), chunk=c)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        assert torch.isfinite(g).all(), name
        assert _rel(g, e) <= 2 * _rel(p, e), (name, _rel(g, e), _rel(p, e))
