"""The port's CUDA kernels and serving engines on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; the
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  The kernels are held against their plain
versions (the CPU tests hold those against the JAX package).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.models import ModelOptions, init_params
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # every f32 reference on the card stays f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7, 128), (2, 33, 256), (8, 2048), (64, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel(cuda, shape, dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    scale = torch.from_numpy((rng.standard_normal(shape[-1]) * 0.1).astype(np.float32))
    x, scale = x.to(cuda, TDT[dtype]), scale.to(cuda)
    before = kernels.rmsnorm.launches
    got = kernels.rmsnorm(x, scale)
    assert kernels.rmsnorm.launches == before + 1
    _close(got, kernels.ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,D,bs,T,lengths", [
    (2, 8, 2, 64, 16, 8, None),          # GQA
    (3, 4, 1, 128, 32, 4, None),         # MQA
    (1, 4, 4, 64, 8, 16, None),          # MHA
    (3, 4, 2, 32, 4, 4, [9, 0, 16]),     # an empty sequence, a full table
    (2, 4, 1, 32, 2, 8, [3, 40]),        # block size 2, a length past the table
    (8, 8, 1, 256, 16, 64, None),        # gemma-2b
    (8, 40, 8, 128, 16, 64, None),       # qwen3-14b
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel(cuda, B, H, KV, D, bs, T, lengths, dtype):
    rng = np.random.default_rng(7)
    n = B * T + 1
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(cuda, TDT[dtype])
                 for s in ((B, H, D), (n, bs, KV, D), (n, bs, KV, D)))
    if lengths is None:
        lengths = [max(1, (T * bs) // (i + 1) - 3) for i in range(B)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    tables = (torch.from_numpy(rng.permutation(n - 1) + 1).view(B, T)
              .to(cuda, torch.int32))
    used = (lens.clamp(max=T * bs) + bs - 1) // bs
    tables = torch.where(torch.arange(T, device=cuda)[None] < used[:, None],
                         tables, 0).to(torch.int32).contiguous()
    before = kernels.paged_decode_attention.launches
    got = kernels.paged_decode_attention(q, kp, vp, tables, lens)
    assert kernels.paged_decode_attention.launches == before + 1
    _close(got, kernels.ref.paged_decode_attention_ref(q, kp, vp, tables, lens),
           dtype)


@pytest.mark.gpu
def test_wrappers_check_inputs(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        kernels.rmsnorm(x.t(), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):  # scale not f32
        kernels.rmsnorm(x, torch.zeros(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):  # not f32/bf16
        kernels.rmsnorm(x.half(), torch.zeros(64, device=cuda))
    q = torch.zeros(2, 4, 32, device=cuda)
    pool = torch.zeros(5, 4, 2, 32, device=cuda)
    tables = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # int64 tables
        kernels.paged_decode_attention(q, pool, pool, tables.long(), lens)
    with pytest.raises(ValueError):  # H not a multiple of KV
        kernels.paged_decode_attention(q[:, :3], pool, pool, tables, lens)


@pytest.mark.gpu
def test_engine_kernel_path_matches_gather_path(cuda):
    cfg = reduced_config("qwen3-14b")
    params = init_params(cfg, seed=0, device=cuda)
    opts = ModelOptions(compute_dtype="float32")
    prompts = [[1, 5, 9, 2], [1, 5, 9, 2, 7, 3], [4, 4, 8], [1, 5, 9, 2, 6]]
    outs = {}
    for impl in ("kernel", "gather"):
        kernels.reset_launch_counts()
        eng = PagedServeEngine(cfg, params, num_blocks=24, block_size=4,
                               max_active=3, prefill_chunk=3, opts=opts,
                               attn_impl=impl)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        outs[impl] = {r.rid: r.generated for r in eng.run_until_drained(400)}
        launched = kernels.paged_decode_attention.launches
        assert (launched > 0) == (impl == "kernel")
        assert kernels.rmsnorm.launches > 0
    assert outs["kernel"] == outs["gather"]


def _randn(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, TDT[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel(cuda, D, G, causal, dtype):
    """Out and LSE against the plain version; S = 200 is off every tile."""
    rng = np.random.default_rng(D + G)
    B, S, KV = 2, 200, 2
    q = _randn(rng, (B, S, KV * G, D), cuda, dtype)
    k, v = (_randn(rng, (B, S, KV, D), cuda, dtype) for _ in range(2))
    before = kernels.flash_attention.launches
    got, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert kernels.flash_attention.launches == before + 1
    _close(got, kernels.ref.causal_attention_ref(q, k, v, causal), dtype)
    _close(lse, kernels.ref.attention_lse_ref(q, k, causal), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 1024, 8, 1, 256),   # gemma-2b
    (1, 512, 40, 8, 128),   # qwen3-14b
    (3, 1, 4, 4, 32),       # one token
    (1, 77, 80, 1, 64),     # G = 80: two head chunks of one KV head
    (2, 45, 6, 2, 72),      # D off the tensor cores' 16: the CUDA-core variant in bf16
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_shapes(cuda, B, S, H, KV, D, dtype):
    rng = np.random.default_rng(S + H)
    q = _randn(rng, (B, S, H, D), cuda, dtype)
    k, v = (_randn(rng, (B, S, KV, D), cuda, dtype) for _ in range(2))
    _close(kernels.flash_attention(q, k, v),
           kernels.ref.causal_attention_ref(q, k, v), dtype)


@pytest.mark.gpu
def test_flash_attention_kernel_unaligned_rows(cuda):
    """bf16 rows that do not start on 16-byte boundaries (a contiguous view
    2 bytes into its storage) take the CUDA-core variant: same function."""
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 1, 70, 4, 2, 64
    flat = _randn(rng, (B * S * H * D + 1,), cuda, "bfloat16")
    q = flat[1:].view(B, S, H, D)
    k, v = (_randn(rng, (B, S, KV, D), cuda, "bfloat16") for _ in range(2))
    got, lse = kernels.flash_attention(q, k, v, return_lse=True)
    _close(got, kernels.ref.causal_attention_ref(q, k, v), "bfloat16")
    _close(lse, kernels.ref.attention_lse_ref(q, k), "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,D,Smax,lengths", [
    (4, 8, 2, 64, 512, [512, 0, 37, 700]),     # full, empty, ragged, past Smax
    (3, 4, 1, 128, 1024, [1024, 1, 513]),
    (1, 4, 4, 64, 100, [100]),
    (2, 4, 2, 36, 50, [50, 17]),  # bf16 rows of 72 bytes: staged element by element
    (8, 8, 1, 256, 1024, [1025, 1024, 900, 700, 513, 300, 33, 1]),  # gemma-2b
    (8, 40, 8, 128, 1024, [1025, 1024, 900, 700, 513, 300, 33, 1]),  # qwen3-14b
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel(cuda, B, H, KV, D, Smax, lengths, dtype):
    rng = np.random.default_rng(B + H + D)
    q = _randn(rng, (B, H, D), cuda, dtype)
    kc, vc = (_randn(rng, (B, Smax, KV, D), cuda, dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = kernels.decode_attention.launches
    got = kernels.decode_attention(q, kc, vc, lens)
    assert kernels.decode_attention.launches == before + 1
    _close(got, kernels.ref.decode_attention_ref(q, kc, vc, lens), dtype)
    if 0 in lengths:  # an empty row attends to nothing: 0
        assert not got[lengths.index(0)].any()


@pytest.mark.gpu
def test_attention_wrappers_check_inputs(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):  # on the CPU beside a CUDA tensor
        kernels.flash_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError):  # not contiguous
        kernels.flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(TypeError):  # mixed dtypes
        kernels.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(TypeError):  # not f32/bf16
        kernels.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):  # H not a multiple of KV
        kernels.flash_attention(q[:, :, :3].contiguous(), kv, kv)
    wide = torch.zeros(1, 8, 1, 288, device=cuda)
    with pytest.raises(ValueError):  # head dim over the kernel's 256
        kernels.flash_attention(wide, wide, wide)
    qd = torch.zeros(2, 4, 32, device=cuda)
    cache = torch.zeros(2, 16, 2, 32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.decode_attention(qd.cpu(), cache, cache, lens)
    with pytest.raises(ValueError):  # not contiguous
        kernels.decode_attention(qd, cache.transpose(1, 2), cache, lens)
    with pytest.raises(TypeError):  # int64 lengths
        kernels.decode_attention(qd, cache, cache, lens.long())
    with pytest.raises(TypeError):  # bf16 caches for an f32 query
        kernels.decode_attention(qd, cache.bfloat16(), cache.bfloat16(), lens)
    big_q = torch.zeros(1, 128, 256, device=cuda)
    big = torch.zeros(1, 16, 1, 256, device=cuda)
    with pytest.raises(ValueError):  # G = 128 at D = 256: over the shared memory
        kernels.decode_attention(big_q, big, big, lens[:1])


@pytest.mark.gpu
def test_fixed_slot_engine_kernel_path_matches_plain_path(cuda):
    cfg = reduced_config("gemma-2b")
    params = init_params(cfg, seed=0, device=cuda)
    prompts = [[1, 5, 9, 2], [1, 5, 9, 2, 7, 3], [4, 4, 8], [1, 5, 9, 2, 6]]
    outs = {}
    for impl in ("kernel", "plain"):
        kernels.reset_launch_counts()
        eng = ServeEngine(cfg, params, num_slots=2, max_len=8,
                          opts=ModelOptions(compute_dtype="float32",
                                            attn_impl=impl))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        outs[impl] = {r.rid: r.generated for r in eng.run_until_drained(200)}
        assert (kernels.decode_attention.launches > 0) == (impl == "kernel")
    assert outs["kernel"] == outs["plain"]
    assert all(len(t) == 6 for t in outs["kernel"].values())
