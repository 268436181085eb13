"""The port's CUDA kernels, serving engines and train step on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; the
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch.  The kernels are held against their plain
versions (the CPU tests hold those against the JAX package).
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.convert import map_params
from repro_torch.models import (
    ModelOptions,
    decode_step,
    forward,
    forward_with_cache,
    init_params,
    loss_fn,
)
from repro_torch.models import layers as layers_mod
from repro_torch.models.layers import matmul_f32
from repro_torch.models.recurrent import _rglru_gates, init_rglru
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    lr_schedule,
    make_train_step,
)

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
@pytest.mark.parametrize("shape", [
    (7, 128), (2, 33, 256), (8, 2048), (64, 8, 128),
    # the prefill and training shapes: gemma-2b, recurrentgemma-9b, xlstm's
    # inner width, qwen3-14b's model width
    (1024, 2048), (2048, 2048), (4096, 4096), (2048, 1536), (3, 5120),
    (5, 100), (4, 770),  # widths no plan holds: the scalar variant
])
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
@pytest.mark.parametrize("d", [128, 2048, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_unaligned_rows(cuda, d, dtype):
    """Rows that start one element past a 16-byte boundary (a contiguous
    view at an odd offset, as ``layers.rmsnorm``'s ``x.contiguous()`` may
    pass) take the scalar variant and give the same result."""
    rng = np.random.default_rng(d)
    flat = torch.from_numpy(rng.standard_normal(6 * d + 1).astype(np.float32))
    x = flat.to(cuda, TDT[dtype])[1:].view(6, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)).to(cuda)
    _close(kernels.rmsnorm(x, scale), kernels.ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 2048), (64, 8, 128), (2048, 1536), (4, 4096),
                                   (3, 5120), (5, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_is_deterministic(cuda, shape, dtype):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, TDT[dtype])
    scale = torch.from_numpy((rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)).to(cuda)
    assert torch.equal(kernels.rmsnorm(x, scale), kernels.rmsnorm(x, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,D,bs,T,lengths", [
    (2, 8, 2, 64, 16, 8, None),          # GQA
    (3, 4, 1, 128, 32, 4, None),         # MQA
    (1, 4, 4, 64, 8, 16, None),          # MHA
    (3, 4, 2, 32, 4, 4, [9, 0, 16]),     # an empty sequence, a full table
    (2, 4, 1, 32, 2, 8, [3, 40]),        # block size 2, a length past the table
    (8, 8, 1, 256, 16, 64, None),        # gemma-2b
    (8, 40, 8, 128, 16, 64, None),       # qwen3-14b
    (8, 16, 16, 128, 16, 64, None),      # the MoE families: MHA, G = 1, D 128
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
@pytest.mark.parametrize("B,H,KV,D,bs,T", [
    (8, 8, 1, 256, 16, 64),   # gemma-2b
    (8, 40, 8, 128, 16, 64),  # qwen3-14b
    (4, 4, 1, 32, 2, 64),     # block size 2: far more splits than the sequences' pages
    (5, 8, 2, 64, 32, 8),     # block size 32
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_split_edges(cuda, B, H, KV, D, bs, T, dtype):
    """Lengths on and beside the split plan's chunk edges (the plan of the
    variant that runs: the CUDA-core split body for f32), 0 beside a full
    table, past the table, and a single token, each length in every slot."""
    from repro_torch.kernels.decode_attention import _paged_cuda_core_splits, _paged_splits
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if dtype == "float32":
        chunk, _n = _paged_cuda_core_splits(B, KV, T, bs, sms)
    else:
        chunk, _tile, _n = _paged_splits(B, KV, T, bs, 32, sms)
    edges = [chunk, chunk - 1, chunk + 1, 2 * chunk, 0, T * bs, T * bs + 7, 1]
    rng = np.random.default_rng(8)
    n = B * T + 1
    q, kp, vp = (_randn(rng, sh, cuda, dtype)
                 for sh in ((B, H, D), (n, bs, KV, D), (n, bs, KV, D)))
    perm = torch.from_numpy(rng.permutation(n - 1) + 1).view(B, T).to(cuda, torch.int32)
    for shift in range(len(edges)):
        lens = torch.tensor([edges[(i + shift) % len(edges)] for i in range(B)],
                            dtype=torch.int32, device=cuda)
        used = (lens.clamp(max=T * bs) + bs - 1) // bs
        tables = torch.where(torch.arange(T, device=cuda)[None] < used[:, None],
                             perm, 0).to(torch.int32).contiguous()
        got = kernels.paged_decode_attention(q, kp, vp, tables, lens)
        _close(got, kernels.ref.paged_decode_attention_ref(q, kp, vp, tables, lens), dtype)
        assert not got[lens == 0].any()


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
@pytest.mark.parametrize("G", [1, 5, 8, 16])
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
    (2, 1, 8, 1, 256),      # one token, gemma-2b's heads
    (1, 63, 8, 1, 128),     # one key below a 64-key tile
    (1, 65, 8, 1, 128),     # one key above it
    (1, 127, 16, 1, 64),    # around two tiles, 4 positions a q tile
    (1, 129, 16, 1, 64),
    (1, 1000, 8, 1, 256),   # ragged, gemma-2b's heads
    (1, 2048, 16, 16, 128),  # the MoE families' prefill: MHA at D 128
    (1, 1024, 32, 32, 64),   # musicgen-large: MHA at D 64
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_shapes(cuda, B, S, H, KV, D, dtype):
    rng = np.random.default_rng(S + H)
    q = _randn(rng, (B, S, H, D), cuda, dtype)
    k, v = (_randn(rng, (B, S, KV, D), cuda, dtype) for _ in range(2))
    got, lse = kernels.flash_attention(q, k, v, return_lse=True)
    _close(got, kernels.ref.causal_attention_ref(q, k, v), dtype)
    _close(lse, kernels.ref.attention_lse_ref(q, k), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 1000, 8, 1, 256, 0),     # gemma-2b's heads, causal
    (2, 1024, 8, 1, 256, 0),     # the train step's batch: a second wave of blocks
    (1, 300, 16, 1, 256, 100),   # recurrentgemma-9b's heads, windowed
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_is_deterministic(cuda, B, S, H, KV, D, window, dtype):
    """Two launches on the same inputs give the same bits, output and LSE:
    no atomics, and the warps' partials merge in a fixed order."""
    rng = np.random.default_rng(S + window)
    q = _randn(rng, (B, S, H, D), cuda, dtype)
    k, v = (_randn(rng, (B, S, KV, D), cuda, dtype) for _ in range(2))
    out1, lse1 = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    out2, lse2 = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)


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
    # the serving shapes (the split plan's chunks: 64 positions each)
    (4, 8, 1, 256, 256, [257, 0, 63, 65]),    # fixed-slot serve: past Smax, 0, chunk +- 1
    (4, 8, 1, 256, 256, [1, 64, 255, 256]),
    (1, 8, 1, 256, 1024, [1017]),             # decode after a 1024-token prefill
    (1, 16, 1, 256, 2048, [2049]),            # recurrentgemma-9b's ring, G = 16
    (8, 8, 1, 128, 1024, [63, 65, 64, 0, 1, 1025, 129, 127]),  # past the first chunk's tile
    (2, 10, 2, 128, 300, [65, 63]),           # G = 5
    (2, 32, 2, 64, 200, [0, 129]),            # G = 16
    # the MoE families (MHA, G = 1, D 128): fixed-slot serve, decode after
    # a 2048-token prefill
    (4, 16, 16, 128, 256, [257, 0, 63, 200]),
    (1, 16, 16, 128, 2064, [2049]),
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
@pytest.mark.parametrize("B,H,KV,D,Smax,lengths", [
    (4, 8, 2, 64, 512, [512, 0, 37, 700]),     # full, empty, ragged, past Smax
    (8, 8, 1, 256, 1024, [1025, 1024, 900, 700, 513, 300, 33, 0]),  # gemma-2b
    (8, 40, 8, 128, 1024, [1025, 1024, 900, 700, 513, 300, 33, 1]),  # qwen3-14b
    (2, 32, 2, 64, 200, [0, 129]),             # G = 16: the CUDA-core body in bf16
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_lse(cuda, B, H, KV, D, Smax, lengths, dtype):
    """The log-sum-exp output of either decode body against the plain
    version's (-1e30 for an empty row), and the output's bits the call's
    without it."""
    rng = np.random.default_rng(B + H + D + 1)
    q = _randn(rng, (B, H, D), cuda, dtype)
    kc, vc = (_randn(rng, (B, Smax, KV, D), cuda, dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got, lse = kernels.decode_attention(q, kc, vc, lens, return_lse=True)
    want, want_lse = kernels.ref.decode_attention_ref(q, kc, vc, lens, return_lse=True)
    assert torch.equal(got, kernels.decode_attention(q, kc, vc, lens))
    _close(got, want, dtype)
    _close(lse, want_lse, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("n,lengths", [(2, [512, 0, 37, 700]), (16, [512, 1, 37, 300])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_partials_kernel(cuda, n, lengths, dtype):
    """The merge of n slices' decode outputs and log-sum-exps (empty slices
    among them) against the plain merge and the plain decode over the
    whole cache; two launches give the same bits."""
    rng = np.random.default_rng(n)
    B, H, KV, D, Smax = 4, 8, 2, 64, 512
    q = _randn(rng, (B, H, D), cuda, dtype)
    kc, vc = (_randn(rng, (B, Smax, KV, D), cuda, dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    size = Smax // n
    parts = [kernels.decode_attention(
        q, kc[:, r * size:(r + 1) * size].contiguous(), vc[:, r * size:(r + 1) * size]
        .contiguous(), torch.clamp(torch.clamp(lens, max=Smax) - r * size, 0, size)
        .to(torch.int32), return_lse=True) for r in range(n)]
    o, lse = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    before = kernels.merge_partials.launches
    got = kernels.merge_partials(o, lse)
    assert kernels.merge_partials.launches == before + 1
    assert torch.equal(got, kernels.merge_partials(o, lse))
    _close(got, kernels.ref.merge_partials_ref(o, lse), dtype)
    _close(got, kernels.ref.decode_attention_ref(q, kc, vc, lens), dtype)
    if 0 in lengths:  # every slice empty: 0
        assert not got[lengths.index(0)].any()


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,D,Smax,dtype", [
    (8, 8, 1, 256, 1024, "float32"),    # gemma-2b
    (8, 40, 8, 128, 1024, "float32"),   # qwen3-14b
    (1, 16, 1, 256, 2048, "float32"),   # recurrentgemma-9b's ring
    (4, 8, 1, 256, 256, "float32"),     # the fixed-slot serve
    (3, 8, 2, 512, 300, "float32"),     # D 512: 8-key tiles
    (2, 2, 1, 879, 100, "float32"),     # D 879: one key group, 32 elements a lane
    (4, 8, 1, 36, 300, "bfloat16"),     # D 36: the tensor cores refuse it
    (4, 64, 2, 64, 300, "bfloat16"),    # G 32: refused too; two passes a chunk
])
def test_decode_attention_kernel_split_edges(cuda, B, H, KV, D, Smax, dtype):
    """The CUDA-core split body at lengths on and beside its plan's chunk
    edges: 0, 1, chunk +- 1, 2 chunk, Smax, past Smax, each in every slot."""
    from repro_torch.kernels.decode_attention import CUDA_CORE_PLAN, _splits
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk, _n = _splits(B, KV, Smax, sms, CUDA_CORE_PLAN)
    edges = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, Smax, Smax + 9]
    rng = np.random.default_rng(B * H + D)
    q = _randn(rng, (B, H, D), cuda, dtype)
    kc, vc = (_randn(rng, (B, Smax, KV, D), cuda, dtype) for _ in range(2))
    for shift in range(len(edges)):
        lens = torch.tensor([edges[(i + shift) % len(edges)] for i in range(B)],
                            dtype=torch.int32, device=cuda)
        got = kernels.decode_attention(q, kc, vc, lens)
        _close(got, kernels.ref.decode_attention_ref(q, kc, vc, lens), dtype)
        assert not got[lens == 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [("float32", 256), ("float32", 128), ("bfloat16", 36)])
def test_cuda_core_decode_gives_the_same_bits_twice(cuda, dtype, D):
    """The CUDA-core split body, dense and (f32) paged: no atomics, sums in
    a fixed order, so a second call gives the same bits."""
    rng = np.random.default_rng(D)
    B, H, KV, Smax, bs = 8, 8, 1, 1024, 16
    q = _randn(rng, (B, H, D), cuda, dtype)
    kc, vc = (_randn(rng, (B, Smax, KV, D), cuda, dtype) for _ in range(2))
    lens = torch.tensor([1025, 1024, 900, 700, 513, 300, 33, 1], dtype=torch.int32,
                        device=cuda)
    assert torch.equal(kernels.decode_attention(q, kc, vc, lens),
                       kernels.decode_attention(q, kc, vc, lens))
    if dtype == "float32":
        T = Smax // bs
        tables = (torch.from_numpy(rng.permutation(B * T) + 1).view(B, T)
                  .to(cuda, torch.int32))
        pool_k, pool_v = (_randn(rng, (B * T + 1, bs, KV, D), cuda, dtype) for _ in range(2))
        assert torch.equal(kernels.paged_decode_attention(q, pool_k, pool_v, tables, lens),
                           kernels.paged_decode_attention(q, pool_k, pool_v, tables, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,D,bs,T", [
    (8, 8, 1, 256, 16, 64),    # gemma-2b
    (8, 40, 8, 128, 16, 64),   # qwen3-14b
    (3, 4, 2, 64, 2, 40),      # pages of 2
    (2, 8, 1, 128, 48, 6),     # pages of 48
])
def test_paged_f32_matches_dense_f32_on_the_same_rows(cuda, B, H, KV, D, bs, T):
    """f32 K/V rows in shuffled pages give what the dense f32 kernel gives on
    the same rows gathered into a cache, within 2e-5: the two entry points
    share one split body."""
    rng = np.random.default_rng(T + bs)
    q = _randn(rng, (B, H, D), cuda, "float32")
    pool_k, pool_v = (_randn(rng, (B * T + 1, bs, KV, D), cuda, "float32") for _ in range(2))
    tables = (torch.from_numpy(rng.permutation(B * T) + 1).view(B, T).to(cuda, torch.int32))
    lens = torch.tensor([max(1, (T * bs) // (i + 1) - 3) for i in range(B)],
                        dtype=torch.int32, device=cuda)
    kc, vc = (p[tables.long()].reshape(B, T * bs, KV, D).contiguous() for p in (pool_k, pool_v))
    before = kernels.paged_decode_attention.launches
    got = kernels.paged_decode_attention(q, pool_k, pool_v, tables, lens)
    assert kernels.paged_decode_attention.launches == before + 1
    _close(got, kernels.decode_attention(q, kc, vc, lens), "float32")


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


# ------------------------------------------------------------- training


def _bwd_inputs(rng, B, S, H, KV, D, cuda, dtype):
    q = _randn(rng, (B, S, H, D), cuda, dtype)
    k, v = (_randn(rng, (B, S, KV, D), cuda, dtype) for _ in range(2))
    do = _randn(rng, (B, S, H, D), cuda, dtype)
    out, lse = kernels.flash_attention(q, k, v, return_lse=True)
    return q, k, v, out, lse, do


def _bwd_close(got, want, dtype):
    """f32: 5e-5 abs + 5e-4 rel (tests/test_kernels.py::
    test_flash_attention_backward_kernels); bf16: 2e-2 of the output's
    largest entry (one bf16 rounding of a sum of f32 products)."""
    torch.cuda.synchronize()
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-4)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])  # MHA, GQA, MQA
@pytest.mark.parametrize("S", [128, 200, 1000])  # on the tiles, and ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_kernel(cuda, D, H, KV, S, dtype):
    """dq, dk, dv against ``flash_attention_bwd_ref`` on the forward
    kernel's own (out, lse)."""
    rng = np.random.default_rng(D + H + KV + S)
    inputs = _bwd_inputs(rng, 2, S, H, KV, D, cuda, dtype)
    before = kernels.flash_attention_bwd.launches
    got = kernels.flash_attention_bwd(*inputs)
    assert kernels.flash_attention_bwd.launches == before + 1
    want = kernels.ref.flash_attention_bwd_ref(*inputs)
    for g, w, like in zip(got, want, inputs[:3]):
        assert g.dtype == like.dtype and g.shape == like.shape
        _bwd_close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_kernel_full_and_wide_groups(cuda, causal, dtype):
    """Non-causal, and G = 80 (two head chunks of one KV head)."""
    rng = np.random.default_rng(11)
    q = _randn(rng, (1, 77, 80, 64), cuda, dtype)
    k, v = (_randn(rng, (1, 77, 1, 64), cuda, dtype) for _ in range(2))
    do = _randn(rng, (1, 77, 80, 64), cuda, dtype)
    out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = kernels.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    want = kernels.ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    for g, w in zip(got, want):
        _bwd_close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 1000), (2, 1024)])  # ragged; gemma-2b's train step
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_kernel_is_deterministic(cuda, B, S, dtype):
    rng = np.random.default_rng(12)
    inputs = _bwd_inputs(rng, B, S, 8, 1, 256, cuda, dtype)
    a = kernels.flash_attention_bwd(*inputs)
    b = kernels.flash_attention_bwd(*inputs)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_flash_attention_train_gradients(cuda):
    """Autograd through ``flash_attention_train`` (both kernels) against
    autograd through the plain attention."""
    rng = np.random.default_rng(13)
    q = _randn(rng, (2, 150, 8, 64), cuda, "float32")
    k, v = (_randn(rng, (2, 150, 2, 64), cuda, "float32") for _ in range(2))
    w = _randn(rng, (2, 150, 8, 64), cuda, "float32")
    grads = {}
    kernels.reset_launch_counts()
    for name, fn in (("kernel", kernels.flash_attention_train),
                     ("plain", kernels.ref.causal_attention_ref)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    assert kernels.flash_attention.launches == 1
    assert kernels.flash_attention_bwd.launches == 1
    for g, w_ in zip(grads["kernel"], grads["plain"]):
        _bwd_close(g, w_, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_gradients(cuda, dtype):
    rng = np.random.default_rng(14)
    x = _randn(rng, (4, 33, 256), cuda, dtype)
    scale = _randn(rng, (256,), cuda, "float32") * 0.1
    dy = _randn(rng, (4, 33, 256), cuda, dtype)
    grads = {}
    for name, fn in (("kernel", kernels.rmsnorm), ("plain", kernels.ref.rmsnorm_ref)):
        xl, sl = x.clone().requires_grad_(), scale.clone().requires_grad_()
        fn(xl, sl).backward(dy)
        grads[name] = (xl.grad, sl.grad)
    assert grads["kernel"][0].dtype == x.dtype
    _close(grads["kernel"][0], grads["plain"][0], dtype)
    ds_k, ds_p = grads["kernel"][1], grads["plain"][1]
    assert (ds_k - ds_p).abs().max() <= TOL[dtype] * ds_p.abs().max()


@pytest.mark.gpu
def test_matmul_f32_gradients(cuda):
    """bf16 operands, f32 product: the incoming f32 gradient is rounded to
    the operands' dtype and the gradients are its products with them, held
    to f32 products of the same bf16 values within 2e-2 of the largest
    entry (one bf16 rounding of the result)."""
    rng = np.random.default_rng(15)
    a = _randn(rng, (3, 40, 64), cuda, "bfloat16").requires_grad_()
    b = _randn(rng, (64, 96), cuda, "bfloat16").requires_grad_()
    g = _randn(rng, (3, 40, 96), cuda, "float32")
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.float() @ b.float(), atol=1e-3, rtol=1e-3)
    out.backward(g)
    g16 = g.bfloat16().float()
    want_a = g16 @ b.float().t()
    want_b = torch.einsum("bmk,bmn->kn", a.float(), g16)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    for got, want in ((a.grad, want_a), (b.grad, want_b)):
        assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()


def _leaves(tree) -> list:
    out = []
    map_params(lambda _k, t: out.append(t), tree)
    return out


def _batch(cfg, B, S, seed, device):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))).to(device)
    return {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_kernel_path_gives_every_parameter_its_gradient(cuda, remat):
    """``loss.backward()`` through ``forward`` with the kernels reaches
    every parameter, and each gradient is within 1e-4 of the largest entry
    of that leaf's gradient from the plain path (reduced gemma-2b, f32)."""
    cfg = reduced_config("gemma-2b")
    base = init_params(cfg, seed=0, device=cuda)
    batch = _batch(cfg, 2, 64, 3, cuda)
    grads = {}
    for impl in ("kernel", "plain"):
        params = _clone(base)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_()
        kernels.reset_launch_counts()
        loss, _ = loss_fn(params, cfg, batch,
                          ModelOptions(compute_dtype="float32", attn_impl=impl),
                          remat=remat)
        loss.backward()
        assert (kernels.flash_attention_bwd.launches > 0) == (impl == "kernel")
        missing = [i for i, p in enumerate(leaves) if p.grad is None]
        assert not missing, f"{impl}: leaves {missing} have grad None"
        grads[impl] = [p.grad for p in leaves]
    for gk, gp in zip(grads["kernel"], grads["plain"]):
        assert (gk - gp).abs().max() <= 1e-4 * gp.abs().max(), (gk - gp).abs().max()


@pytest.mark.gpu
def test_train_step_kernel_path_matches_plain_path(cuda):
    """One train step of reduced gemma-2b in f32 from the same state,
    kernels against plain: loss, grad norm, and the step's clipped gradient
    (its first moment over 1 - b1) within 1e-4 of each leaf's largest
    entry.  Each path's change to every leaf within 1e-3 of its largest
    against the first AdamW step in closed form from that gradient, -lr *
    (g / (|g| + eps) + decay * p), at an lr (2.5e-3) whose change f32
    parameters resolve to that bound.  The parameters
    themselves are not compared across the paths: that direction turns
    any part between two correct gradients into a sign flip where an
    entry is near eps.  Two runs of the kernel path agree bit for bit."""
    cfg = reduced_config("gemma-2b")
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=4)
    tcfg = TrainConfig(optimizer=ocfg, remat=True)
    base = init_params(cfg, seed=0, device=cuda)
    p0 = _leaves(base)
    batch = _batch(cfg, 2, 64, 4, cuda)
    lr = lr_schedule(ocfg, 0)
    results = []
    for impl in ("kernel", "plain", "kernel"):
        state = init_train_state(cfg, tcfg, params=_clone(base))
        step = make_train_step(cfg, tcfg,
                               ModelOptions(compute_dtype="float32", attn_impl=impl))
        state, m = step(state, batch)
        g = [x / (1 - ocfg.b1) for x in _leaves(state["opt"]["m"])]
        for a, b, gi in zip(p0, _leaves(state["params"]), g):
            want = -lr * (gi / (gi.abs() + ocfg.eps) + ocfg.weight_decay * a)
            assert ((b.detach() - a) - want).abs().max() <= 1e-3 * want.abs().max()
        results.append((m, g, _leaves(state["params"])))
    (mk, gk, pk), (mp, gp, _), (mk2, _, pk2) = results
    assert abs(mk["loss"].item() - mp["loss"].item()) <= 1e-5 * abs(mp["loss"].item())
    assert abs(mk["grad_norm"].item() - mp["grad_norm"].item()) <= 1e-4 * mp["grad_norm"].item()
    for a, b in zip(gk, gp):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    assert mk["loss"].item() == mk2["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(pk, pk2))


def _clone(params):
    return map_params(lambda _k, p: p.detach().clone(), params)


# ------------------------------------------------- recurrent families' kernels

# mLSTM against its plain version: 5e-5 abs + 5e-4 rel, as
# tests/test_kernels.py::test_mlstm_chunk_sweep (both sides widen bf16 inputs
# to f32 exactly and sum in another order)
MLSTM_ATOL, MLSTM_RTOL = 5e-5, 5e-4


RGLRU_STEPS = 128  # time steps of a stage of csrc/rglru_scan.cu (kSteps)


def _rglru_inputs(rng, B, S, C, device):
    """The inputs of test_rglru_scan_sweep: log_a = -0.2 |N|, b ~ N."""
    log_a = -(_randn(rng, (B, S, C), device, "float32").abs() * 0.2)
    return log_a, _randn(rng, (B, S, C), device, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,C", [
    (2, 128, 128), (4, 64, 256), (1, 256, 128),  # test_rglru_scan_sweep's
    (3, 37, 100),                                # ragged everywhere
    (1, 1000, 4096),                             # recurrentgemma-9b's width
    # the ring's edges: a stage short of, at and one past 10 stages
    (2, 10 * RGLRU_STEPS - 1, 128), (2, 10 * RGLRU_STEPS, 128),
    (2, 10 * RGLRU_STEPS + 1, 128),
    (2, 300, 4), (2, 300, 36), (1, 200, 4100),   # C off the 32-channel blocks
    (2, 130, 37),                                # C off the 16-byte pieces
    (4, 1024, 4096), (1, 16384, 4096),           # a batch; a long sequence
])
def test_rglru_scan_kernel(cuda, B, S, C):
    rng = np.random.default_rng(S + C)
    log_a, b = _rglru_inputs(rng, B, S, C, cuda)
    before = kernels.rglru_scan.launches
    got = kernels.rglru_scan(log_a, b)
    assert kernels.rglru_scan.launches == before + 1
    torch.cuda.synchronize()
    # f32, 1e-5 abs + rel, as tests/test_kernels.py::test_rglru_scan_sweep
    torch.testing.assert_close(got, kernels.ref.rglru_scan_ref(log_a, b),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,C", [(1, 4096, 4096), (3, 37, 100), (2, 130, 37)])
def test_rglru_scan_kernel_is_deterministic(cuda, B, S, C):
    """Two calls agree bit for bit; so do inputs that start one element past
    a 16-byte boundary (the scalar copies), since every variant computes
    each step as fma(exp(log_a), h, b) in sequence."""
    rng = np.random.default_rng(B + S + C)
    log_a, b = _rglru_inputs(rng, B, S, C, cuda)
    first = kernels.rglru_scan(log_a, b)
    assert torch.equal(kernels.rglru_scan(log_a, b), first)
    n = log_a.numel()
    flat = torch.empty(2, n + 1, device=cuda)
    flat[0, 1:], flat[1, 1:] = log_a.reshape(-1), b.reshape(-1)
    shifted = (flat[0, 1:].view(B, S, C), flat[1, 1:].view(B, S, C))
    assert shifted[0].data_ptr() % 16 and shifted[0].is_contiguous()
    assert torch.equal(kernels.rglru_scan(*shifted), first)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d_rnn", [(1, 4096, 4096), (2, 2048, 1024)])
def test_rglru_scan_kernel_on_recurrentgemma_decay(cuda, B, S, d_rnn):
    """log_a and b as recurrentgemma's RG-LRU layer makes them: a =
    exp(-c softplus(lam) r) from init_rglru's lam (a in [0.9, 0.999] at r =
    1) and a sigmoid gate r, b = sqrt(1 - a^2) i x.  a lies close to 1, so h
    carries a long memory."""
    gen = torch.Generator(device=cuda).manual_seed(S + d_rnn)
    params = init_rglru(gen, 8, d_rnn, 4)
    xr = torch.randn(B, S, d_rnn, generator=gen, device=cuda)
    with torch.no_grad():
        log_a, b = _rglru_gates(params, xr)
    log_a, b = log_a.contiguous(), b.contiguous()
    assert log_a.min().item() > -0.2  # a > 0.8 everywhere
    got = kernels.rglru_scan(log_a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kernels.ref.rglru_scan_ref(log_a, b),
                               atol=1e-5, rtol=1e-5)


def _mlstm_inputs(rng, B, S, H, dk, device, dtype):
    """The inputs of test_mlstm_chunk_sweep: i_pre ~ N - 2, f_pre ~ N + 3."""
    q, k, v = (_randn(rng, (B, S, H, dk), device, dtype) for _ in range(3))
    i_pre = _randn(rng, (B, S, H), device, "float32") - 2.0
    f_pre = _randn(rng, (B, S, H), device, "float32") + 3.0
    return q, k, v, i_pre, f_pre


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dk,chunk", [
    (1, 64, 2, 32, 16), (2, 128, 2, 64, 32), (1, 128, 4, 32, 64),  # the sweep's
    (1, 60, 2, 100, 20),    # dk off the tiles (and off 8: no 16-byte pieces), chunk off 16
    (1, 512, 4, 384, 128),  # xlstm-125m's width
    (2, 96, 4, 64, 96),     # xlstm's reduced width, one chunk of 96
    (1, 2048, 4, 384, 128),  # xlstm-125m's prefill, the full shape
    (2, 256, 4, 384, 128),  # two batches, two chunks
    (1, 384, 2, 64, 128),   # dk within one value tile
    (1, 4096, 2, 64, 128),  # 32 chunks: two groups of the state pass's gates
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunk_kernel(cuda, B, S, H, dk, chunk, dtype):
    """h and the final carry against the plain chunkwise recurrence; h also
    against the sequential oracle at the sweep's shapes."""
    rng = np.random.default_rng(S + dk)
    inputs = _mlstm_inputs(rng, B, S, H, dk, cuda, dtype)
    before = kernels.mlstm_chunk.launches
    h, (C, n, m) = kernels.mlstm_chunk(*inputs, chunk=chunk, return_final=True)
    assert kernels.mlstm_chunk.launches == before + 1
    want, (Cw, nw, mw) = kernels.ref.mlstm_chunk_ref(*inputs, chunk=chunk,
                                                     return_final=True)
    torch.cuda.synchronize()
    assert h.dtype == torch.float32 and h.shape == (B, S, H, dk)
    for got, ref in ((h, want), (C, Cw), (n, nw), (m, mw)):
        torch.testing.assert_close(got, ref, atol=MLSTM_ATOL, rtol=MLSTM_RTOL)
    assert torch.equal(kernels.mlstm_chunk(*inputs, chunk=chunk), h)
    if S <= 128:
        torch.testing.assert_close(h, kernels.ref.mlstm_ref(*inputs),
                                   atol=MLSTM_ATOL, rtol=MLSTM_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunk_kernel_is_deterministic(cuda, dtype):
    """Two calls give equal bits: the forward with its final carry at
    xlstm-125m's prefill shape, and for f32 inputs the backward at its
    training shape on the forward's workspace (every sum of both kernels
    has one fixed order, with no atomics)."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.mlstm_chunk")
    rng = np.random.default_rng(41)
    inputs = _mlstm_inputs(rng, 1, 2048, 4, 384, cuda, dtype)
    h, final = kernels.mlstm_chunk(*inputs, chunk=128, return_final=True)
    h2, final2 = kernels.mlstm_chunk(*inputs, chunk=128, return_final=True)
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and all(torch.equal(x, y) for x, y in zip(final, final2))
    if dtype != "float32":
        return
    B, S, H, dk, chunk = 2, 1024, 4, 384, 128
    q, k, v = (_randn(rng, (B, S, H, dk), cuda, dtype) for _ in range(3))
    log_i = _randn(rng, (B, S, H), cuda, "float32") - 2.0
    log_f = torch.nn.functional.logsigmoid(_randn(rng, (B, S, H), cuda, "float32") + 3.0)
    dh = _randn(rng, (B, S, H, dk), cuda, "float32")
    h, _, (ws, den) = mod.mlstm_chunk_fwd(q, k, v, log_i, log_f, chunk=chunk, keep=True)
    args = (q, k, v, log_i, log_f, ws, den, h, dh)
    got = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
    again = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in got)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 200, 4, 1, 64, 64),      # S off the tiles, window on them
    (2, 256, 8, 2, 128, 100),    # window off the tiles
    (1, 1000, 16, 1, 256, 300),  # recurrentgemma-9b's heads
    (1, 50, 4, 4, 32, 64),       # window longer than the sequence
    (2, 45, 6, 2, 72, 16),       # D off 16: the CUDA-core variant in bf16
    (1, 300, 16, 1, 64, 100),    # G = 16 with a window, at each head dim
    (1, 300, 16, 1, 128, 100),
    (1, 300, 16, 1, 256, 100),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_kernel(cuda, B, S, H, KV, D, window, dtype):
    rng = np.random.default_rng(S + window)
    q = _randn(rng, (B, S, H, D), cuda, dtype)
    k, v = (_randn(rng, (B, S, KV, D), cuda, dtype) for _ in range(2))
    before = kernels.flash_attention.launches
    got, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    assert kernels.flash_attention.launches == before + 1
    _close(got, kernels.ref.causal_attention_ref(q, k, v, window=window), dtype)
    _close(lse, kernels.ref.attention_lse_ref(q, k, window=window), dtype)


@pytest.mark.gpu
def test_recurrent_wrappers_refuse_grad_and_bad_inputs(cuda):
    """Since the recurrent training slice the three wrappers differentiate
    (each through its backward kernel); only the mLSTM's final carry, a
    prefill's state, refuses grad.  Bad inputs raise as before."""
    x = torch.zeros(1, 8, 32, device=cuda, requires_grad=True)
    kernels.rglru_scan(x, x).sum().backward()
    assert x.grad is not None
    q = torch.zeros(1, 8, 2, 32, device=cuda, requires_grad=True)
    g = torch.zeros(1, 8, 2, device=cuda)
    kernels.mlstm_chunk(q, q, q, g, g, chunk=4).sum().backward()
    with pytest.raises(ValueError):  # the final carry has no backward
        kernels.mlstm_chunk(q, q, q, g, g, chunk=4, return_final=True)
    kernels.flash_attention_train(q, q, q, window=4).sum().backward()
    assert q.grad is not None
    with torch.no_grad():
        with pytest.raises(TypeError):  # not f32
            kernels.rglru_scan(x.bfloat16(), x.bfloat16())
        with pytest.raises(ValueError):  # the chunk does not divide S
            kernels.mlstm_chunk(q, q, q, g, g, chunk=3)
        with pytest.raises(ValueError):  # dk above the kernel's limit
            wide = torch.zeros(1, 8, 1, 520, device=cuda)
            kernels.mlstm_chunk(wide, wide, wide, g[..., :1], g[..., :1], chunk=4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers", [("recurrentgemma-9b", 3), ("xlstm-125m", 4),
                                         ("recurrentgemma-9b", 1)])
def test_recurrent_prefill_decode_equivalence_on_card(cuda, arch, layers):
    """Reduced widths, 1-4 layers, f32, kernel path: prefill + decode
    against forward past the reduced window of 64 (the ring wraps), and the
    kernel path's logits against the plain path's."""
    cfg = reduced_config(arch).with_(num_layers=layers)
    params = init_params(cfg, seed=0, device=cuda)
    opts = ModelOptions(compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 128))).to(cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        full, _ = forward(params, cfg, toks, opts=opts)
        plain, _ = forward(params, cfg, toks,
                           opts=ModelOptions(compute_dtype="float32", attn_impl="plain"))
        pre, cache = forward_with_cache(params, cfg, toks[:, :64], max_len=128, opts=opts)
        errs = [(pre[:, -1] - full[:, 63]).abs().max().item()]
        for t in range(64, 128):
            lg, cache = decode_step(params, cfg, cache, toks[:, t], opts)
            errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-3, errs  # the bound of tests/test_models.py
    torch.testing.assert_close(full, plain, atol=1e-4 * full.abs().max().item(), rtol=0)
    kinds = cfg.layer_kinds
    assert kernels.rglru_scan.launches == 2 * kinds.count("rglru")
    assert kernels.mlstm_chunk.launches == 2 * kinds.count("mlstm")
    assert kernels.flash_attention.launches == 2 * kinds.count("local")
    assert kernels.decode_attention.launches == 64 * kinds.count("local")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D", [(1, 2048, 16, 16, 128), (2, 1024, 32, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_kernel_mha_shapes(cuda, B, S, H, KV, D, dtype):
    """The backward at the MoE families' (MHA, D 128) and musicgen-large's
    (32 heads, D 64) training shapes, and two launches bit for bit."""
    rng = np.random.default_rng(S + H)
    inputs = _bwd_inputs(rng, B, S, H, KV, D, cuda, dtype)
    got = kernels.flash_attention_bwd(*inputs)
    again = kernels.flash_attention_bwd(*inputs)
    want = kernels.ref.flash_attention_bwd_ref(*inputs)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        _bwd_close(g, w, dtype)


def _moe_layer(arch, device, seed=0):
    """A reduced MoE family's first MoE layer (8 experts, top 2) and an
    input of one (4, 64) batch: 4 routing groups."""
    from repro_torch.models.moe import init_moe
    cfg = reduced_config(arch)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = init_moe(gen, cfg.d_model, cfg.moe)
    x = torch.randn(4, 64, cfg.d_model, generator=gen)
    return cfg, map_params(lambda _k, t: t.to(device), params), x.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_apply_on_card_matches_cpu(cuda, arch, impl):
    """f32: the layer on the card against the same layer on the CPU (which
    the CPU tests hold to the JAX package), output and aux loss."""
    from dataclasses import replace

    from repro_torch.models.moe import moe_apply
    cfg, params, x = _moe_layer(arch, cuda)
    m = replace(cfg.moe, impl=impl)
    got, aux = moe_apply(params, x, m, cfg.act)
    want, waux = moe_apply(map_params(lambda _k, t: t.cpu(), params), x.cpu(), m, cfg.act)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=TOL["float32"] * want.abs().max().item())
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_sort_dispatch_is_deterministic(cuda, dtype):
    """The sort path's combine sums in a fixed order (no atomics): two calls
    give the same bits, forward and input gradient."""
    from dataclasses import replace

    from repro_torch.models.moe import moe_apply
    cfg, params, x = _moe_layer("deepseek-moe-16b", cuda)
    m = replace(cfg.moe, impl="sort")
    params = map_params(lambda _k, t: t.to(TDT[dtype]) if t.dim() > 1 else t, params)
    runs = []
    for _ in range(2):
        xi = x.to(TDT[dtype]).clone().requires_grad_()
        out, _ = moe_apply(params, xi, m, cfg.act)
        out.float().square().sum().backward()
        runs.append((out.detach(), xi.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_paged_moe_engine_gives_the_same_tokens_twice(cuda):
    """Reduced deepseek-moe-16b in bf16, 8 slots for 3 requests: the idle
    rows all write scratch position (0, 0), and what they read there takes
    expert capacity; two runs give the same tokens."""
    cfg = reduced_config("deepseek-moe-16b")
    params = init_params(cfg, seed=0, device=cuda)
    prompts = [[1, 5, 9, 2], [1, 5, 9, 2, 7, 3], [4, 4, 8]]
    outs = []
    for _ in range(2):
        eng = PagedServeEngine(cfg, params, num_blocks=40, block_size=4, max_active=8,
                               prefill_chunk=3, opts=ModelOptions(compute_dtype="bfloat16"))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        outs.append({r.rid: r.generated for r in eng.run_until_drained(400)})
    assert outs[0] == outs[1] and len(outs[0]) == len(prompts)


@pytest.mark.gpu
def test_cast_params_keeps_the_shared_expert_gate_f32(cuda):
    from repro_torch.convert import cast_params
    params = init_params(reduced_config("qwen2-moe-a2.7b"), seed=0, device=cuda)
    moe = cast_params(params, torch.bfloat16)["main"][0]["moe"]
    assert moe["shared_gate"].dtype == torch.float32 and moe["shared_gate"].is_cuda
    assert moe["router"].dtype == moe["w_gate"].dtype == torch.bfloat16
    same = init_params(reduced_config("qwen2-moe-a2.7b"), seed=0, device=cuda,
                       dtype=torch.bfloat16)["main"][0]["moe"]
    assert torch.equal(same["shared_gate"], moe["shared_gate"])
    assert torch.equal(same["w_down"], moe["w_down"])


# ------------------------------------------------ the recurrent training slice


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,KV", [(64, 8, 2), (256, 16, 1), (128, 5, 1)])
@pytest.mark.parametrize("S,window", [(200, 5), (333, 64), (1000, 300), (130, 500)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_flash_backward_kernel(cuda, D, H, KV, S, window, dtype):
    """dq, dk, dv with a sliding window against the plain version on the
    forward kernel's own (out, lse); windows below a tile, across tiles and
    past S."""
    rng = np.random.default_rng(D + H + S + window)
    q = _randn(rng, (2, S, H, D), cuda, dtype)
    k, v = (_randn(rng, (2, S, KV, D), cuda, dtype) for _ in range(2))
    do = _randn(rng, (2, S, H, D), cuda, dtype)
    out, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    before = kernels.flash_attention_bwd.launches
    got = kernels.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert kernels.flash_attention_bwd.launches == before + 1
    want = kernels.ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, window)
    for g, w in zip(got, want):
        _bwd_close(g, w, dtype)
    again = kernels.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_flash_train_gradients(cuda, dtype):
    """Autograd through ``flash_attention_train(window=)`` (both kernels)
    against autograd through the plain windowed attention."""
    rng = np.random.default_rng(21)
    q = _randn(rng, (1, 300, 4, 64), cuda, dtype)
    k, v = (_randn(rng, (1, 300, 1, 64), cuda, dtype) for _ in range(2))
    w = _randn(rng, (1, 300, 4, 64), cuda, "float32")
    grads = {}
    kernels.reset_launch_counts()
    for name, fn in (("kernel", kernels.flash_attention_train),
                     ("plain", kernels.ref.causal_attention_ref)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, True, 100).float() * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    assert kernels.flash_attention.launches == 1
    assert kernels.flash_attention_bwd.launches == 1
    for g, w_ in zip(grads["kernel"], grads["plain"]):
        _bwd_close(g, w_, dtype)


def _rglru_bwd_inputs(rng, shape, device):
    log_a = -torch.from_numpy(rng.uniform(0.001, 0.5, shape).astype(np.float32))
    return (log_a.to(device), _randn(rng, shape, device, "float32"),
            _randn(rng, shape, device, "float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300, 96), (1, 4096, 4096), (3, 129, 37),
                                   (4, 1024, 256)])
def test_rglru_scan_backward_kernel(cuda, shape):
    """dlog_a, db against the plain reverse loop (f32, 1e-5 abs + rel, as
    the forward), twice bit for bit; C = 37 takes the 4-byte variant."""
    rng = np.random.default_rng(sum(shape))
    log_a, b, dh = _rglru_bwd_inputs(rng, shape, cuda)
    h = kernels.rglru_scan(log_a, b)
    before = kernels.rglru_scan_bwd.launches
    got = kernels.rglru_scan_bwd(log_a, h, dh)
    assert kernels.rglru_scan_bwd.launches == before + 1
    want = kernels.ref.rglru_scan_bwd_ref(log_a, h, dh)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    again = kernels.rglru_scan_bwd(log_a, h, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_rglru_scan_gradients_through_autograd(cuda):
    rng = np.random.default_rng(22)
    log_a, b, w = _rglru_bwd_inputs(rng, (2, 500, 64), cuda)
    grads = {}
    for name, fn in (("kernel", kernels.rglru_scan),
                     ("plain", kernels.ref.rglru_scan_ref)):
        leaves = [t.clone().requires_grad_() for t in (log_a, b)]
        (fn(*leaves) * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for g, w_ in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(g, w_, atol=1e-5, rtol=1e-5)


def _mlstm_grads(fn, q, k, v, i_pre, f_pre, dh, chunk):
    leaves = [t.clone().requires_grad_() for t in (q, k, v, i_pre, f_pre)]
    (fn(*leaves, chunk=chunk) * dh).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dk,chunk", [
    (2, 256, 2, 64, 64), (1, 384, 4, 384, 128), (2, 96, 3, 40, 32),
    (1, 128, 1, 130, 128),
    (2, 1024, 4, 384, 128),  # xlstm-125m's training shape
    (1, 64, 2, 96, 64),      # a single chunk: no carry
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunk_backward_kernel(cuda, B, S, H, dk, chunk, dtype):
    """The backward kernel's q, k, v, i_pre and f_pre gradients against
    autograd through the plain chunk recurrence on the same inputs: f32
    within 5e-5 abs + 5e-4 rel of each gradient's largest entry; bf16 within
    2e-2 of it (the forward's h differs by its bf16 products, and the q, k,
    v gradients are rounded to bf16).  Twice bit for bit."""
    rng = np.random.default_rng(B + S + H + dk)
    q, k, v = (_randn(rng, (B, S, H, dk), cuda, dtype) for _ in range(3))
    i_pre = _randn(rng, (B, S, H), cuda, "float32")
    f_pre = _randn(rng, (B, S, H), cuda, "float32") + 3.0
    dh = _randn(rng, (B, S, H, dk), cuda, "float32")
    before = kernels.mlstm_chunk_bwd.launches
    got = _mlstm_grads(kernels.mlstm_chunk, q, k, v, i_pre, f_pre, dh, chunk)
    assert kernels.mlstm_chunk_bwd.launches == before + 1
    want = _mlstm_grads(kernels.ref.mlstm_chunk_ref, q, k, v, i_pre, f_pre, dh,
                        chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        big = w.float().abs().max().item()
        limit = 5e-5 + 5e-4 * big if dtype == "float32" else 2e-2 * big
        assert err <= limit, (err, big)
    again = _mlstm_grads(kernels.mlstm_chunk, q, k, v, i_pre, f_pre, dh, chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_mlstm_chunk_backward_writes_bf16_itself(cuda):
    """bf16 inputs: dq, dk, dv come back as bf16 from the kernel itself
    (finite, within 2e-2 of the plain version's largest entry, two launches
    bit for bit), and a profile of one call shows only the backward's own
    six passes on the card (one a pass of the wrapper's plan), no copy or
    cast kernel."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.mlstm_chunk")
    rng = np.random.default_rng(31)
    B, S, H, dk, chunk = 2, 512, 4, 384, 128
    q, k, v = (_randn(rng, (B, S, H, dk), cuda, "bfloat16") for _ in range(3))
    log_i = _randn(rng, (B, S, H), cuda, "float32") - 2.0
    log_f = torch.nn.functional.logsigmoid(_randn(rng, (B, S, H), cuda, "float32") + 3.0)
    dh = _randn(rng, (B, S, H, dk), cuda, "float32")
    h, _, (ws, den) = mod.mlstm_chunk_fwd(q, k, v, log_i, log_f, chunk=chunk, keep=True)
    args = (q, k, v, log_i, log_f, ws, den, h, dh)
    got = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
    again = kernels.mlstm_chunk_bwd(*args, chunk=chunk)
    want = kernels.ref.mlstm_chunk_bwd_ref(q, k, v, log_i, log_f, dh, chunk=chunk)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert torch.isfinite(g).all()
        big = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * big
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernels.mlstm_chunk_bwd(*args, chunk=chunk)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_names = [n for n in names if "mlstm_bwd_" in n]
    assert len(kernel_names) == len(mod._bwd_plan(B, S, H, dk, chunk)), names
    assert sorted(set(names)) == sorted(set(kernel_names)), names


@contextlib.contextmanager
def _f64_plain():
    """The plain path in f64: every ``.float()`` of the port leaves an f64
    tensor f64 and RMSNorm (whose kernel takes no f64) runs its plain
    version; an exact run to hold two f32 runs against."""
    real_float, real_norm = torch.Tensor.float, layers_mod.rmsnorm_kernel

    def wide(self, *args, **kw):
        return self if self.dtype == torch.float64 else real_float(self, *args, **kw)

    torch.Tensor.float = wide
    layers_mod.rmsnorm_kernel = kernels.ref.rmsnorm_ref
    try:
        yield
    finally:
        torch.Tensor.float = real_float
        layers_mod.rmsnorm_kernel = real_norm


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_recurrent_train_gradients_on_card(cuda, arch):
    """Reduced config, f32, S = 128 (past the reduced window of 64, a
    multiple of the mLSTM chunk): ``loss_fn``'s gradients on the kernel
    path (every backward kernel) against the plain path, within 1e-3 of
    each leaf's largest entry; a leaf past it (a gradient that cancels to
    rounding, as the sLSTM input-gate bias's through its stabilizer) is
    held to the plain path in f64: within 1e-3 of it or twice the plain
    path's distance (two f32 runs, each with its own rounding).  Two
    kernel-path gradients bit for bit."""
    cfg = reduced_config(arch)
    params = init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(23)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def grads(impl, dtype="float32"):
        ps = map_params(lambda _k, p: p.detach().to(TDT.get(dtype, torch.float64))
                        .requires_grad_(True), params)
        loss, _ = loss_fn(ps, cfg, batch,
                          ModelOptions(compute_dtype=dtype, attn_impl=impl), remat=True)
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in _leaves(ps)]

    kernels.reset_launch_counts()
    loss_k, g_k = grads("kernel")
    assert kernels.rglru_scan_bwd.launches + kernels.mlstm_chunk_bwd.launches > 0
    loss_p, g_p = grads("plain")
    _, g_again = grads("kernel")
    torch.cuda.synchronize()
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    assert all(torch.equal(a, b) for a, b in zip(g_k, g_again))
    past = [i for i, (a, b) in enumerate(zip(g_k, g_p))
            if (a - b).abs().max().item() > 1e-3 * b.abs().max().item()]
    if past:
        with _f64_plain():
            _, g_64 = grads("plain", "float64")
        for i in past:
            scale = g_64[i].abs().max()
            ek = ((g_k[i].double() - g_64[i]).abs().max() / scale).item()
            ep = ((g_p[i].double() - g_64[i]).abs().max() / scale).item()
            assert ek <= max(1e-3, 2 * ep), (i, ek, ep)


def _plain_compressed_step(cfg, tcfg, opts):
    """The one-device gradients through the plain ``ef_quantize_mean`` (one
    pod), clipping and AdamW."""
    from repro_torch.train import adamw_update, clip_by_global_norm
    from repro_torch.train.compress import ef_quantize_mean
    from repro_torch.train.optim import leaves

    def step(state, batch):
        params = state["params"]
        for p in leaves(params):
            p.grad = None
        loss, _ = loss_fn(params, cfg, batch, opts, remat=tcfg.remat)
        loss.backward()
        mean, state["ef"] = ef_quantize_mean(map_params(lambda _k, p: p.grad[None], params),
                                             state["ef"])
        mean, gnorm = clip_by_global_norm(mean, tcfg.optimizer.clip_norm)
        adamw_update(tcfg.optimizer, params, mean, state["opt"], state["step"])
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [False, True])
def test_mesh_step_of_one_rank_over_nccl_is_the_one_device_step(cuda, compress):
    """A (1, 1, 1) mesh over NCCL, reduced gemma-2b in bf16 on the kernels,
    two steps: the mesh step equals the one-device step, and the compressed
    step (one pod) the plain composition, bit for bit (loss, grad norm,
    parameters, moments, EF buffers), with the same launch counts."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import activation_rules
    from repro_torch.train.optim import leaves

    cfg = reduced_config("gemma-2b")
    opts = ModelOptions(compute_dtype="bfloat16")
    tcfg = TrainConfig(compress_pod_grads=compress)
    params = init_params(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(3)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(cuda)
                for k in ("tokens", "labels")} for _ in range(2)]

    def run(step, state):
        out = []
        for b in batches:
            kernels.reset_launch_counts()
            state, m = step(state, b)
            out.append((m["loss"].item(), m["grad_norm"].item(),
                        {fn.__name__: fn.launches for fn in kernels.KERNELS}))
        return out, [t.detach().clone() for k in ("params", "opt", "ef") if k in state
                     for t in leaves(state[k])]

    clone = lambda: map_params(lambda _k, p: p.clone(), params)  # noqa: E731
    one = _plain_compressed_step(cfg, tcfg, opts) if compress else \
        make_train_step(cfg, tcfg, opts)
    want, want_t = run(one, init_train_state(cfg, tcfg, params=clone()))
    mesh = make_mesh((1, 1, 1), device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        got, got_t = run(make_train_step(cfg, tcfg, opts, mesh=mesh,
                                         act_rules=activation_rules()),
                         init_train_state(cfg, tcfg, params=clone(), mesh=mesh))
    finally:
        mesh.close()
    assert got == want and got[0][2]["flash_attention_bwd"] > 0
    assert len(got_t) == len(want_t) and all(torch.equal(a, b) for a, b in zip(got_t, want_t))


# ------------------------- f32 flash backward on the tensor cores (split TF32)


def _unaligned(t):
    """The same values 4 bytes into a fresh buffer: rows off 16-byte
    boundaries."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _f32_case(rng, B, S, H, KV, D, window, cuda):
    q = _randn(rng, (B, S, H, D), cuda, "float32")
    k, v = (_randn(rng, (B, S, KV, D), cuda, "float32") for _ in range(2))
    do = _randn(rng, (B, S, H, D), cuda, "float32")
    return q, k, v, do


def _fwd_bwd_against_plain(q, k, v, do, window):
    """Forward (out, LSE within 2e-5) and backward (5e-5 + 5e-4 rel) against
    the plain versions, each launched twice with equal bits."""
    out, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    out2, lse2 = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    _close(out, kernels.ref.causal_attention_ref(q, k, v, window=window), "float32")
    _close(lse, kernels.ref.attention_lse_ref(q, k, window=window), "float32")
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    got = kernels.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    again = kernels.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    want = kernels.ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, window)
    for g, g2, w in zip(got, again, want):
        _bwd_close(g, w, "float32")
        assert torch.equal(g, g2)


F32_TC_CASES = [
    (2, 512, 8, 1, 256, 0),     # the trainer PE's attention
    (1, 300, 16, 1, 256, 100),  # recurrentgemma-9b's heads, windowed
    (1, 63, 8, 1, 256, 0),      # ragged: one key below a 64-key tile
    (1, 65, 8, 1, 256, 0),      # one key above it
    (1, 1000, 8, 1, 256, 0),    # ragged, gemma-2b's heads
    (2, 45, 6, 2, 72, 0),       # D an odd multiple of 8: a half-filled pair of column tiles
    (1, 200, 4, 2, 40, 30),     # the same, windowed
] + [(1, 200, 2 * G, 2, D, 0) for G in (1, 5, 8, 16) for D in (64, 128, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,window", F32_TC_CASES)
def test_flash_attention_f32_backward_on_tensor_cores(cuda, B, S, H, KV, D, window):
    """f32 with D a multiple of 8: the backward takes the split-TF32
    tensor-core variant and the forward the CUDA-core one, both held to
    the plain versions at the f32 tolerances, two launches bit for bit; the
    forward gives the same bits from rows it copies 16 bytes at a time and
    from rows off 16-byte boundaries (element by element), output and LSE."""
    rng = np.random.default_rng(B + S + H + D + window)
    q, k, v, do = _f32_case(rng, B, S, H, KV, D, window, cuda)
    assert kernels.flash_route(q, k, v) == "cuda-cores"
    assert kernels.flash_route(q, k, v, do, backward=True) == "f32-tensor-cores"
    copied = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    loaded = kernels.flash_attention(_unaligned(q), k, v, return_lse=True, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(copied, loaded))
    _fwd_bwd_against_plain(q, k, v, do, window)


def _f64_attention(q, k, v, do, window):
    """dq, dk, dv of causal GQA attention in f64, by autograd."""
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(G, 2)) / q.shape[3] ** 0.5
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) & ((i[None, :] > i[:, None] - window) if window else True)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(~mask, float("-inf")), -1),
                       vd.repeat_interleave(G, 2))
    return torch.autograd.grad(out, (qd, kd, vd), do.double())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 512, 8, 1, 256, 0),     # gemma-2b's heads
    (2, 256, 8, 1, 256, 0),
    (1, 300, 16, 1, 256, 100),  # recurrentgemma-9b's heads, windowed
    (1, 200, 10, 2, 128, 0),    # GQA at D 128
])
def test_flash_attention_f32_backward_near_hard_is_no_farther_from_f64(cuda, B, S, H, KV, D,
                                                                      window):
    """At scores in the hundreds (q and k of std 10), the near-hard
    attention the reference's init gives, p = exp(s - lse) turns any
    difference between the backward's scores and the forward's into an
    error: the tensor-core backward recomputes the forward's own scores, so
    its dq, dk, dv are no farther from f64 than the CUDA-core backward's on
    the same out and lse, within 1e-5 of the largest entry (as
    ``chip_smoke.check_flash_near_hard``)."""
    rng = np.random.default_rng(S + H + D)
    q, k, v, do = _f32_case(rng, B, S, H, KV, D, window, cuda)
    q, k = q * 10, k * 10
    out, lse = kernels.flash_attention(q, k, v, return_lse=True, window=window)
    want = _f64_attention(q, k, v, do, window)
    tc = kernels.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    cc = kernels.flash_attention_bwd(_unaligned(q), k, v, out, lse, do, window=window)
    for g_tc, g_cc, w in zip(tc, cc, want):
        e_tc, e_cc = (((g.double() - w).abs().max() / w.abs().max()).item() for g in (g_tc, g_cc))
        assert torch.isfinite(g_tc).all() and e_tc <= e_cc + 1e-5, (e_tc, e_cc)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32 D 60", "f32 unaligned rows", "bf16 D 72"])
def test_flash_attention_cuda_core_variant_keeps_what_the_tensor_cores_refuse(cuda, case):
    """f32 at a head dim off 8, f32 rows off 16-byte boundaries (a view 4
    bytes into its storage) and bf16 at D = 72 (the bf16 tensor-core
    variant needs D % 16 == 0) stay on the CUDA-core variant, forward and
    backward; the f32 backward at D = 72 takes the tensor cores."""
    rng = np.random.default_rng(7)
    B, S, H, KV = 1, 130, 4, 2
    if case == "bf16 D 72":
        q = _randn(rng, (B, S, H, 72), cuda, "bfloat16")
        k, v = (_randn(rng, (B, S, KV, 72), cuda, "bfloat16") for _ in range(2))
        do = _randn(rng, (B, S, H, 72), cuda, "bfloat16")
        assert kernels.flash_route(q, k, v) == "cuda-cores"
        assert kernels.flash_route(q, k, v, do, backward=True) == "cuda-cores"
        assert kernels.flash_route(*(t.float() for t in (q, k, v, do)), backward=True) == \
            "f32-tensor-cores"
        out, lse = kernels.flash_attention(q, k, v, return_lse=True)
        _close(out, kernels.ref.causal_attention_ref(q, k, v), "bfloat16")
        got = kernels.flash_attention_bwd(q, k, v, out, lse, do)
        for g, w in zip(got, kernels.ref.flash_attention_bwd_ref(q, k, v, out, lse, do)):
            _bwd_close(g, w, "bfloat16")
        return
    D = 60 if case == "f32 D 60" else 64
    q, k, v, do = _f32_case(rng, B, S, H, KV, D, 0, cuda)
    if case == "f32 unaligned rows":
        q = _unaligned(q)
    assert kernels.flash_route(q, k, v) == "cuda-cores"
    assert kernels.flash_route(q, k, v, do, backward=True) == "cuda-cores"
    _fwd_bwd_against_plain(q, k, v, do, 0)
