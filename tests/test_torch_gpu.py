"""The port's CUDA kernels and paged engine on the card.

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
from repro_torch.serve import PagedServeEngine, Request

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
