"""The port's paged serving engine against the JAX package's, greedy token
for token, on converted weights; plus the port's import hygiene and its
refusal to fall back to the CPU."""

import ast
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import ModelOptions as JaxModelOptions
from repro.models import init_params as jax_init_params
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import Request as JaxRequest
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ModelOptions, init_params
from repro_torch.serve import PagedServeEngine, Request

ROOT = Path(__file__).resolve().parents[1]
# the request mix of tests/test_serve.py: three prompts share a prefix, so
# the prefix cache, a shared tail and copy-on-write all fire
PROMPTS = [[1, 5, 9, 2], [1, 5, 9, 2, 7, 3], [4, 4, 8], [1, 5, 9, 2, 6]]


def _serve(engine_cls, request_cls, cfg, params, opts, **kw):
    eng = engine_cls(cfg, params, opts=opts, **kw)
    for i, p in enumerate(PROMPTS):
        eng.submit(request_cls(rid=i, prompt=list(p), max_new_tokens=5))
    done = eng.run_until_drained(max_ticks=400)
    return {r.rid: r.generated for r in done}, eng


def _both(arch, **kw):
    """The same requests through JAX's engine (paged Pallas kernel in
    interpret mode) and the port's, on the same weights, in f32."""
    jp = jax_init_params(jax.random.key(0), jax_reduced_config(arch))
    want, jeng = _serve(JaxPagedServeEngine, JaxRequest, jax_reduced_config(arch),
                        jp, JaxModelOptions(compute_dtype="float32"),
                        attn_impl="kernel", interpret=True, **kw)
    got, teng = _serve(PagedServeEngine, Request, reduced_config(arch),
                       params_from_numpy(jp, device="cpu"),
                       ModelOptions(compute_dtype="float32"), device="cpu", **kw)
    return want, got, jeng, teng


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_paged_engine_matches_jax(arch):
    want, got, jeng, teng = _both(arch, num_blocks=24, block_size=4,
                                  max_active=3, prefill_chunk=3)
    assert got == want
    m = teng.metrics()
    assert m == jeng.metrics()  # admission, sharing, CoW and eviction alike
    assert m["prefixHitRate"] > 0 and m["cowCopies"] >= 1
    assert m["blocksFree"] == m["blocksTotal"] - m["blocksCached"]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_small_pool_drains_like_jax(arch):
    """A pool too small for all requests at once still drains: admission
    waits for retiring requests, and every block comes back."""
    want, got, jeng, teng = _both(arch, num_blocks=7, block_size=4,
                                  max_active=4, prefill_chunk=4,
                                  prefix_cache=False)
    assert got == want and len(got) == len(PROMPTS)
    assert teng.peak_active == jeng.peak_active <= 2
    assert teng.alloc.blocks_free == teng.alloc.capacity


def test_oversized_request_rejected():
    cfg = reduced_config("gemma-2b")
    eng = PagedServeEngine(cfg, init_params(cfg, device="cpu"), num_blocks=3,
                           block_size=2, opts=ModelOptions(compute_dtype="float32"),
                           device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=[1] * 8, max_new_tokens=4))


def test_kernel_and_gather_paths_agree():
    cfg = reduced_config("gemma-2b")
    params = init_params(cfg, seed=3, device="cpu")
    opts = ModelOptions(compute_dtype="float32")
    outs = [_serve(PagedServeEngine, Request, cfg, params, opts, num_blocks=16,
                   block_size=4, max_active=2, prefill_chunk=4, attn_impl=impl,
                   device="cpu")[0] for impl in ("kernel", "gather")]
    assert outs[0] == outs[1]


def test_engine_without_card_raises(monkeypatch):
    """No device given and no card: the engine refuses to start rather than
    run on the CPU."""
    cfg = reduced_config("gemma-2b")
    params = init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PagedServeEngine(cfg, params, num_blocks=8)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
