"""The port's serving engines (paged and fixed-slot) against the JAX
package's, greedy token for token and metric for metric, on converted
weights; plus the port's import hygiene and its refusal to fall back to the
CPU."""

import ast
import functools
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import ModelOptions as JaxModelOptions
from repro.models import init_params as jax_init_params
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ModelOptions, forward, init_params
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

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


MOE = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"] + MOE)
def test_paged_engine_matches_jax(arch):
    want, got, jeng, teng = _both(arch, num_blocks=24, block_size=4,
                                  max_active=3, prefill_chunk=3)
    assert got == want
    m = teng.metrics()
    assert m == jeng.metrics()  # admission, sharing, CoW and eviction alike
    assert m["prefixHitRate"] > 0 and m["cowCopies"] >= 1
    assert m["blocksFree"] == m["blocksTotal"] - m["blocksCached"]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"] + MOE)
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


# ------------------------------------------------------------- fixed slot

# the cases of tests/test_serve.py: more requests than slots (queueing), and
# one request alone against the same request beside another
FIXED_CASES = {
    "queueing": ("gemma-2b", dict(num_slots=2, max_len=64),
                 [[1 + rid, 2, 3] for rid in range(4)], 5),
    "alone": ("qwen3-14b", dict(num_slots=1, max_len=32), [[5, 6, 7]], 4),
    "together": ("qwen3-14b", dict(num_slots=2, max_len=32),
                 [[5, 6, 7], [9, 10]], 4),
    "qkv_bias": ("qwen1.5-4b", dict(num_slots=2, max_len=16),
                 [[1, 5, 9, 2], [4, 4, 8], [3]], 6),
    # rows run past max_len: the clamped writes and the full-cache reads
    "past_max_len": ("gemma-2b", dict(num_slots=2, max_len=6),
                     [[1, 5, 9, 2], [4, 4, 8], [7, 7]], 6),
    # MoE: every admission step routes the idle rows beside the admitted
    # one, as the reference's batched step does before _merge_slot
    "moe_deepseek": ("deepseek-moe-16b", dict(num_slots=3, max_len=32),
                     [[1, 5, 9, 2], [4, 4, 8], [7, 7], [3, 1, 4, 1, 5]], 6),
    "moe_qwen2": ("qwen2-moe-a2.7b", dict(num_slots=2, max_len=16),
                  [[1, 5, 9, 2], [4, 4, 8], [3]], 6),
}


def _fixed(engine_cls, request_cls, cfg, params, opts, prompts, max_new, **kw):
    eng = engine_cls(cfg, params, opts=opts, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=list(p), max_new_tokens=max_new))
    done = eng.run_until_drained(max_ticks=200)
    return {r.rid: r.generated for r in done}, eng


@pytest.mark.parametrize("case", sorted(FIXED_CASES))
def test_fixed_slot_engine_matches_jax(case):
    arch, kw, prompts, max_new = FIXED_CASES[case]
    jp = jax_init_params(jax.random.key(0), jax_reduced_config(arch))
    want, jeng = _fixed(JaxServeEngine, JaxRequest, jax_reduced_config(arch), jp,
                        JaxModelOptions(compute_dtype="float32"), prompts,
                        max_new, **kw)
    got, teng = _fixed(ServeEngine, Request, reduced_config(arch),
                       params_from_numpy(jp, device="cpu"),
                       ModelOptions(compute_dtype="float32"), prompts, max_new,
                       device="cpu", **kw)
    assert got == want and len(got) == len(prompts)
    assert all(len(t) == max_new for t in got.values())
    assert teng.metrics() == jeng.metrics()


def test_batched_decode_matches_single():
    """The port alone: a request decoded beside another equals it alone."""
    cfg = reduced_config("qwen3-14b")
    params = init_params(cfg, seed=0, device="cpu")
    opts = ModelOptions(compute_dtype="float32")
    alone, _ = _fixed(ServeEngine, Request, cfg, params, opts, [[5, 6, 7]], 4,
                      num_slots=1, max_len=32, device="cpu")
    together, _ = _fixed(ServeEngine, Request, cfg, params, opts,
                         [[5, 6, 7], [9, 10]], 4, num_slots=2, max_len=32,
                         device="cpu")
    assert together[0] == alone[0]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_paged_engine_matches_fixed_slot(arch):
    """The port's paged engine (chunked prefill, prefix reuse, CoW) gives
    the port's fixed-slot engine's greedy tokens (tests/test_serve.py)."""
    cfg = reduced_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    opts = ModelOptions(compute_dtype="float32")
    want, _ = _fixed(ServeEngine, Request, cfg, params, opts, PROMPTS, 5,
                     num_slots=2, max_len=16, device="cpu")
    got, eng = _serve(PagedServeEngine, Request, cfg, params, opts,
                      num_blocks=24, block_size=4, max_active=3,
                      prefill_chunk=3, device="cpu")
    assert got == want
    m = eng.metrics()
    assert m["prefixHitRate"] > 0 and m["cowCopies"] >= 1
    assert m["prefillBacklog"] == 0


def test_admission_leaves_a_row_past_max_len_alone():
    """Admitting a prompt runs the batched decode step once per prompt
    token; a row that sits at len >= max_len (whose clamped write slot lies
    inside its valid range) keeps its K/V and its len bit for bit."""
    cfg = reduced_config("gemma-2b")
    eng = ServeEngine(cfg, init_params(cfg, seed=1, device="cpu"), num_slots=2,
                      max_len=4, opts=ModelOptions(compute_dtype="float32"),
                      device="cpu")
    eng.submit(Request(rid=0, prompt=[3, 1, 4], max_new_tokens=12))
    for _ in range(4):
        eng.step()
    assert int(eng.cache["len"][0]) >= eng.max_len
    row = {n: eng.cache["main"][0][n][:, 0].clone() for n in ("k", "v")}
    length = int(eng.cache["len"][0])
    eng.submit(Request(rid=1, prompt=[1, 5, 9, 2, 6], max_new_tokens=2))
    eng._admit()
    assert int(eng.cache["len"][1]) == 5
    assert int(eng.cache["len"][0]) == length
    for n in ("k", "v"):
        assert torch.equal(eng.cache["main"][0][n][:, 0], row[n])


def test_fixed_slot_engine_without_card_raises(monkeypatch):
    cfg = reduced_config("gemma-2b")
    params = init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, params, num_slots=2, max_len=8)


# ------------------------------------------------------- recurrent families

RECURRENT = ["recurrentgemma-9b", "xlstm-125m"]
# prompts of 4-6 tokens and 14 new ones: contexts reach 20 > max_len 16, so
# the fixed-slot engine's local ring (min(window, max_len) = 16 slots) wraps
RECURRENT_PROMPTS = [[1, 5, 9, 2], [1, 5, 9, 2, 7, 3], [4, 4, 8, 1]]
RECURRENT_NEW = 14


def _recurrent_both(arch, jax_engine, engine, **kw):
    """The same requests through JAX's engine and the port's, on the same
    converted weights, in f32."""
    jp = _jax_params(arch)
    want, jeng = _fixed(jax_engine, JaxRequest, jax_reduced_config(arch), jp,
                        JaxModelOptions(compute_dtype="float32"),
                        RECURRENT_PROMPTS, RECURRENT_NEW, **kw)
    got, teng = _fixed(engine, Request, reduced_config(arch),
                       params_from_numpy(jp, device="cpu"),
                       ModelOptions(compute_dtype="float32"), RECURRENT_PROMPTS,
                       RECURRENT_NEW, device="cpu", **kw)
    return want, got, jeng, teng


@functools.cache
def _jax_params(arch):
    return jax_init_params(jax.random.key(0), jax_reduced_config(arch))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_fixed_slot_engine_matches_jax(arch):
    """Two slots, max_len 16: queueing, admission token by token beside a
    running row, a wrapping local ring, recurrent states reset on
    admission (sLSTM's n to 0, as the reference's reset gives)."""
    want, got, jeng, teng = _recurrent_both(arch, JaxServeEngine, ServeEngine,
                                            num_slots=2, max_len=16)
    assert got == want and len(got) == len(RECURRENT_PROMPTS)
    assert all(len(t) == RECURRENT_NEW for t in got.values())
    assert teng.metrics() == jeng.metrics()


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_paged_engine_matches_jax(arch):
    """The paged engine keeps local rings and recurrent states per slot
    (window-sized rings, prefix cache off): JAX's tokens and metrics."""
    want, got, jeng, teng = _recurrent_both(
        arch, JaxPagedServeEngine, PagedServeEngine, num_blocks=24, block_size=4,
        max_active=2, prefill_chunk=3)
    assert got == want and len(got) == len(RECURRENT_PROMPTS)
    m = teng.metrics()
    assert m == jeng.metrics()
    assert teng.cache is None and m["prefixHitRate"] == 0 and m["prefillBacklog"] == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engines_against_repeated_forward(arch, capsys):
    """The greedy continuation by repeated ``forward`` (f32, the port).  Both
    engines, as the reference's, feed the prompt's own next token without
    reporting it, so ``generated`` is that continuation from its second
    token on (ROADMAP Queue 3).  The paged engine's rings are window-sized,
    so it must give those tokens.  The fixed-slot engine's ring of max_len
    16 slots sees only the last 16 tokens past that length, and the
    reference's engines start sLSTM from n = 0 where ``forward`` starts it
    from 1e-6 (Queue 3): where its tokens part from forward's is logged,
    not held."""
    cfg = reduced_config(arch)
    params = params_from_numpy(_jax_params(arch), device="cpu")
    opts = ModelOptions(compute_dtype="float32")
    greedy = {}
    for rid, prompt in enumerate(RECURRENT_PROMPTS):
        toks = list(prompt)
        for _ in range(RECURRENT_NEW + 1):
            logits, _ = forward(params, cfg, torch.tensor([toks]), opts=opts)
            toks.append(int(torch.argmax(logits[0, -1])))
        greedy[rid] = toks[len(prompt) + 1:]
    paged, _ = _fixed(PagedServeEngine, Request, cfg, params, opts,
                      RECURRENT_PROMPTS, RECURRENT_NEW, num_blocks=24,
                      block_size=4, max_active=2, prefill_chunk=3, device="cpu")
    assert paged == greedy
    fixed, _ = _fixed(ServeEngine, Request, cfg, params, opts, RECURRENT_PROMPTS,
                      RECURRENT_NEW, num_slots=2, max_len=16, device="cpu")
    parts = {rid: next((i for i, (a, b) in enumerate(zip(fixed[rid], greedy[rid]))
                        if a != b), None) for rid in greedy}
    with capsys.disabled():
        print(f"\n{arch}: fixed-slot engine (max_len 16) vs repeated forward, first "
              f"differing new token per request (None: all equal): {parts}")


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
