"""The port's full-sequence ``forward``, prefill (``forward_with_cache``)
and dense ``decode_step`` against the JAX package's, on the same numpy
tokens and the same weights (through ``repro_torch.convert``), in f32 on
the CPU.  The port's attention wrappers run their plain versions here;
JAX's model runs its XLA blockwise attention and plain decode layer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import reduced_config as jax_reduced_config
from repro.models import ModelOptions as JaxModelOptions
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import forward_with_cache as jax_forward_with_cache
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.convert import cast_params, params_from_numpy
from repro_torch.models import (
    ModelOptions,
    decode_step,
    forward,
    forward_with_cache,
    init_cache,
    init_params,
    loss_fn,
)

ARCHS = ["gemma-2b", "qwen3-14b", "qwen1.5-4b"]  # MQA + GeGLU + tied, qk-norm, qkv bias
JOPTS = JaxModelOptions(compute_dtype="float32")
TOPTS = ModelOptions(compute_dtype="float32")
# logits and cached K/V after the reduced stack, in f32, held relative to
# the largest element: the same arithmetic summed in another order (a plain
# softmax against JAX's blockwise online softmax, matmuls of width <= 512).
# The reference's near-hard attention (ROADMAP Queue 3) amplifies that: JAX
# against itself with q_chunk = kv_chunk = 16 instead of the defaults parts
# by 3.5e-5 of the largest logit at reduced gemma-2b, 1.7e-5 at qwen1.5-4b
LOGITS_TOL = 1e-4
# the prefill/decode equivalence bound of tests/test_models.py
EQUIV_TOL = 5e-3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(a, b, tol=LOGITS_TOL):
    """|a - b| <= tol * max |b|, elementwise."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1.0))


@functools.cache
def _models(arch, seed=0):
    """The reduced configs and the reference's parameters in both packages,
    made once per file (no test writes to them)."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jp, device="cpu")


# JAX's decode step compiled once per cache shape: run op by op, a step of
# the recurrent stacks takes about a second on the CPU
_jax_decode_jit = jax.jit(jax_decode_step, static_argnums=(1, 4))


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _caches_close(tcache, jcache, tol=LOGITS_TOL):
    """Every leaf of every layer's state (K/V, ring buffers, recurrent
    states), each held to its own largest entry."""
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    for seg in ("prefix", "main", "tail"):
        assert len(tcache[seg]) == len(jcache[seg]), seg
        for t, j in zip(tcache[seg], jcache[seg]):
            assert set(t) == set(j), (seg, set(t), set(j))
            for name in j:
                assert tuple(t[name].shape) == np.shape(j[name]), (seg, name)
                _close(t[name], j[name], tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [64, 100])  # 100: off every kernel tile
def test_forward_matches_jax(arch, S):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, S)
    want, jaux = jax_forward(jp, jcfg, jnp.asarray(toks), None, JOPTS)
    got, aux = forward(tp, tcfg, torch.from_numpy(toks), opts=TOPTS)
    assert got.dtype == torch.float32 and got.shape == (2, S, tcfg.padded_vocab)
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == float(jaux)
    _close(got, want)


def test_tree_attention_forward_matches_jax():
    """Reduced qwen3-14b's ``forward`` on the plain path with
    ``tree_attention`` (chunks of 16: four over 64 tokens) against the
    reference's ``forward`` with its ``tree_attention``, within
    LOGITS_TOL."""
    jcfg, tcfg, jp, tp = _models("qwen3-14b")
    toks = _tokens(tcfg, 2, 64)
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks), None,
                          JaxModelOptions(compute_dtype="float32", tree_attention=True,
                                          q_chunk=16))
    got, _ = forward(tp, tcfg, torch.from_numpy(toks),
                     opts=ModelOptions(compute_dtype="float32", attn_impl="plain",
                                       tree_attention=True, q_chunk=16))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_cache_matches_jax(arch):
    """Prefill logits AND the packed cache (compact K/V, zero-padded to
    max_len, len = S)."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, 40)
    want, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks), None,
                                          max_len=64, opts=JOPTS)
    got, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks),
                                    max_len=64, opts=TOPTS)
    _close(got, want)
    _caches_close(cache, jcache)
    assert not cache["main"][0]["k"][:, :, 40:].any()  # the padding is zero


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Three decode steps from a prefilled cache, then from an empty one:
    logits and cache agree with JAX's after every step."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 3, 24)
    _, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks[:, :20]), None,
                                       max_len=24, opts=JOPTS)
    _, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks[:, :20]),
                                  max_len=24, opts=TOPTS)
    for t in range(20, 23):
        jl_, jcache = jax_decode_step(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
        _caches_close(cache, jcache)
    jcache = jax_init_cache(jcfg, 3, 8, jnp.float32)
    cache = init_cache(tcfg, 3, 8, torch.float32, "cpu")
    for t in range(3):
        jl_, jcache = jax_decode_step(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
    _caches_close(cache, jcache)


def test_decode_step_past_the_cache_matches_jax():
    """Rows at or past max_len write the last slot and attend to the whole
    cache (lengths above Smax), as the reference's clamp does."""
    jcfg, tcfg, jp, tp = _models("qwen3-14b")
    toks = _tokens(tcfg, 2, 12)
    jcache = jax_init_cache(jcfg, 2, 4, jnp.float32)
    cache = init_cache(tcfg, 2, 4, torch.float32, "cpu")
    for t in range(7):
        jl_, jcache = jax_decode_step(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
        _caches_close(cache, jcache)
    assert cache["len"].tolist() == [7, 7]


def test_decode_step_advance_leaves_other_rows_alone():
    """With ``advance``, only the chosen rows write K/V and move on: every
    other row's cache and length stay bit for bit, including a row past
    the end of its cache (whose clamped write slot lies inside its valid
    range)."""
    _, tcfg, _, tp = _models("gemma-2b")
    toks = torch.from_numpy(_tokens(tcfg, 3, 8))
    cache = init_cache(tcfg, 3, 4, torch.float32, "cpu")
    for t in range(6):  # every row runs past max_len = 4
        _, cache = decode_step(tp, tcfg, cache, toks[:, t], TOPTS)
    before = {n: cache["main"][0][n].clone() for n in ("k", "v")}
    lens = cache["len"].clone()
    adv = torch.tensor([False, True, False])
    _, cache = decode_step(tp, tcfg, cache, toks[:, 6], TOPTS, advance=adv)
    assert cache["len"].tolist() == [lens[0], lens[1] + 1, lens[2]]
    for n in ("k", "v"):
        after = cache["main"][0][n]
        assert torch.equal(after[:, [0, 2]], before[n][:, [0, 2]])
        assert not torch.equal(after[:, 1], before[n][:, 1])


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_prefill_decode_equivalence(arch):
    """The port's decode_step from a prefilled cache == its full forward
    (as ``tests/test_models.py::test_prefill_decode_equivalence``)."""
    cfg = reduced_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 96))
    full, _ = forward(params, cfg, toks, opts=TOPTS)
    n0 = 48
    pre, cache = forward_with_cache(params, cfg, toks[:, :n0], max_len=96, opts=TOPTS)
    errs = [float((pre[:, -1] - full[:, n0 - 1]).abs().max())]
    for t in range(n0, 96):
        lg, cache = decode_step(params, cfg, cache, toks[:, t], TOPTS)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < EQUIV_TOL, errs


def test_model_path_reaches_the_attention_wrappers(monkeypatch):
    """forward goes through ``flash_attention_train`` (the flash kernels)
    and decode_step through the dense ``decode_attention`` wrapper, once per
    layer and call (on the CPU the wrappers run their plain versions and
    count nothing, so count the calls)."""
    from repro_torch.models import layers

    calls = {"flash": 0, "decode": 0}
    real_flash, real_decode = layers.flash_attention_train, layers.decode_attention_kernel

    def flash(*a, **k):
        calls["flash"] += 1
        return real_flash(*a, **k)

    def decode(*a, **k):
        calls["decode"] += 1
        return real_decode(*a, **k)

    monkeypatch.setattr(layers, "flash_attention_train", flash)
    monkeypatch.setattr(layers, "decode_attention_kernel", decode)
    cfg = reduced_config("qwen3-14b")
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 16))
    _, cache = forward_with_cache(params, cfg, toks, max_len=20, opts=TOPTS)
    decode_step(params, cfg, cache, toks[:, 0], TOPTS)
    assert calls == {"flash": cfg.num_layers, "decode": cfg.num_layers}
    plain = ModelOptions(compute_dtype="float32", attn_impl="plain")
    forward(params, cfg, toks, opts=plain)
    assert calls["flash"] == cfg.num_layers
    assert kernels.flash_attention.launches == 0  # nothing launched on the CPU


def test_unported_inputs_raise():
    with pytest.raises(ValueError):
        ModelOptions(attn_impl="sdpa")



# ------------------------------------------------------- recurrent families

RECURRENT = ["recurrentgemma-9b", "xlstm-125m"]  # RG-LRU + local; mLSTM + sLSTM


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("S", [64, 128])  # 128: past the reduced window of 64
def test_recurrent_forward_matches_jax(arch, S):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, S)
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks), None, JOPTS)
    for impl in ("kernel", "plain"):
        got, aux = forward(tp, tcfg, torch.from_numpy(toks),
                           opts=ModelOptions(compute_dtype="float32", attn_impl=impl))
        assert got.shape == (2, S, tcfg.padded_vocab) and float(aux) == 0.0
        _close(got, want)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("S,max_len", [(40, 64), (128, 160)])
def test_recurrent_forward_with_cache_matches_jax(arch, S, max_len):
    """Prefill logits and every cache leaf: ring buffers (S = 128 fills a
    ring of 64 slots past its end), recurrent states, conv tails."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, S)
    want, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks), None,
                                          max_len=max_len, opts=JOPTS)
    got, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks),
                                    max_len=max_len, opts=TOPTS)
    _close(got, want)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("max_len", [24, 4])  # 4: the local ring wraps at once
def test_recurrent_decode_step_matches_jax(arch, max_len):
    """Decode steps from a prefilled cache, then from an empty one: logits
    and every cache leaf after every step."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 3, 24)
    n0 = min(20, max_len)
    _, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks[:, :n0]), None,
                                       max_len=max_len, opts=JOPTS)
    _, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks[:, :n0]),
                                  max_len=max_len, opts=TOPTS)
    for t in range(n0, n0 + 3):
        jl_, jcache = _jax_decode_jit(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
        _caches_close(cache, jcache)
    jcache = jax_init_cache(jcfg, 3, max_len, jnp.float32)
    cache = init_cache(tcfg, 3, max_len, torch.float32, "cpu")
    _caches_close(cache, jcache)  # sLSTM's n starts at 1e-6 in both
    for t in range(7):
        jl_, jcache = _jax_decode_jit(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_decode_equivalence(arch):
    """decode_step from a prefilled cache == the full forward, as
    tests/test_models.py::test_prefill_decode_equivalence (B 2, S 128, n0
    64): decode runs past the reduced window of 64, so the ring wraps."""
    cfg = reduced_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 128))
    full, _ = forward(params, cfg, toks, opts=TOPTS)
    n0 = 64
    pre, cache = forward_with_cache(params, cfg, toks[:, :n0], max_len=128, opts=TOPTS)
    errs = [float((pre[:, -1] - full[:, n0 - 1]).abs().max())]
    for t in range(n0, 128):
        lg, cache = decode_step(params, cfg, cache, toks[:, t], TOPTS)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < EQUIV_TOL, errs


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_advance_leaves_other_rows_alone(arch):
    """With ``advance``, every state leaf of the rows that do not advance
    stays bit for bit (ring buffers and recurrent states alike)."""
    _, tcfg, _, tp = _models(arch)
    toks = torch.from_numpy(_tokens(tcfg, 3, 8))
    cache = init_cache(tcfg, 3, 4, torch.float32, "cpu")
    for t in range(6):
        _, cache = decode_step(tp, tcfg, cache, toks[:, t], TOPTS)
    before = [{n: x.clone() for n, x in entry.items()} for entry in cache["main"]]
    adv = torch.tensor([False, True, False])
    _, cache = decode_step(tp, tcfg, cache, toks[:, 6], TOPTS, advance=adv)
    assert cache["len"].tolist() == [6, 7, 6]
    for entry, old in zip(cache["main"], before):
        for n, x in entry.items():
            assert torch.equal(x[:, [0, 2]], old[n][:, [0, 2]]), n
            assert not torch.equal(x[:, 1], old[n][:, 1]), n


@pytest.mark.parametrize("arch", RECURRENT + ["qwen2-moe-a2.7b"])
def test_cast_params_keeps_what_the_reference_reads_in_f32(arch):
    """A bf16 forward on ``cast_params(p, bf16)`` equals a bf16 forward on
    the f32 parameters bit for bit: the leaves the reference reads in f32
    (RG-LRU and mLSTM gates, conv weights, every sLSTM gate weight, qwen2's
    shared-expert gate, norm scales) stay f32, the rest are rounded exactly
    as the layers round them at use."""
    cfg = reduced_config(arch)
    params = init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 64))
    opts = ModelOptions(compute_dtype="bfloat16")
    want, _ = forward(params, cfg, toks, opts=opts)
    got, _ = forward(cast_params(params, torch.bfloat16), cfg, toks, opts=opts)
    assert torch.equal(got, want)


def test_model_path_reaches_the_recurrent_wrappers(monkeypatch):
    """forward and the prefill go through the ``rglru_scan`` and
    ``mlstm_chunk`` wrappers and local layers through the windowed flash
    wrapper, once per layer and call; the plain path through none."""
    from repro_torch.models import layers, recurrent

    calls = {"rglru": 0, "mlstm": 0, "window": 0}
    real = {"rglru": kernels.rglru_scan, "mlstm": kernels.mlstm_chunk,
            "flash": layers.flash_attention_train}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    def flash(q, k, v, causal=True, window=0):
        calls["window"] += window == cfg.window
        return real["flash"](q, k, v, causal, window)

    monkeypatch.setattr(recurrent.kernels, "rglru_scan", counted("rglru", real["rglru"]))
    monkeypatch.setattr(recurrent.kernels, "mlstm_chunk", counted("mlstm", real["mlstm"]))
    monkeypatch.setattr(layers, "flash_attention_train", flash)
    for arch in RECURRENT:
        cfg = reduced_config(arch)
        params = init_params(cfg, device="cpu")
        toks = torch.from_numpy(_tokens(cfg, 1, 64))
        forward(params, cfg, toks, opts=TOPTS)
        forward_with_cache(params, cfg, toks, opts=TOPTS)
        forward(params, cfg, toks, opts=ModelOptions(compute_dtype="float32",
                                                     attn_impl="plain"))
    rg, xl = reduced_config("recurrentgemma-9b"), reduced_config("xlstm-125m")
    assert calls == {"rglru": 2 * rg.layer_kinds.count("rglru"),
                     "mlstm": 2 * xl.layer_kinds.count("mlstm"),
                     "window": 2 * rg.layer_kinds.count("local")}


# ------------------------------------------------------- MoE and frontends

MOE = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]  # dense first layer + MoE; shared gate
FRONTENDS = ["musicgen-large", "internvl2-26b"]  # audio (MHA, GELU), vision (GQA)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("S", [64, 128])  # 128: two routing groups a row
def test_moe_forward_matches_jax(arch, impl, S):
    """Logits and the aux loss (summed over the MoE layers), per dispatch
    path, against JAX's with the same ``moe_impl``."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, S)
    want, jaux = jax_forward(jp, jcfg, jnp.asarray(toks), None,
                             JaxModelOptions(compute_dtype="float32", moe_impl=impl))
    got, aux = forward(tp, tcfg, torch.from_numpy(toks),
                       opts=ModelOptions(compute_dtype="float32", moe_impl=impl))
    assert got.shape == (2, S, tcfg.padded_vocab) and float(aux) > 0
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_with_cache_matches_jax(arch):
    """Prefill logits and every cache leaf (the dense first layer's and the
    MoE layers' K/V)."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 2, 32)
    want, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks), None,
                                          max_len=64, opts=JOPTS)
    got, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks),
                                    max_len=64, opts=TOPTS)
    _close(got, want)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_step_matches_jax(arch):
    """Decode steps from a prefilled cache, then from an empty one: every
    step routes the batch's rows as one group, as the reference does."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(tcfg, 3, 24)
    _, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks[:, :20]), None,
                                       max_len=24, opts=JOPTS)
    _, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks[:, :20]),
                                  max_len=24, opts=TOPTS)
    for t in range(20, 23):
        jl_, jcache = _jax_decode_jit(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
        _caches_close(cache, jcache)
    jcache = jax_init_cache(jcfg, 3, 8, jnp.float32)
    cache = init_cache(tcfg, 3, 8, torch.float32, "cpu")
    for t in range(3):
        jl_, jcache = _jax_decode_jit(jp, jcfg, jcache, jnp.asarray(toks[:, t]), JOPTS)
        tl_, cache = decode_step(tp, tcfg, cache, torch.from_numpy(toks[:, t]), TOPTS)
        _close(tl_, jl_)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_decode_equivalence(arch):
    """decode_step from a prefilled cache == the full forward, one row,
    with a capacity that drops nothing.  A forward routes a group of 64
    positions and a decode step one position, so where the forward's
    experts overflow the two part, in the reference too: capacity couples
    the tokens of a group."""
    cfg = reduced_config(arch)
    m = cfg.moe
    cfg = cfg.with_(moe=m.__class__(**{**m.__dict__,
                                      "capacity_factor": m.num_experts / m.top_k}))
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 64))
    full, _ = forward(params, cfg, toks, opts=TOPTS)
    n0 = 32
    pre, cache = forward_with_cache(params, cfg, toks[:, :n0], max_len=64, opts=TOPTS)
    errs = [float((pre[:, -1] - full[:, n0 - 1]).abs().max())]
    for t in range(n0, 64):
        lg, cache = decode_step(params, cfg, cache, toks[:, t], TOPTS)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < EQUIV_TOL, errs


def _frontend(cfg, B, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_forward_matches_jax(arch):
    """The projected frontend embeddings ahead of the (scaled) tokens:
    logits over F + S positions, and the prefill's cache of that length."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks, fe = _tokens(tcfg, 2, 40), _frontend(tcfg, 2)
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(fe), JOPTS)
    got, aux = forward(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(fe), TOPTS)
    assert got.shape == (2, tcfg.frontend_len + 40, tcfg.padded_vocab)
    assert float(aux) == 0.0
    _close(got, want)
    want, jcache = jax_forward_with_cache(jp, jcfg, jnp.asarray(toks), jnp.asarray(fe),
                                          max_len=64, opts=JOPTS)
    got, cache = forward_with_cache(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(fe), max_len=64, opts=TOPTS)
    _close(got, want)
    _caches_close(cache, jcache)
    assert cache["len"].tolist() == [tcfg.frontend_len + 40] * 2


def test_frontend_config_needs_its_embeddings():
    cfg = reduced_config("musicgen-large")
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError):
        forward(params, cfg, torch.zeros(1, 4, dtype=torch.int64), opts=TOPTS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_forward_and_train_step(arch):
    """The port of tests/test_models.py's smoke test, on the reference's
    weights: one forward and one gradient of ``loss_fn`` (remat off), with
    the shapes, finite values and a positive grad norm; the loss also
    against JAX's.  Every family differentiates the default kernel path
    (the recurrent ones through the RG-LRU, mLSTM and windowed flash
    backwards since the recurrent training slice)."""
    jcfg, tcfg, jp, _ = _models(arch)
    tp = params_from_numpy(jp, device="cpu")
    B, S = 2, 64
    toks = _tokens(tcfg, B, S, seed=5)
    fe = _frontend(tcfg, B) if tcfg.frontend else None
    tfe = None if fe is None else torch.from_numpy(fe)
    logits, aux = forward(tp, tcfg, torch.from_numpy(toks), tfe, TOPTS)
    assert logits.shape == (B, S + tcfg.frontend_len, tcfg.padded_vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    batch = {"tokens": toks, "labels": toks}
    if fe is not None:
        batch["frontend_embeds"] = fe
    for p in jax.tree.leaves(tp):
        p.requires_grad_(True)
    loss, _ = loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                      TOPTS, remat=False)
    loss.backward()
    gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in jax.tree.leaves(tp)))
    assert torch.isfinite(loss) and torch.isfinite(gnorm) and float(gnorm) > 0
    jloss, _ = jax_loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                           JOPTS, remat=False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
