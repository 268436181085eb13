"""The port's layers, parameters and paged decode step against the JAX
package, on the same numpy inputs and the same weights (through
``repro_torch.convert``), in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import ModelOptions as JaxModelOptions
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.serve import paged_model as jpm
from repro_torch.configs import reduced_config
from repro_torch.convert import cast_params, params_from_numpy, params_to_numpy
from repro_torch.models import ModelOptions, init_params
from repro_torch.models import layers as tl
from repro_torch.serve import paged_model as tpm

# f32, the same arithmetic summed in another order (matmuls of width
# <= 512, an online softmax against a plain one)
TOL = 1e-5
# logits after a whole stack: the per-op differences above, carried through
# two layers and a 512-wide head
LOGITS_TOL = 1e-4


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("head_dim,theta", [(32, 1e4), (128, 1e6), (256, 1e4)])
def test_rope_matches_jax(head_dim, theta):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 2048, size=(6,)).astype(np.int32)
    x = rng.standard_normal((6, 4, head_dim)).astype(np.float32)
    sj, cj = jl.rope_table(jnp.asarray(pos), head_dim, theta)
    st, ct = tl.rope_table(torch.from_numpy(pos), head_dim, theta)
    # angles reach 2048 rad, where one f32 ulp is 1.2e-4: sin and cos of
    # the same f32 angle computed by two libraries agree to about that
    _close(st, sj, 3e-4)
    _close(ct, cj, 3e-4)
    # the rotation itself, on the same tables
    want = jl.apply_rope(jnp.asarray(x), sj, cj)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(sj)),
                        torch.from_numpy(np.array(cj)))
    _close(got, want)


@pytest.mark.parametrize("shape", [(8, 128), (3, 4, 32)])
def test_rmsnorm_layer_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_mlp_matches_jax(act, gated):
    rng = np.random.default_rng(2)
    d, ff = 64, 256
    p = {"w_up": rng.standard_normal((d, ff)) / 8,
         "w_down": rng.standard_normal((ff, d)) / 16}
    if gated:
        p["w_gate"] = rng.standard_normal((d, ff)) / 8
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((5, d)).astype(np.float32)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act, gated)
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act, gated)
    _close(got, want)


@pytest.mark.parametrize("S,H,KV,w", [(256, 2, 2, 64), (128, 4, 1, 32), (48, 4, 2, 64)])
def test_local_band_attention_matches_jax(S, H, KV, w):
    """The plain path of local attention (the band decomposition) and the
    plain version of the windowed kernel against the reference's
    ``local_band_attention`` (shapes of tests/test_models.py; the reference
    takes K/V expanded to H heads, the port the compact ones)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels.ref import causal_attention_ref

    rng = np.random.default_rng(S + w)
    q = rng.standard_normal((2, S, H, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, KV, 32)).astype(np.float32) for _ in range(2))
    G = H // KV
    want = jl.local_band_attention(jnp.asarray(q), jnp.asarray(np.repeat(k, G, 2)),
                                   jnp.asarray(np.repeat(v, G, 2)), window=w)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    _close(tl.local_band_attention(qt, kt, vt, w), want, 2e-5)
    _close(tl.causal_attention(qt, kt, vt, "plain", window=w), want, 2e-5)
    _close(causal_attention_ref(qt, kt, vt, window=w),
           jref.causal_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=w), 2e-5)
    _close(tl.causal_attention(qt, kt, vt, "kernel", window=w), want, 2e-5)
    if S > w:
        with pytest.raises(ValueError):  # the band decomposition's rule
            tl.local_band_attention(qt[:, :S - 1], kt[:, :S - 1], vt[:, :S - 1], w)


@pytest.mark.parametrize("S,H,KV,chunk", [(64, 4, 2, 16), (128, 2, 1, 32)])
def test_tree_causal_attention_matches_jax(S, H, KV, chunk):
    """The plain path's tree attention (``ModelOptions.tree_attention``)
    against the reference's ``tree_causal_attention`` at four chunks (the
    reference takes K/V expanded to H heads, the port the compact ones), in
    f32 within 2e-5 as the band above; the plain masked softmax gives the
    same; a chunk that does not cut the sequence into a power of two of
    chunks raises, where the reference asserts or cannot reshape."""
    from repro_torch.kernels.ref import causal_attention_ref

    rng = np.random.default_rng(S + chunk)
    q = rng.standard_normal((2, S, H, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, KV, 32)).astype(np.float32) for _ in range(2))
    G = H // KV
    want = jl.tree_causal_attention(jnp.asarray(q), jnp.asarray(np.repeat(k, G, 2)),
                                    jnp.asarray(np.repeat(v, G, 2)), chunk=chunk)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    _close(tl.tree_causal_attention(qt, kt, vt, chunk), want, 2e-5)
    _close(tl.causal_attention(qt, kt, vt, "plain", tree_chunk=chunk), want, 2e-5)
    _close(causal_attention_ref(qt, kt, vt), want, 2e-5)
    for cut in (S - chunk // 2, 3 * chunk):
        with pytest.raises(ValueError):
            tl.tree_causal_attention(qt[:, :cut], kt[:, :cut], vt[:, :cut], chunk)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_decode_attention_on_a_wrapped_ring_matches_jax(impl):
    """A local layer's ring buffer: rows not yet wrapped (length <= Smax)
    and wrapped ones (length > Smax, every slot valid), through the plain
    layer with ``window`` and the dense decode wrapper (its plain version
    here; the kernel loops over min(length, Smax) slots)."""
    rng = np.random.default_rng(5)
    B, H, KV, D, Smax = 4, 4, 1, 32, 16
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Smax, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Smax, KV, D)).astype(np.float32)
    lengths = np.asarray([5, 16, 17, 40], np.int32)
    want = jl.decode_attention(*(jnp.asarray(a) for a in (q, k, v, lengths)), window=64)
    got = tl.cached_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lengths)),
                                     impl=impl, window=64)
    _close(got, want)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    B, H, KV, D, S = 3, 8, 2, 32, 40
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lengths = np.asarray([40, 17, 1], np.int32)
    want = jl.decode_attention(*(jnp.asarray(a) for a in (q, k, v, lengths)))
    got = tl.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lengths)))
    _close(got, want)


# ------------------------------------------------------------------- params

ARCHS = ["gemma-2b", "qwen3-14b", "qwen1.5-4b", "musicgen-large", "internvl2-26b",
         "deepseek-moe-16b", "qwen2-moe-a2.7b"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_same_tree_and_scales(arch):
    """Same keys, shapes and axis orders as the reference (tied or not,
    qkv bias, qk-norm, frontend, MoE experts stacked per group), and the
    same init scale per leaf."""
    jp = dict(_leaves(jax_init_params(jax.random.key(0), jax_reduced_config(arch))))
    tp = dict(_leaves(init_params(reduced_config(arch), seed=0, device="cpu")))
    assert jp.keys() == tp.keys()
    for path, t in tp.items():
        j = np.asarray(jp[path])
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        if j.std() > 0:  # random draws: the spread agrees, not the numbers
            assert abs(float(t.std()) / float(j.std()) - 1) < 0.1, path
        else:
            assert not t.any(), path


def test_params_round_trip_through_numpy():
    jp = jax_init_params(jax.random.key(0), jax_reduced_config("qwen3-14b"))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    for (pa, a), (pb, b) in zip(_leaves(jax.tree.map(np.asarray, jp)), _leaves(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_cast_keeps_norm_scales_f32():
    p = init_params(reduced_config("qwen3-14b"), seed=0, device="cpu")
    for path, t in _leaves(cast_params(p, torch.bfloat16)):
        assert t.dtype == (torch.float32 if path[-1] == "scale" else torch.bfloat16), path


def test_cast_keeps_the_shared_expert_gate_f32():
    """qwen2-moe's ``shared_gate`` is read in f32 (``convert.F32_LEAVES``);
    the router, the stacked experts and the shared experts are cast."""
    p = init_params(reduced_config("qwen2-moe-a2.7b"), seed=0, device="cpu")
    seen = set()
    for path, t in _leaves(cast_params(p, torch.bfloat16)):
        f32 = path[-1] in ("scale", "shared_gate")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
        seen.add(path[-1])
    assert {"router", "w_gate", "shared_gate"} <= seen


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        init_params(reduced_config("gemma-2b"))
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": np.zeros(2, np.float32)})


# ----------------------------------------------------- paged decode step


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
@pytest.mark.parametrize("attn_impl", ["kernel", "gather"])
def test_paged_decode_step_matches_jax(arch, attn_impl):
    """Four micro-steps of ``_paged_decode_step`` on converted weights: the
    logits and the pools agree with JAX's (kernel in interpret mode), with
    one slot idle, one stalled for a step and pages that cross a block."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(1), jcfg)
    tp = params_from_numpy(jp, device="cpu")
    jopts, topts = (JaxModelOptions(compute_dtype="float32"),
                    ModelOptions(compute_dtype="float32"))
    B, N, bs = 3, 8, 2
    jstate = jpm.init_paged_state(jcfg, B, N, bs, jnp.float32)
    tstate = tpm.init_paged_state(tcfg, B, N, bs, torch.float32, "cpu")
    tables = np.asarray([[3, 5, 1, 0], [2, 7, 0, 0], [0, 0, 0, 0]], np.int32)
    rng = np.random.default_rng(4)
    for step in range(4):
        tokens = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)
        adv = np.asarray([True, step != 1, False])
        jl_, jstate = jpm._paged_decode_step(
            jp, jcfg, jstate, jnp.asarray(tables), jnp.asarray(tokens),
            jnp.asarray(adv), jopts, "kernel", True)
        tl_ = tpm._paged_decode_step(
            tp, tcfg, tstate, torch.from_numpy(tables), torch.from_numpy(tokens),
            torch.from_numpy(adv), topts, attn_impl)
        _close(tl_[adv], np.asarray(jl_)[adv], LOGITS_TOL)  # other rows are unused
        np.testing.assert_array_equal(tstate["len"].numpy(), np.asarray(jstate["len"]))
    used = [3, 5, 1, 2, 7]  # every block the two live slots wrote
    for name in ("k", "v"):
        _close(tstate["main"][0][name][:, used], jstate["main"][0][name][:, used],
               LOGITS_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_paged_decode_step_per_slot_layers_match_jax(arch):
    """``_paged_decode_step`` on configs whose layers keep per-slot state
    (local ring buffers, recurrent states): logits of the advancing rows
    and every state leaf agree with JAX's after each micro-step, with one
    slot idle and one stalled for a step (whose state stays as it was)."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(1), jcfg)
    tp = params_from_numpy(jp, device="cpu")
    jopts, topts = (JaxModelOptions(compute_dtype="float32"),
                    ModelOptions(compute_dtype="float32"))
    B, N, bs = 3, 4, 2
    jstate = jpm.init_paged_state(jcfg, B, N, bs, jnp.float32)
    tstate = tpm.init_paged_state(tcfg, B, N, bs, torch.float32, "cpu")
    tables = np.zeros((B, 2), np.int32)
    rng = np.random.default_rng(6)
    for step in range(3):
        tokens = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)
        adv = np.asarray([True, step != 1, False])
        jl_, jstate = jpm._paged_decode_step(
            jp, jcfg, jstate, jnp.asarray(tables), jnp.asarray(tokens),
            jnp.asarray(adv), jopts, "kernel", True)
        tl_ = tpm._paged_decode_step(
            tp, tcfg, tstate, torch.from_numpy(tables), torch.from_numpy(tokens),
            torch.from_numpy(adv), topts, "kernel")
        _close(tl_[adv], np.asarray(jl_)[adv], LOGITS_TOL)
        for (path, t), (jpath, j) in zip(_leaves(tstate), _leaves(jstate)):
            assert path == jpath
            # held to the leaf's largest entry: mLSTM's C sums outer products
            j = np.asarray(j)
            np.testing.assert_allclose(_np(t), j, rtol=0,
                                       atol=LOGITS_TOL * max(np.abs(j).max(), 1.0))
    assert not tstate["main"][0][list(tstate["main"][0])[0]][:, 2].any()  # idle slot


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_paged_reset_slot_zeroes_per_slot_state(arch):
    """Admission zeroes the slot's rows of every per-slot leaf (sLSTM's n
    becomes 0, as the reference's reset gives) and leaves other slots."""
    cfg = reduced_config(arch)
    state = tpm.init_paged_state(cfg, 3, 4, 2, torch.float32, "cpu")
    for _, t in _leaves(state):
        t.fill_(1)
    tpm.make_reset_slot(cfg)(state, 1, 0)
    for path, t in _leaves(state):
        if path == ("len",):
            assert t.tolist() == [1, 0, 1]
            continue
        slot_axis = 1 if path[0] == "main" else 0
        assert not t.select(slot_axis, 1).any(), path
        assert t.select(slot_axis, 0).eq(1).all() and t.select(slot_axis, 2).eq(1).all()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-9b", "internvl2-26b"])
def test_init_params_cast_as_drawn_equals_cast_params(arch):
    """``init_params(..., dtype=bf16)`` casts each layer as it is drawn:
    the same tensors, bit for bit and leaf for leaf, as ``cast_params`` of
    the f32 parameters."""
    cfg = reduced_config(arch)
    want = cast_params(init_params(cfg, seed=3, device="cpu"), torch.bfloat16)
    got = init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    want, got = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path
