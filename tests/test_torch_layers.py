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

ARCHS = ["gemma-2b", "qwen3-14b", "qwen1.5-4b", "musicgen-large"]


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
    qkv bias, qk-norm, frontend), and the same init scale per leaf."""
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


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-moe-16b"])
def test_layers_outside_the_slice_raise(arch):
    with pytest.raises(NotImplementedError):
        init_params(reduced_config(arch), device="cpu")


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
