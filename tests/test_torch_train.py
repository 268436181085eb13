"""The port's training slice against the JAX package's, on the CPU in f32:
the flash-attention backward (plain path of ``flash_attention_train`` and
``flash_attention_bwd_ref``) against the Pallas backward in interpret
mode, RMSNorm's backward, ``loss_fn`` and its gradients, AdamW and
clipping, two train steps, and the data stream.  The same numpy inputs,
the reference's weights (through ``repro_torch.convert``) and the
reference's batches go through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data import StreamSource as JaxStreamSource
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_attention_bwd as jax_flash_attention_bwd
from repro.kernels.flash_attention import flash_attention_train as jax_flash_attention_train
from repro.models import ModelOptions as JaxModelOptions
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jax_loss_fn
from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import adamw_update as jax_adamw_update
from repro.train import clip_by_global_norm as jax_clip_by_global_norm
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import kernels as tk
from repro_torch.configs import reduced_config
from repro_torch.convert import (
    map_params,
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data import StreamSource
from repro_torch.models import ModelOptions, loss_fn
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    adamw_update,
    clip_by_global_norm,
    init_train_state,
    make_train_step,
)

JOPTS = JaxModelOptions(compute_dtype="float32")
TOPTS = ModelOptions(compute_dtype="float32")
# the tolerance of tests/test_kernels.py::test_flash_attention_backward_kernels
BWD_ATOL, BWD_RTOL = 5e-5, 5e-4
# loss relative; each gradient leaf against its largest entry: the same f32
# arithmetic summed in another order through a reduced stack (the forward's
# logits already part by up to 1e-4 of the largest, test_torch_models.py)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
# loss and grad norm after two steps (abs), parameters (abs): the bounds of
# tests/test_sharding_multi.py:77-78
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-3, 1e-4
# each leaf's change over the steps, and each moment leaf, against its
# largest entry (the measured parts are about 3e-5 and 2e-6)
STEP_LEAF_TOL = 1e-4
# The train steps run an optimizer whose update the bounds above can see:
# under the default (lr 3e-4 warmed up over 100 steps) two steps move an
# entry by about 1e-5, inside STEP_PARAM_TOL.  Warmup over 4 steps keeps
# the step count in the learning rate.  eps 1e-4 keeps Adam's first steps,
# g / (|g| + eps), well conditioned: at eps 1e-8 entries whose gradient is
# near eps turn a 1e-9 part between two correct gradients into a part of
# 2e-2 of the leaf's largest change.
STEP_OPT = {"lr": 1e-2, "warmup_steps": 4, "eps": 1e-4}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _leaves(tree) -> list:
    """A tree's leaves as f32 numpy arrays, in JAX's order (sorted keys)."""
    return [_np(a) for a in jax.tree.leaves(map_params(lambda _k, t: _np(t), tree))]


def _leaf_close(got, want, tol):
    """Every leaf within ``tol`` of that leaf's largest entry."""
    g_leaves, w_leaves = _leaves(got), _leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30))


# ------------------------------------------------------- flash backward


def _attn_inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 32), (2, 256, 4, 2, 64), (1, 256, 4, 1, 64),
])
def test_flash_attention_backward_matches_pallas(B, S, H, KV, D):
    """The shapes of tests/test_kernels.py::test_flash_attention_backward_kernels:
    ``flash_attention_train``'s gradients (the plain path on the CPU) against
    the Pallas custom VJP's, and ``flash_attention_bwd_ref`` on the forward's
    own (out, lse) against the Pallas backward passes."""
    q, k, v, w = _attn_inputs(B, S, H, KV, D, B * S + H)
    qj, kj, vj, wj = (jnp.asarray(a) for a in (q, k, v, w))

    def jloss(q, k, v):
        return jnp.sum(jax_flash_attention_train(q, k, v, 64, 64, True, True) * wj)

    want = jax.grad(jloss, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tk.flash_attention_train(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=BWD_ATOL,
                                   rtol=BWD_RTOL)

    out, lse = jax_flash_attention(qj, kj, vj, block_q=64, block_k=64,
                                   interpret=True, return_lse=True)
    want = jax_flash_attention_bwd(qj, kj, vj, out, lse, wj, block_q=64,
                                   block_k=64, interpret=True)
    got = tk.ref.flash_attention_bwd_ref(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, w)))
    assert [g.shape for g in got] == [r.shape for r in want]
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=BWD_ATOL,
                                   rtol=BWD_RTOL)


@pytest.mark.parametrize("S,H,KV,D", [(100, 4, 2, 32), (37, 8, 1, 64)])
def test_flash_attention_backward_ragged_matches_reference(S, H, KV, D):
    """Sequence lengths the Pallas backward would cut (``S // block``):
    against autodiff through the JAX oracle ``ref.causal_attention_ref``."""
    q, k, v, w = _attn_inputs(2, S, H, KV, D, S + H)
    wj = jnp.asarray(w)
    want = jax.grad(lambda q, k, v: jnp.sum(jref.causal_attention_ref(q, k, v) * wj),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tk.flash_attention_train(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=BWD_ATOL,
                                   rtol=BWD_RTOL)


@pytest.mark.parametrize("S,H,KV,window", [(128, 4, 2, 64), (96, 8, 1, 32)])
def test_windowed_flash_backward_matches_local_band_attention(S, H, KV, window):
    """The windowed backward's plain version (``flash_attention_train`` with
    a window on the CPU: ``flash_attention_bwd_ref`` on the forward's own
    out and LSE) against ``jax.grad`` of the reference's local attention,
    ``layers.local_band_attention`` (K/V expanded to the query heads, their
    gradients summed back over each group)."""
    q, k, v, w = _attn_inputs(2, S, H, KV, 32, S + window)
    G = H // KV
    wj = jnp.asarray(w)

    def jloss(q, k, v):
        kx, vx = (jnp.repeat(x, G, axis=2) for x in (k, v))
        return jnp.sum(jlayers.local_band_attention(q, kx, vx, window=window) * wj)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tk.flash_attention_train(qt, kt, vt, window=window) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=BWD_ATOL,
                                   rtol=BWD_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax(dtype):
    """The backward the CUDA RMSNorm's autograd function runs
    (``rmsnorm_bwd_ref``) against ``jax.grad`` through the reference's
    plain RMSNorm, the one its training path differentiates."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 17, 256)).astype(np.float32)
    scale = (rng.standard_normal(256) * 0.1).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    _, vjp = jax.vjp(jlayers.rmsnorm, jnp.asarray(x).astype(jdt), jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy).astype(jdt))
    dx, ds = tk.ref.rmsnorm_bwd_ref(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(scale),
                                    torch.from_numpy(dy).to(tdt))
    assert dx.dtype == tdt and ds.dtype == torch.float32
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(_np(dx), _np(want_dx.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # dscale sums 51 rows: held relative to its largest entry
    np.testing.assert_allclose(_np(ds), _np(want_ds), rtol=0,
                               atol=tol * np.abs(_np(want_ds)).max())


def test_decode_wrappers_refuse_grad():
    """Neither decode kernel has a backward: inputs that require grad are
    refused under grad mode (on either device) and taken under no_grad."""
    q = torch.zeros(2, 4, 32, requires_grad=True)
    cache = torch.zeros(2, 16, 2, 32)
    lens = torch.ones(2, dtype=torch.int32)
    pool = torch.zeros(5, 4, 2, 32)
    tables = torch.ones(2, 3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        tk.decode_attention(q, cache, cache, lens)
    with pytest.raises(RuntimeError, match="no backward"):
        tk.paged_decode_attention(q, pool, pool, tables, lens)
    with torch.no_grad():
        assert tk.decode_attention(q, cache, cache, lens).shape == (2, 4, 32)
        assert tk.paged_decode_attention(q, pool, pool, tables, lens).shape == (2, 4, 32)


# ------------------------------------------------------------------ loss


def _batch(cfg, B, S, seed, masked=()):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    for b, s in masked:
        labels[b, s] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b"])
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and its gradients (flash path, remat on: the plain
    versions on the CPU) against ``jax.value_and_grad(loss_fn)`` on the
    reference's weights, with some labels masked."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, 2, 24, seed=3, masked=[(0, 0), (0, 5), (1, 23)])
    (jloss, jm), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, JOPTS)
    tp = params_from_numpy(jp, device="cpu")
    map_params(lambda _k, p: p.requires_grad_(True), tp)
    tloss, tm = loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                        TOPTS)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]),
                               rtol=LOSS_RTOL)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 24 - 3
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    _leaf_close(map_params(lambda _k, p: p.grad, tp), jgrads, GRAD_TOL)


NEW_FAMILIES = ["deepseek-moe-16b", "musicgen-large", "internvl2-26b"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_moe_and_frontend_loss_and_grads_match_jax(arch):
    """``loss_fn`` (ce plus the weighted aux loss) and its gradients for an
    MoE family (the router's, the experts' and the shared experts'
    gradients included) and the two frontend families (the frontend
    projection's gradient, the prefix's logits cut off), some labels
    masked.  The loss against ``jax.value_and_grad``'s; each gradient leaf
    against the reference's run in f64 on the same f32 weights, within
    GRAD_TOL of the leaf's largest entry or no farther from it than the
    reference's own f32 gradient is.  At reduced deepseek-moe-16b the
    reference's f32 wq and wk gradients of the first layer part from its
    f64 ones by 1.5e-4 of their largest entry (behind the nearly hard
    attention of the reference's init; ROADMAP Queue 3), the port's by
    5e-5, so the f32 pair parts by 1.4e-4."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, 2, 24, seed=4, masked=[(0, 1), (1, 0)])
    if jcfg.frontend:
        batch["frontend_embeds"] = np.random.default_rng(9).standard_normal(
            (2, jcfg.frontend_len, jcfg.frontend_dim)).astype(np.float32)
    (jloss, jm), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, JOPTS)
    with jax.enable_x64(True):
        wide = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
                for k, v in batch.items()}
        exact = jax.device_get(jax.grad(lambda p: jax_loss_fn(
            p, jcfg, wide, JaxModelOptions(compute_dtype="float64"))[0])(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)))
    tp = params_from_numpy(jp, device="cpu")
    map_params(lambda _k, p: p.requires_grad_(True), tp)
    tloss, tm = loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                        TOPTS)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    for name in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL)
    assert (float(tm["aux_loss"]) > 0) == (tcfg.moe is not None)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 24 - 2
    got = _leaves(map_params(lambda _k, p: p.grad, tp))
    for g, j, e in zip(got, _leaves(jgrads), jax.tree.leaves(exact)):
        scale = np.abs(e).max()
        ref_err = np.abs(j - e).max() / scale
        assert np.abs(g - e).max() / scale <= max(GRAD_TOL, ref_err), (
            np.abs(g - e).max() / scale, ref_err)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_moe_and_frontend_train_steps_match_jax(arch):
    """Two train steps from the reference's initial state on its batches
    (8 x 32 tokens of its StreamSource, frontend embeddings included), the
    port with remat and the reference without: both steps' loss and the
    first step's grad norm within STEP_LOSS_TOL, the parameters after the
    first step within STEP_PARAM_TOL.

    Held after one step, not two as ``test_train_steps_match_jax`` holds
    qwen3-14b: Adam's first step divides by |g| + eps, so gradients that
    part by 1e-5 of their largest entry (f32 rounding, which the
    reference's own f32 and f64 runs show too) move the entries near eps
    apart, and the second step's parameters and gradient follow.  The
    second step's loss is held."""
    jcfg = jax_reduced_config(arch)
    src = JaxStreamSource(vocab_size=jcfg.vocab_size, batch=8, seq_len=32, seed=0,
                          frontend_len=jcfg.frontend_len, frontend_dim=jcfg.frontend_dim)
    batches = [{k: np.asarray(v) for k, v in src.batch_at(i).items()} for i in range(2)]
    tcfg_j = JaxTrainConfig(optimizer=JaxOptimizerConfig(**STEP_OPT), remat=False)
    jstate = jax_init_train_state(jax.random.key(0), jcfg, tcfg_j)
    jstep = jax.jit(jax_make_train_step(jcfg, tcfg_j, JOPTS))

    cfg = reduced_config(arch)
    step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**STEP_OPT)), TOPTS)
    state = train_state_from_numpy(jax.device_get(jstate), device="cpu")
    for i, b in enumerate(batches):
        jstate, want = jstep(jstate, b)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - float(want["loss"])) < STEP_LOSS_TOL
        if i == 0:
            assert abs(float(m["grad_norm"]) - float(want["grad_norm"])) < STEP_LOSS_TOL
            for x, y in zip(_leaves(state["params"]),
                            _leaves(jax.device_get(jstate)["params"])):
                np.testing.assert_allclose(x, y, rtol=0, atol=STEP_PARAM_TOL)
    assert int(state["step"]) == 2


RECURRENT = ["recurrentgemma-9b", "xlstm-125m"]
# the Adam eps of the recurrent train steps: their gradients part from the
# reference's by f32 rounding amplified through the stack (up to 3e-4 of a
# leaf's largest entry, the reference's own f32 gradients as far from its
# exact ones), and the first step's g / (|g| + eps) turns that into a
# parameter part of 1.3e-4 at eps 1e-4 (2.3e-5 at 1e-3)
RECURRENT_STEP_OPT = dict(STEP_OPT, eps=1e-3)
# the first step's grad norm, relative: the norm of those gradients
GRAD_NORM_RTOL = 1e-3


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``: patched over the
    reference's model modules for one exact run, so every f32 cast the
    reference makes (the gates, the norms' statistics, the recurrences'
    carries) is f64 too."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _exact_grads(monkeypatch, jp, jcfg, batch):
    """The reference's gradient of ``loss_fn`` computed wholly in f64."""
    from repro.models import layers as jlayers_mod
    from repro.models import lm as jlm
    from repro.models import recurrent as jrec
    with monkeypatch.context() as m:
        for mod in (jlayers_mod, jlm, jrec):
            m.setattr(mod, "jnp", _Wide())
        with jax.enable_x64(True):
            wide = {k: jnp.asarray(v) for k, v in batch.items()}
            grads = jax.grad(lambda p: jax_loss_fn(
                p, jcfg, wide, JaxModelOptions(compute_dtype="float64"))[0])(
                jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp))
            return [np.asarray(g) for g in jax.tree.leaves(jax.device_get(grads))]


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b"])
def test_f64_plain_run_matches_jax_f64(arch):
    """The exact run that ``chip_smoke.py`` and the card tests hold f32
    gradients to: the port's plain path with f64 weights, every
    ``.float()`` leaving f64 tensors f64 (``test_torch_gpu._f64_plain``),
    against the reference's f64 run, within 5e-5 of each leaf's largest
    entry (the reference's f64 run keeps its norms' statistics and its
    router's softmax inputs in f32, ``astype(jnp.float32)``)."""
    from test_torch_gpu import _f64_plain

    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, 2, 24, seed=4, masked=[(0, 1), (1, 0)])
    with jax.enable_x64(True):
        wide = {k: jnp.asarray(v) for k, v in batch.items()}
        exact = jax.device_get(jax.grad(lambda p: jax_loss_fn(
            p, jcfg, wide, JaxModelOptions(compute_dtype="float64"))[0])(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)))
    tp = map_params(lambda _k, p: p.double().requires_grad_(True),
                    params_from_numpy(jp, device="cpu"))
    with _f64_plain():
        loss, _ = loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                          ModelOptions(compute_dtype="float64", attn_impl="plain"))
        loss.backward()
    got = jax.tree.leaves(map_params(lambda _k, p: p.grad.numpy(), tp))
    assert all(g.dtype == np.float64 for g in got)
    for g, e in zip(got, jax.tree.leaves(exact)):
        np.testing.assert_allclose(g, e, rtol=0, atol=5e-5 * np.abs(e).max())


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_loss_and_grads_match_jax(arch, monkeypatch):
    """``loss_fn`` and its gradients on the port's default kernel path (on
    the CPU the plain versions behind the kernels' autograd functions: the
    windowed flash backward, the RG-LRU reverse scan, autograd through the
    mLSTM chunk recurrence, the sLSTM hand-written VJP), remat on, against
    ``jax.value_and_grad(loss_fn)``.  S = 128: past the reduced window of
    64, and a multiple of the mLSTM chunk.

    The loss is held within LOSS_RTOL.  The gradients are held to the
    reference's run in f64 on the same f32 weights: at this length the
    reference's own f32 gradients part from its f64 ones by up to 3e-4 of
    a leaf's largest entry (and an sLSTM input-gate bias, whose gradient
    cancels through the stabilizer, by 0.19), so GRAD_TOL against the f32
    run would hold rounding, not the port.  Each leaf of the port's
    gradient lies within GRAD_TOL of the f64 one or within twice the
    reference's own f32 distance from it (both f32 runs carry their own
    rounding: the bound of their sum)."""
    jcfg, tcfg = jax_reduced_config(arch), reduced_config(arch)
    jp = jax_init_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, 2, 128, seed=5, masked=[(0, 3), (1, 127)])
    (jloss, jm), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, JOPTS)
    exact = _exact_grads(monkeypatch, jp, jcfg, batch)
    tp = params_from_numpy(jp, device="cpu")
    map_params(lambda _k, p: p.requires_grad_(True), tp)
    tloss, tm = loss_fn(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                        TOPTS)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 128 - 2
    got = _leaves(map_params(lambda _k, p: p.grad, tp))
    assert len(got) == len(exact)
    for g, j, e in zip(got, _leaves(jgrads), exact):
        scale = np.abs(e).max()
        port_err, ref_err = np.abs(g - e).max() / scale, np.abs(j - e).max() / scale
        assert port_err <= max(GRAD_TOL, 2 * ref_err), (port_err, ref_err)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_steps_match_jax(arch):
    """Two train steps of a recurrent family from the reference's initial
    state on its batches (4 x 128 tokens of its StreamSource), the port
    with remat on and off (equal bit for bit), held as
    ``test_moe_and_frontend_train_steps_match_jax`` holds the MoE and
    frontend families: both steps' loss within STEP_LOSS_TOL, the first
    step's grad norm within GRAD_NORM_RTOL and its parameters within
    STEP_PARAM_TOL.  After the first step the two runs' parameters part by
    the gradients' f32 rounding (held in
    ``test_recurrent_loss_and_grads_match_jax``), which the chaotic stack
    grows: the second step's grad norm parts by up to a few percent."""
    jcfg = jax_reduced_config(arch)
    src = JaxStreamSource(vocab_size=jcfg.vocab_size, batch=4, seq_len=128, seed=0)
    batches = [{k: np.asarray(v) for k, v in src.batch_at(i).items()} for i in range(2)]
    tcfg_j = JaxTrainConfig(optimizer=JaxOptimizerConfig(**RECURRENT_STEP_OPT), remat=False)
    jstate0 = jax_init_train_state(jax.random.key(0), jcfg, tcfg_j)
    jstep = jax.jit(jax_make_train_step(jcfg, tcfg_j, JOPTS))
    jstate1, want1 = jstep(jstate0, batches[0])
    _, want2 = jstep(jstate1, batches[1])
    cfg = reduced_config(arch)
    ports = {}
    for remat in (False, True):
        step = make_train_step(cfg, TrainConfig(
            optimizer=OptimizerConfig(**RECURRENT_STEP_OPT), remat=remat), TOPTS)
        state = train_state_from_numpy(jax.device_get(jstate0), device="cpu")
        metrics, after_one = [], None
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            if after_one is None:
                after_one = [x.copy() for x in _leaves(state["params"])]  # updated in place
        ports[remat] = (state, metrics, after_one)
    (s_off, m_off, _), (s_on, m_on, p_one) = ports[False], ports[True]
    assert m_off == m_on
    for x, y in zip(_leaves(s_off), _leaves(s_on)):
        np.testing.assert_array_equal(x, y)
    assert int(s_on["step"]) == 2
    for got, want in zip(m_on, (want1, want2)):
        assert abs(got["loss"] - float(want["loss"])) < STEP_LOSS_TOL
    gn = float(want1["grad_norm"])
    assert abs(m_on[0]["grad_norm"] - gn) <= GRAD_NORM_RTOL * gn
    for x, y in zip(p_one, _leaves(jax.device_get(jstate1)["params"])):
        np.testing.assert_allclose(x, y, rtol=0, atol=STEP_PARAM_TOL)


def test_loss_of_fully_masked_batch_is_zero():
    cfg = reduced_config("gemma-2b")
    params = params_from_numpy(
        jax_init_params(jax.random.key(0), jax_reduced_config("gemma-2b")), device="cpu")
    batch = _batch(cfg, 1, 8, seed=1)
    batch["labels"][:] = -1
    loss, m = loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                      TOPTS)
    assert float(loss) == 0.0 and float(m["tokens"]) == 0.0


# ----------------------------------------------------------- optimizer


def _random_tree(rng, scale=1.0):
    shapes = {"a": (4, 5), "b": [{"w": (3, 2)}, {"scale": (7,)}]}
    return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("step,clip", [(0, 1.0), (3, 100.0), (250, 0.5)])
def test_adamw_and_clip_match_jax(step, clip):
    """Clipping and one AdamW update (warmup and bias correction at
    ``step``) on a random tree, against the reference's."""
    rng = np.random.default_rng(step)
    params, grads = _random_tree(rng), _random_tree(rng, 3.0)
    m, v = _random_tree(rng, 0.1), jax.tree.map(np.abs, _random_tree(rng, 0.1))
    ocfg_j = JaxOptimizerConfig(lr=1e-2, warmup_steps=10)
    ocfg_t = OptimizerConfig(lr=1e-2, warmup_steps=10)

    jg, jnorm = jax_clip_by_global_norm(jax.tree.map(jnp.asarray, grads), clip)
    jp, jopt = jax_adamw_update(ocfg_j, jax.tree.map(jnp.asarray, params), jg,
                                {"m": jax.tree.map(jnp.asarray, m),
                                 "v": jax.tree.map(jnp.asarray, v)},
                                jnp.asarray(step, jnp.int32))
    t = {name: params_from_numpy(tree, device="cpu")
         for name, tree in (("p", params), ("g", grads), ("m", m), ("v", v))}
    tg, tnorm = clip_by_global_norm(t["g"], clip)
    tp, topt = adamw_update(ocfg_t, t["p"], tg, {"m": t["m"], "v": t["v"]},
                            torch.tensor(step, dtype=torch.int32))
    assert tp is t["p"] and topt["m"] is t["m"]  # updated in place
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for got, want in ((tg, jg), (tp, jp), (topt["m"], jopt["m"]),
                      (topt["v"], jopt["v"])):
        _leaf_close(got, want, 1e-6)


# -------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def jax_two_steps():
    """The reference's two train steps on reduced qwen3-14b (8 x 32 tokens
    of its StreamSource), per accum_steps, cached across the cases."""
    cfg = jax_reduced_config("qwen3-14b")
    src = JaxStreamSource(vocab_size=cfg.vocab_size, batch=8, seq_len=32, seed=0)
    batches = [{k: np.asarray(v) for k, v in src.batch_at(i).items()} for i in range(2)]
    runs = {}

    def run(accum):
        if accum not in runs:
            tcfg = JaxTrainConfig(optimizer=JaxOptimizerConfig(**STEP_OPT),
                                  accum_steps=accum, remat=False)
            state0 = jax_init_train_state(jax.random.key(0), cfg, tcfg)
            step = jax.jit(jax_make_train_step(cfg, tcfg, JOPTS))
            s1, m1 = step(state0, batches[0])
            s2, m2 = step(s1, batches[1])
            runs[accum] = {"state0": jax.device_get(state0),
                           "state1": jax.device_get(s1), "state2": jax.device_get(s2),
                           "metrics": [jax.device_get(m1), jax.device_get(m2)]}
        return runs[accum]

    return run, batches


def _port_two_steps(state, batches, accum, remat):
    cfg = reduced_config("qwen3-14b")
    tcfg = TrainConfig(optimizer=OptimizerConfig(**STEP_OPT), accum_steps=accum,
                       remat=remat)
    step = make_train_step(cfg, tcfg, TOPTS)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _steps_close(got, want, start):
    """Held after the steps: each parameter leaf's change from ``start``
    against the reference's change, and each moment leaf, both relative to
    the leaf's largest entry; the parameters also within STEP_PARAM_TOL
    abs."""
    p0 = _leaves(start["params"])
    for a, x, y in zip(p0, _leaves(got["params"]), _leaves(want["params"])):
        np.testing.assert_allclose(x - a, y - a, rtol=0,
                                   atol=STEP_LEAF_TOL * np.abs(y - a).max())
        np.testing.assert_allclose(x, y, rtol=0, atol=STEP_PARAM_TOL)
    for name in ("m", "v"):
        _leaf_close(got["opt"][name], want["opt"][name], STEP_LEAF_TOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(jax_two_steps, accum):
    """Two steps from the reference's initial state on its batches: loss
    and grad norm within 1e-3, each leaf's change and the moments within
    1e-4 of their largest entry, for remat on and off (which must agree bit
    for bit)."""
    run, batches = jax_two_steps
    ref = run(accum)
    ports = {}
    for remat in (False, True):
        state = train_state_from_numpy(ref["state0"], device="cpu")
        ports[remat] = _port_two_steps(state, batches, accum, remat)
    (s_off, m_off), (s_on, m_on) = ports[False], ports[True]
    assert m_off == m_on
    for x, y in zip(_leaves(s_off), _leaves(s_on)):
        np.testing.assert_array_equal(x, y)
    assert int(s_on["step"]) == 2
    for got, want in zip(m_on, ref["metrics"]):
        assert abs(got["loss"] - float(want["loss"])) < STEP_LOSS_TOL
        assert abs(got["grad_norm"] - float(want["grad_norm"])) < STEP_LOSS_TOL
    _steps_close(s_on, ref["state2"], ref["state0"])


def test_train_step_from_jax_state_after_step_one(jax_two_steps):
    """The port's second step started from the reference's state after its
    first (parameters and moments), against the reference's second."""
    run, batches = jax_two_steps
    ref = run(1)
    state = train_state_from_numpy(ref["state1"], device="cpu")
    assert int(state["step"]) == 1
    state, metrics = _port_two_steps(state, batches[1:], 1, remat=True)
    assert abs(metrics[0]["loss"] - float(ref["metrics"][1]["loss"])) < STEP_LOSS_TOL
    assert abs(metrics[0]["grad_norm"] - float(ref["metrics"][1]["grad_norm"])) \
        < STEP_LOSS_TOL
    _steps_close(state, ref["state2"], ref["state1"])


def test_train_state_round_trip():
    cfg = jax_reduced_config("gemma-2b")
    jstate = jax.device_get(jax_init_train_state(jax.random.key(1), cfg))
    state = train_state_from_numpy(jstate, device="cpu")
    flags = []
    map_params(lambda _k, p: flags.append(p.requires_grad), state["params"])
    assert flags and all(flags)
    back = train_state_to_numpy(state)
    assert back["step"] == 0 and back["step"].dtype == np.int32
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))


def test_unported_training_options_raise():
    """Options the step cannot take: compression without a mesh that has a
    ``pod`` axis (the reference asserts one), a batch that does not split
    into ``accum_steps``.  Without a mesh the compressed state carries the
    reference's EF buffers, one per pod."""
    cfg = reduced_config("gemma-2b")
    with pytest.raises(ValueError):
        make_train_step(cfg, TrainConfig(compress_pod_grads=True))
    state = init_train_state(cfg, TrainConfig(compress_pod_grads=True, num_pods=2),
                             device="cpu")
    table = state["ef"]["embed"]["table"]
    assert table.shape == (2, *state["params"]["embed"]["table"].shape)
    assert table.dtype == torch.float32 and not table.any()
    with pytest.raises(ValueError):  # batch not a multiple of accum_steps
        step = make_train_step(cfg, TrainConfig(accum_steps=2), TOPTS)
        step(init_train_state(cfg, device="cpu"),
             {"tokens": torch.zeros(3, 4, dtype=torch.int32),
              "labels": torch.zeros(3, 4, dtype=torch.int32)})


# ---------------------------------------------------------------- stream


@pytest.mark.parametrize("offset,seed", [(0, 0), (17, 5), (10_000, 2 ** 16)])
def test_stream_pure_function_of_offset(offset, seed):
    src = StreamSource(vocab_size=128, batch=2, seq_len=16, seed=seed)
    a, b = src.batch_at(offset), src.batch_at(offset)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (2, 16)
    full = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1)
    assert torch.equal(full[:, 1:], a["labels"])  # labels are next-tokens
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 128


@pytest.mark.parametrize("mode", ["lcg", "random"])
def test_stream_distinct_offsets_differ(mode):
    src = StreamSource(vocab_size=512, batch=2, seq_len=32, seed=0, mode=mode)
    assert not torch.equal(src.batch_at(0)["tokens"], src.batch_at(1)["tokens"])
    other = StreamSource(vocab_size=512, batch=2, seq_len=32, seed=1, mode=mode)
    assert not torch.equal(src.batch_at(0)["tokens"], other.batch_at(0)["tokens"])


def test_stream_lcg_mode_is_low_entropy():
    src = StreamSource(vocab_size=503, batch=4, seq_len=256, seed=1, mode="lcg",
                       noise=0.05)
    b = src.batch_at(0)
    pred = (8121 % 503 * b["tokens"].long() + 28411 % 503) % 503
    assert (pred == b["labels"]).float().mean() > 0.85


@pytest.mark.parametrize("vocab", [503, 256000])
def test_stream_noise_free_lcg_follows_the_recurrence_in_both(vocab):
    """With ``noise=0`` both packages' tokens follow ``x' = (a*x + c) mod V``
    exactly (the draws differ: torch's generator is not JAX's)."""
    a, c = 8121 % vocab or 13, 28411 % vocab
    for src in (StreamSource(vocab, 3, 64, seed=2, noise=0.0),
                JaxStreamSource(vocab, 3, 64, seed=2, noise=0.0)):
        b = src.batch_at(5)
        toks, labels = np.asarray(b["tokens"], np.int64), np.asarray(b["labels"])
        np.testing.assert_array_equal((a * toks + c) % vocab, labels)
