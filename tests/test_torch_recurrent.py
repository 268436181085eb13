"""The port's recurrent blocks (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM and their temporal conv) against the JAX package's, on the
same numpy inputs and the same weights (the reference's ``init_*`` through
``repro_torch.convert``), in f32 on the CPU, at the reduced configs' widths.
The port's kernel wrappers run their plain versions here."""

import functools
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jr
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.convert import map_params, params_from_numpy
from repro_torch.kernels import ref as kernels_ref
from repro_torch.models import recurrent as tr
from repro_torch.sharding import collectives, ctx, specs

# f32, the same arithmetic summed in another order (matmuls of width <=
# 512; a sequential scan against JAX's associative scan; the chunkwise
# mLSTM's einsums), held to the largest element
TOL = 2e-5
IMPLS = ["kernel", "plain"]
RG = reduced_config("recurrentgemma-9b")  # d 128, d_rnn 128, conv width 4
XL = reduced_config("xlstm-125m")  # d 128, 4 heads: dk 64, sLSTM dh 32


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL):
    """|got - want| <= tol * max(max |want|, 1), elementwise."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1.0))


def _trees_close(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want), (set(got), set(want))
    for key in want:
        _close(got[key], want[key], tol)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _params(init, *args, seed=0):
    jp = init(jax.random.key(seed), *args)
    return jp, params_from_numpy(jp, device="cpu")


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


# ------------------------------------------------------------------- conv


@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_seq_and_tail_match_jax(S):
    xj, xt = _both(_x((2, S, RG.d_rnn)))
    wj, wt = _both(_x((RG.conv_width, RG.d_rnn), 1, 0.5))
    bj, bt = _both(_x((RG.d_rnn,), 2, 0.1))
    _close(tr.causal_conv_seq(xt, wt, bt), jr.causal_conv_seq(xj, wj, bj))
    # the tail, zero-padded at the front when S < W - 1
    _close(tr._conv_tail(xt, RG.conv_width), jr._conv_tail(xj, RG.conv_width))


def test_causal_conv_step_matches_jax():
    xj, xt = _both(_x((3, RG.d_rnn)))
    sj, st = _both(_x((3, RG.conv_width - 1, RG.d_rnn), 1))
    wj, wt = _both(_x((RG.conv_width, RG.d_rnn), 2, 0.5))
    bj, bt = _both(_x((RG.d_rnn,), 3, 0.1))
    (oj, nj), (ot, nt) = jr.causal_conv_step(xj, sj, wj, bj), tr.causal_conv_step(xt, st, wt, bt)
    _close(ot, oj)
    _close(nt, nj)


def test_conv_step_continues_conv_seq():
    """The step conv from the sequence's tail gives the next position of
    the sequence conv (the port alone)."""
    x = torch.from_numpy(_x((2, 12, 16)))
    w, b = torch.from_numpy(_x((4, 16), 1)), torch.from_numpy(_x((16,), 2))
    seq = tr.causal_conv_seq(x, w, b)
    out, _ = tr.causal_conv_step(x[:, 11], tr._conv_tail(x[:, :11], 4), w, b)
    _close(out, seq[:, 11])


# ------------------------------------------------------------------ params


@pytest.mark.parametrize("block", ["rglru", "mlstm", "slstm"])
def test_init_same_tree_and_scales(block):
    """The port's ``init_*`` give the reference's keys, shapes and
    per-leaf spread (the draws differ: torch's generator is not JAX's)."""
    d, H, W = 128, 4, 4
    args = {"rglru": (d, 96, W), "mlstm": (d, H, W), "slstm": (d, H)}[block]
    jp = dict(_leaves(getattr(jr, f"init_{block}")(jax.random.key(0), *args)))
    gen = torch.Generator().manual_seed(0)
    tp = dict(_leaves(getattr(tr, f"init_{block}")(gen, *args)))
    assert jp.keys() == tp.keys()
    for path, t in tp.items():
        j = np.asarray(jp[path])
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        if path == ("lam",):  # a = exp(-c softplus(lam)) lies in [0.9, 0.999]
            a = torch.exp(-tr.RGLRU_C * torch.nn.functional.softplus(t))
            assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
        elif j.std() > 0 and path[-1].startswith(("w", "r", "conv_w")):
            assert abs(float(t.std()) / float(j.std()) - 1) < 0.15, path
        else:  # zeros, constants and linspaces: the same numbers
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ rg-lru


def test_rglru_gates_match_jax():
    jp, tp = _params(jr.init_rglru, RG.d_model, RG.d_rnn, RG.conv_width)
    xj, xt = _both(_x((2, 5, RG.d_rnn)))
    for got, want in zip(tr._rglru_gates(tp, xt), jr._rglru_gates(jp, xj)):
        _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", [2, 64])
def test_rglru_seq_matches_jax(impl, S):
    jp, tp = _params(jr.init_rglru, RG.d_model, RG.d_rnn, RG.conv_width)
    xj, xt = _both(_x((2, S, RG.d_model)))
    _close(tr.rglru_seq(tp, xt, impl=impl), jr.rglru_seq(jp, xj))
    got, gstate = tr.rglru_seq(tp, xt, return_state=True, impl=impl)
    want, wstate = jr.rglru_seq(jp, xj, return_state=True)
    _close(got, want)
    _trees_close(gstate, wstate)
    assert gstate["h"].dtype == torch.float32


def test_rglru_step_matches_jax():
    """Four steps from the reference's initial state, then one from a
    prefilled state."""
    jp, tp = _params(jr.init_rglru, RG.d_model, RG.d_rnn, RG.conv_width)
    xs = _x((5, 2, RG.d_model))
    jstate = jr.rglru_init_state(2, RG.d_rnn, RG.conv_width, jnp.float32)
    tstate = tr.rglru_init_state(2, RG.d_rnn, RG.conv_width, torch.float32, "cpu")
    _trees_close(tstate, jstate)
    for x in xs[:4]:
        (jo, jstate), (to, tstate) = (jr.rglru_step(jp, jnp.asarray(x), jstate),
                                      tr.rglru_step(tp, torch.from_numpy(x), tstate))
        _close(to, jo)
        _trees_close(tstate, jstate)
    xj, xt = _both(_x((2, 7, RG.d_model), 3))
    _, jstate = jr.rglru_seq(jp, xj, return_state=True)
    _, tstate = tr.rglru_seq(tp, xt, return_state=True)
    (jo, _), (to, _) = (jr.rglru_step(jp, jnp.asarray(xs[4]), jstate),
                        tr.rglru_step(tp, torch.from_numpy(xs[4]), tstate))
    _close(to, jo)


# ------------------------------------------------------------------- mlstm


def _mlstm_params(seed=0):
    return _params(jr.init_mlstm, XL.d_model, XL.num_heads, XL.conv_width, seed=seed)


def test_mlstm_qkvif_matches_jax():
    jp, tp = _mlstm_params()
    di = 2 * XL.d_model
    (xcj, xct), (xij, xit) = _both(_x((2, 6, di))), _both(_x((2, 6, di), 1))
    for got, want in zip(tr._mlstm_qkvif(tp, xct, xit, XL.num_heads),
                         jr._mlstm_qkvif(jp, xcj, xij, XL.num_heads)):
        _close(got, want)


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (40, 128)])
def test_mlstm_chunk_recurrence_matches_jax(S, chunk):
    """h and the final (C, n, m), on the inputs of test_mlstm_chunk_sweep
    (i_pre ~ N - 2, f_pre ~ N + 3); a chunk above S takes S."""
    B, H, dk = 2, 2, 32
    q, k, v = (_x((B, S, H, dk), s) for s in range(3))
    i_pre, f_pre = _x((B, S, H), 3) - 2.0, _x((B, S, H), 4) + 3.0
    jin = [jnp.asarray(a) for a in (q, k, v, i_pre, f_pre)]
    tin = [torch.from_numpy(a) for a in (q, k, v, i_pre, f_pre)]
    want, wfinal = jr.mlstm_chunk_recurrence(*jin, chunk=chunk, return_final=True)
    got, gfinal = tr.mlstm_chunk_recurrence(*tin, chunk=chunk, return_final=True)
    _close(got, want)
    for g, w in zip(gfinal, wfinal):
        _close(g, w)
    _close(tr.mlstm_chunk_recurrence(*tin, chunk=chunk), want)


def test_mlstm_chunk_must_divide_the_sequence():
    q = torch.zeros(1, 96, 2, 8)
    g = torch.zeros(1, 96, 2)
    with pytest.raises(ValueError):  # the reference asserts S % chunk == 0
        tr.mlstm_chunk_recurrence(q, q, q, g, g, chunk=64)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S,chunk", [(64, 128), (128, 32)])
def test_mlstm_seq_matches_jax(impl, S, chunk):
    jp, tp = _mlstm_params()
    xj, xt = _both(_x((2, S, XL.d_model)))
    _close(tr.mlstm_seq(tp, xt, XL.num_heads, chunk=chunk, impl=impl),
           jr.mlstm_seq(jp, xj, XL.num_heads, chunk=chunk))
    got, gstate = tr.mlstm_seq(tp, xt, XL.num_heads, chunk=chunk,
                               return_state=True, impl=impl)
    want, wstate = jr.mlstm_seq(jp, xj, XL.num_heads, chunk=chunk, return_state=True)
    _close(got, want)
    _trees_close(gstate, wstate)


def test_mlstm_step_matches_jax():
    """Four steps from the reference's initial state, then one from a
    prefilled state."""
    jp, tp = _mlstm_params()
    xs = _x((5, 2, XL.d_model))
    jstate = jr.mlstm_init_state(2, XL.d_model, XL.num_heads, XL.conv_width, jnp.float32)
    tstate = tr.mlstm_init_state(2, XL.d_model, XL.num_heads, XL.conv_width,
                                 torch.float32, "cpu")
    _trees_close(tstate, jstate)
    for x in xs[:4]:
        (jo, jstate), (to, tstate) = (
            jr.mlstm_step(jp, jnp.asarray(x), jstate, XL.num_heads),
            tr.mlstm_step(tp, torch.from_numpy(x), tstate, XL.num_heads))
        _close(to, jo)
        _trees_close(tstate, jstate)
    xj, xt = _both(_x((2, 16, XL.d_model), 3))
    _, jstate = jr.mlstm_seq(jp, xj, XL.num_heads, return_state=True)
    _, tstate = tr.mlstm_seq(tp, xt, XL.num_heads, return_state=True)
    (jo, _), (to, _) = (jr.mlstm_step(jp, jnp.asarray(xs[4]), jstate, XL.num_heads),
                        tr.mlstm_step(tp, torch.from_numpy(xs[4]), tstate, XL.num_heads))
    _close(to, jo)


# ------------------------------------------------------------------- slstm


def _slstm_params(seed=0):
    return _params(jr.init_slstm, XL.d_model, XL.num_heads, seed=seed)


def test_slstm_cell_matches_jax():
    jp, tp = _slstm_params()
    B, d = 3, XL.d_model
    pre = _x((4, B, d))
    state = {k: _x((B, d), i + 1) for i, k in enumerate(("h", "c", "n", "m"))}
    state["n"] = np.abs(state["n"]) + 0.1
    want = jr._slstm_cell(jp, {g: jnp.asarray(pre[i]) for i, g in
                               enumerate(tr.SLSTM_GATES)},
                          {k: jnp.asarray(v) for k, v in state.items()}, XL.num_heads)
    got = tr._slstm_cell(tr._slstm_R(tp), torch.from_numpy(pre),
                         {k: torch.from_numpy(v) for k, v in state.items()})
    _trees_close(got, want)


@pytest.mark.parametrize("S", [1, 24])
def test_slstm_seq_matches_jax(S):
    """Without a state the reference runs its custom-VJP scan, with one its
    per-step cell: the port's loop equals both."""
    jp, tp = _slstm_params()
    xj, xt = _both(_x((2, S, XL.d_model)))
    _close(tr.slstm_seq(tp, xt, XL.num_heads), jr.slstm_seq(jp, xj, XL.num_heads))
    got, gstate = tr.slstm_seq(tp, xt, XL.num_heads, return_state=True)
    want, wstate = jr.slstm_seq(jp, xj, XL.num_heads, return_state=True)
    _close(got, want)
    _trees_close(gstate, wstate)


def test_slstm_step_matches_jax():
    """Four steps from the reference's initial state (n = 1e-6), then one
    from a prefilled state."""
    jp, tp = _slstm_params()
    xs = _x((5, 2, XL.d_model))
    jstate = jr.slstm_init_state(2, XL.d_model)
    tstate = tr.slstm_init_state(2, XL.d_model, "cpu")
    _trees_close(tstate, jstate, 0)
    for x in xs[:4]:
        (jo, jstate), (to, tstate) = (
            jr.slstm_step(jp, jnp.asarray(x), jstate, XL.num_heads),
            tr.slstm_step(tp, torch.from_numpy(x), tstate, XL.num_heads))
        _close(to, jo)
        _trees_close(tstate, jstate)
    xj, xt = _both(_x((2, 9, XL.d_model), 3))
    _, jstate = jr.slstm_seq(jp, xj, XL.num_heads, return_state=True)
    _, tstate = tr.slstm_seq(tp, xt, XL.num_heads, return_state=True)
    (jo, _), (to, _) = (jr.slstm_step(jp, jnp.asarray(xs[4]), jstate, XL.num_heads),
                        tr.slstm_step(tp, torch.from_numpy(xs[4]), tstate, XL.num_heads))
    _close(to, jo)


def test_recurrent_seq_refuses_grad_through_the_kernels():
    """Until the recurrent training slice the kernel path refused inputs
    that require grad.  The RG-LRU and mLSTM kernels now have backward
    kernels, so the kernel path differentiates: on the CPU (the plain
    versions behind the kernels' autograd functions) its input gradients
    equal the plain path's."""
    _, tp = _params(jr.init_rglru, RG.d_model, RG.d_rnn, RG.conv_width)
    x = _x((1, 8, RG.d_model))
    w = _x((1, 8, RG.d_model), seed=1)
    for seq, args in ((tr.rglru_seq, (tp,)),
                      (tr.mlstm_seq, (_mlstm_params()[1], XL.num_heads))):
        grads = []
        for impl in ("kernel", "plain"):
            xt = torch.from_numpy(x).requires_grad_()
            (seq(args[0], xt, *args[1:], impl=impl) * torch.from_numpy(w)).sum().backward()
            grads.append(xt.grad)
        _close(grads[0], grads[1])


# ------------------------------------------------------------- backward


def _jax_rglru_scan(log_a, b):
    """The reference's associative scan of ``rglru_seq``
    (``repro/models/recurrent.py:240-245``)."""
    def combine(left, right):
        al, bl = left
        ar, br = right
        return al + ar, bl * jnp.exp(ar) + br

    return jax.lax.associative_scan(combine, (log_a, b), axis=1)[1]


@pytest.mark.parametrize("B,S,C", [(2, 64, 32), (1, 300, 8)])
def test_rglru_scan_backward_matches_jax(B, S, C):
    """``ref.rglru_scan_bwd_ref`` (the backward kernel's plain version, the
    reverse loop) and the kernel wrapper's autograd on the CPU against
    ``jax.grad`` of the reference's associative scan."""
    rng = np.random.default_rng(S + C)
    log_a = -rng.uniform(0.001, 0.5, (B, S, C)).astype(np.float32)
    b, w = _x((B, S, C), seed=1), _x((B, S, C), seed=2)
    want = jax.jit(jax.grad(lambda la, bb: jnp.sum(_jax_rglru_scan(la, bb) * jnp.asarray(w)),
                            argnums=(0, 1)))(jnp.asarray(log_a), jnp.asarray(b))
    la_t, b_t = torch.from_numpy(log_a), torch.from_numpy(b)
    h = tr.rglru_scan_ref(la_t, b_t)
    got = kernels_ref.rglru_scan_bwd_ref(la_t, h, torch.from_numpy(w))
    for g, j in zip(got, want):
        _close(g, j)
    leaves = [t.clone().requires_grad_() for t in (la_t, b_t)]
    (kernels.rglru_scan(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, j in zip(leaves, want):
        _close(t.grad, j)


@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 128), (96, 32)])
def test_mlstm_chunk_backward_matches_jax(S, chunk):
    """Autograd through the plain chunk recurrence (the backward kernel's
    plain version, what the kernel wrapper runs on the CPU) against
    ``jax.grad`` of the reference's ``mlstm_chunk_recurrence``, for q, k, v
    and both gate pre-activations."""
    B, H, dk = 2, XL.num_heads, 16
    rng = np.random.default_rng(S + chunk)
    q, k, v = (rng.standard_normal((B, S, H, dk)).astype(np.float32) for _ in range(3))
    i_pre = rng.standard_normal((B, S, H)).astype(np.float32)
    f_pre = (rng.standard_normal((B, S, H)) + 3.0).astype(np.float32)
    w = _x((B, S, H, dk), seed=3)
    args = (q, k, v, i_pre, f_pre)
    want = jax.grad(lambda *a: jnp.sum(jr.mlstm_chunk_recurrence(*a, chunk=chunk)
                                       * jnp.asarray(w)),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (kernels.mlstm_chunk(*leaves, chunk=chunk) * torch.from_numpy(w)).sum().backward()
    for t, j in zip(leaves, want):
        _close(t.grad, j, 1e-4)


@pytest.mark.parametrize("S", [1, 24])
def test_slstm_vjp_matches_jax(S):
    """The port of the reference's hand-written sLSTM VJP (``_SlstmScan``)
    against ``jax.grad`` through the reference's ``_slstm_scan`` (its
    custom VJP), for the recurrent weights and the gates' input terms, and
    against autograd through the port's plain cell loop."""
    B, d, H = 2, XL.d_model, XL.num_heads
    rng = np.random.default_rng(S)
    R = (rng.standard_normal((4, H, d // H, d // H)) * 0.2).astype(np.float32)
    pre = rng.standard_normal((4, B, S, d)).astype(np.float32)
    w = _x((B, S, d), seed=4)
    want = jax.grad(lambda r, p: jnp.sum(jr._slstm_scan(r, p.transpose(0, 2, 1, 3), H)
                                         .transpose(1, 0, 2) * jnp.asarray(w)),
                    argnums=(0, 1))(jnp.asarray(R), jnp.asarray(pre))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (R, pre)]
    (tr._SlstmScan.apply(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, j in zip(leaves, want):
        _close(t.grad, j, 1e-4)
    loop = [torch.from_numpy(a).requires_grad_() for a in (R, pre)]
    state = tr.slstm_init_state(B, d)
    hs = []
    for t in range(S):
        state = tr._slstm_cell(loop[0], loop[1][:, :, t], state)
        hs.append(state["h"])
    (torch.stack(hs, dim=1) * torch.from_numpy(w)).sum().backward()
    for t, u in zip(leaves, loop):
        _close(t.grad, u.grad, 1e-4)


@pytest.mark.parametrize("block", ["rglru", "mlstm", "slstm"])
def test_recurrent_block_gradients_match_jax(block):
    """Each block's ``*_seq`` differentiated on the port's default kernel
    path (the plain versions behind the kernels' autograd functions on the
    CPU; sLSTM through its VJP) against ``jax.grad`` of the reference's:
    the input's gradient and every parameter's, to 1e-4 of each leaf's
    largest entry."""
    S = 64
    if block == "rglru":
        jp, tp = _params(jr.init_rglru, RG.d_model, RG.d_rnn, RG.conv_width)
        jfn = jr.rglru_seq
        tfn = tr.rglru_seq
        extra = ()
    elif block == "mlstm":
        jp, tp = _mlstm_params()
        jfn = functools.partial(jr.mlstm_seq, chunk=32)
        tfn = functools.partial(tr.mlstm_seq, chunk=32)
        extra = (XL.num_heads,)
    else:
        jp, tp = _params(jr.init_slstm, XL.d_model, XL.num_heads)
        jfn, tfn, extra = jr.slstm_seq, tr.slstm_seq, (XL.num_heads,)
    d = RG.d_model if block == "rglru" else XL.d_model
    x, w = _x((2, S, d), seed=5, scale=0.5), _x((2, S, d), seed=6)
    jgx, jgp = jax.jit(jax.grad(lambda xx, pp: jnp.sum(jfn(pp, xx, *extra) * jnp.asarray(w)),
                                argnums=(0, 1)))(jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_()
    for _path, leaf in _leaves(tp):
        leaf.requires_grad_(True)
    (tfn(tp, xt, *extra) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, jgx, 1e-4)
    jleaves = dict(_leaves(jgp))
    for path, leaf in _leaves(tp):
        _close(leaf.grad, jleaves[path], 1e-4)


# ------------------------------------------------- tensor-parallel ranks

# each rank's output, state and gradient blocks, gathered in rank order,
# against the whole layer's, of the largest entry: both run in f64, so only
# the order of the sums over ranks differs
SPLIT_TOL = 1e-6
_rank = threading.local()


class _Ranks:
    """n ranks of one model group emulated by n threads of this process:
    ``collectives``' transport (all-gather, all-to-all of equal and of
    uneven parts) exchanges through a barrier, so the layers run their own
    collectives, forward and backward."""

    group_desc = "model"  # the group's mesh axes, for the byte counts

    def __init__(self, n: int):
        self.n, self.barrier, self.slots = n, threading.Barrier(n), [None] * n

    def exchange(self, x):
        self.slots[_rank.index] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    # the transport, as collectives calls it
    def all_gather(self, out, x, group):
        out.copy_(torch.cat([o.reshape(-1) for o in group.exchange(x.clone())]))

    def all_to_all(self, send, group):
        return torch.stack([o[_rank.index] for o in group.exchange(send.contiguous())])

    def all_to_all_v(self, send, in_splits, out_splits, group):
        sent = group.exchange((send.clone(), list(in_splits)))
        return torch.cat([x.split(splits)[_rank.index] for x, splits in sent])

    def mesh(self, r: int):
        return SimpleNamespace(axis_names=("model",), shape={"model": self.n},
                               size=lambda axes: self.n if tuple(axes) == ("model",) else 1,
                               index=lambda axes: r if tuple(axes) == ("model",) else 0,
                               group=lambda axes: self if tuple(axes) == ("model",) else None)

    def run(self, fn) -> list:
        """``fn(rank, mesh)`` on every rank at once, each under its binding."""
        out, failed = [None] * self.n, []

        def work(r):
            _rank.index = r
            try:
                with ctx.use_rules(self.mesh(r), ctx.activation_rules(data_axes=())):
                    out[r] = fn(r, self.mesh(r))
            except BaseException as e:  # noqa: BLE001 - raised again below
                failed.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=work, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failed:
            raise failed[0]
        return out


def _compute_blocks(name: str, params: dict, mesh):
    """A layer's leaves as the mesh step computes on them: the rank's
    block where tensor-parallel compute keeps it, else whole; and each
    leaf's split dim (None: whole)."""
    plan = specs.map_specs(lambda names, s: s if specs.tensor_parallel(names) else (),
                           {name: params}, mesh, specs.mesh_rules(mesh))[name]

    def dim(s):
        return next((i for i, p in enumerate(s) if p is not None), None)

    return (_map_paths(lambda k, p: specs.local_block(p, _at(plan, k), mesh), params),
            _map_paths(lambda k, p: dim(_at(plan, k)), params))


def _map_paths(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _joined(blocks: list, whole: torch.Tensor, dim) -> torch.Tensor:
    """The ranks' blocks of ``whole`` joined in rank order along ``dim``, or
    (``dim`` None) the one value every rank holds, bit for bit."""
    if dim is None:
        assert all(torch.equal(b, blocks[0]) for b in blocks), "ranks differ"
        return blocks[0]
    return torch.cat(blocks, dim)


def _state_dim(block: torch.Tensor, whole: torch.Tensor):
    return next((i for i, (a, b) in enumerate(zip(block.shape, whole.shape)) if a != b), None)


SPLIT_LAYERS = {  # name -> (init, its args, the layer's key, heads)
    "rglru": (jr.init_rglru, (RG.d_model, RG.d_rnn, RG.conv_width), "rglru", 0),
    "mlstm": (jr.init_mlstm, (XL.d_model, XL.num_heads, XL.conv_width), "mlstm", XL.num_heads),
    # two heads: split over 2 ranks, whole on each of 4
    "mlstm_2_heads": (jr.init_mlstm, (XL.d_model, 2, XL.conv_width), "mlstm", 2),
    "slstm": (jr.init_slstm, (XL.d_model, XL.num_heads), "slstm", XL.num_heads),
}


def _split_layer(key: str, heads: int):
    """(seq(params, x, state?), step(params, x, state)) of a layer kind,
    plain and kernel paths alike on the CPU."""
    def seq(p, x, state=False):
        if key == "rglru":
            return tr.rglru_seq(p, x, return_state=state)
        if key == "mlstm":
            return tr.mlstm_seq(p, x, heads, chunk=16, return_state=state)
        return tr.slstm_seq(p, x, heads, return_state=state)

    def step(p, x, state):
        if key == "rglru":
            return tr.rglru_step(p, x, state)
        if key == "mlstm":
            return tr.mlstm_step(p, x, state, heads)
        return tr.slstm_step(p, x, state, heads)

    return seq, step


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("layer", list(SPLIT_LAYERS))
def test_model_parallel_ranks_give_the_whole_layer(layer, n, monkeypatch):
    """n ranks of a model group emulated in one process (``_Ranks``), each
    on its block of the reference's weights as the mesh step computes on
    them (``specs.tensor_parallel``): the RG-LRU over its channels, the
    mLSTM over its inner width (``w_up`` re-paired; its heads split where
    n divides them, else whole on every rank), the sLSTM's FFN over its
    width.  Each rank's output over 2 x 32 tokens, its gradients of a
    weighted sum of the outputs (a rank's blocks joined in rank order, a
    leaf it reads whole equal on every rank), its prefill state and a
    decode step's output and new state from it (the heads' or channels'
    blocks joined) equal the whole layer's within 1e-6 of the largest
    entry.  Both run in f64 (``test_torch_gpu._f64_plain``), so a sum
    taken twice, or missed, shows and rounding does not."""
    from test_torch_gpu import _f64_plain

    init, args, key, heads = SPLIT_LAYERS[layer]
    ranks = _Ranks(n)
    for name in ("all_gather", "all_to_all", "all_to_all_v"):
        monkeypatch.setattr(collectives, f"_{name}", getattr(ranks, name))
    params = map_params(lambda _k, p: p.double(), _params(init, *args)[1])
    x = torch.from_numpy(_x((2, 32, XL.d_model), 3)).double()
    x_step = torch.from_numpy(_x((2, XL.d_model), 4)).double()
    weight = torch.from_numpy(_x((2, 32, XL.d_model), 5)).double()
    seq, step = _split_layer(key, heads)

    def run(p):  # output, gradients, prefill state, step output and state
        p = map_params(lambda _k, t: t.clone().requires_grad_(True), p)
        out = seq(p, x)
        (out * weight).sum().backward()
        with torch.no_grad():
            _, state = seq(p, x, True)
            s_out, s_state = step(p, x_step, {k: v.clone() for k, v in state.items()})
        return out.detach(), map_params(lambda _k, t: t.grad, p), state, s_out, s_state

    with _f64_plain():
        want = run(params)
        got = ranks.run(lambda r, mesh: run(_compute_blocks(key, params, mesh)[0]))
    dims = _compute_blocks(key, params, ranks.mesh(0))[1]
    for r in got:
        _close(r[0], want[0], SPLIT_TOL)
        _close(r[3], want[3], SPLIT_TOL)
    for path, g in _leaves(want[1]):
        _close(_joined([_at(r[1], path) for r in got], g, _at(dims, path)), g, SPLIT_TOL)
    for i in (2, 4):  # the prefill's and the step's states
        for k, w in want[i].items():
            blocks = [r[i][k] for r in got]
            _close(_joined(blocks, w, _state_dim(blocks[0], w)), w, SPLIT_TOL)
    assert any(got[0][2][k].shape != w.shape for k, w in want[2].items())  # split states
