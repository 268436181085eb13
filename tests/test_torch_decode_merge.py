"""The decode kernel's log-sum-exp output and the rank-ordered merge of
partial decode outputs, on the CPU.

A cache whose positions a model group splits (``sharding.specs.
cache_specs``: flash-decode, split-K over the cache sequence) is attended
slice by slice, each rank with its local lengths, and the partials merged
by their log-sum-exps (``kernels.merge_partials``).  Here the slices are
cut out of one cache in one process: the merge of n slices must give
``decode_attention_ref`` over the whole cache and the JAX package's
Pallas decode kernel in interpret mode, within ``LOGITS_TOL`` (the
tolerance of ``tests/test_torch_models.py``), slices with no valid
position and a wrapped ring buffer included.  ``test_torch_gpu.py`` holds
the kernels to these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro_torch import kernels as tk
from repro_torch.kernels.ref import NEG_INF, decode_attention_ref, merge_partials_ref

LOGITS_TOL = 1e-4  # tests/test_torch_models.py: relative to the largest entry


def _inputs(B, H, KV, D, S, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D))]


def _np_lse(q, k, v, lens):
    """Each row's log-sum-exp of its scaled scores over the valid positions,
    in f64 numpy; -1e30 for a row with none."""
    B, H, D = q.shape
    G = H // k.shape[2]
    kf = np.repeat(k.astype(np.float64), G, axis=2)
    s = np.einsum("bhd,bkhd->bhk", q.astype(np.float64), kf) / np.sqrt(D)
    out = np.full((B, H), NEG_INF)
    for b in range(B):
        n = min(int(lens[b]), k.shape[1])
        if n:
            m = s[b, :, :n].max(-1, keepdims=True)
            out[b] = (m + np.log(np.exp(s[b, :, :n] - m).sum(-1, keepdims=True)))[:, 0]
    return out


@pytest.mark.parametrize("B,H,KV,D,S", [(4, 8, 2, 32, 48), (3, 6, 1, 64, 40)])
def test_lse_equals_numpy_logsumexp(B, H, KV, D, S):
    """The plain version's and the wrapper's (on CPU tensors) log-sum-exp,
    lengths 0, ragged and past the cache: a numpy log-sum-exp, -1e30 for
    an empty row; the output unchanged by asking for it."""
    q, k, v = _inputs(B, H, KV, D, S, seed=B + H)
    lens = np.asarray([0, S + 5, 7, 1][:B], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out, lse = decode_attention_ref(*args, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    want = _np_lse(q, k, v, lens)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    assert (lse[0] == NEG_INF).all() and (out[0] == 0).all()
    assert torch.equal(out, decode_attention_ref(*args))
    got, got_lse = tk.decode_attention(*args, return_lse=True)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)


def _slices(k, v, lens, n):
    """The cache cut into n equal position blocks, with each block's local
    lengths ``clamp(len - r S / n, 0, S / n)`` (as a rank of a model group
    that splits the sequence holds it)."""
    S = k.shape[1]
    size = S // n
    return [(k[:, r * size:(r + 1) * size], v[:, r * size:(r + 1) * size],
             torch.clamp(torch.clamp(lens, max=S) - r * size, 0, size)) for r in range(n)]


def _merged(q, k, v, lens, n, merge):
    parts = [decode_attention_ref(q, ks, vs, ls, return_lse=True)
             for ks, vs, ls in _slices(k, v, lens, n)]
    return merge(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))


CASES = {
    # GQA, ragged lengths: every slice holds positions of some row, and the
    # last slices none of the short rows' (empty slices weigh 0)
    "gqa": ((4, 8, 2, 32, 64), [64, 37, 16, 3], 4),
    # MQA at 2 ranks, one row of length 0 (every slice empty: output 0)
    "mqa_empty_row": ((3, 6, 1, 64, 40), [0, 21, 40], 2),
    # a ring buffer of 16 slots after wrap (lengths past it: every slot
    # valid), as recurrentgemma's local layers hold it, over 4 ranks
    "wrapped_ring": ((2, 4, 1, 32, 16), [29, 17], 4),
    # rows that reach only the first slice: three empty slices of four
    "short_prompts": ((2, 4, 4, 32, 32), [5, 8], 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_merge_of_slices_equals_the_whole_cache(case):
    """``merge_partials`` (the wrapper on CPU tensors) and its plain version
    over n slices equal ``decode_attention_ref`` on the whole cache and the
    Pallas kernel in interpret mode within LOGITS_TOL of the largest entry,
    with no NaN where a slice or a whole row is empty; the wrapper and the
    plain merge give the same bits."""
    (B, H, KV, D, S), lens, n = CASES[case]
    q, k, v = _inputs(B, H, KV, D, S, seed=len(case))
    lt = torch.tensor(lens, dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = _merged(qt, kt, vt, lt, n, tk.merge_partials)
    plain = _merged(qt, kt, vt, lt, n, merge_partials_ref)
    assert torch.equal(got, plain) and torch.isfinite(got).all()
    whole = decode_attention_ref(qt, kt, vt, lt)
    pallas = np.asarray(jk.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(np.asarray(lens, np.int32)),
                                            block_k=8, interpret=True))
    for want in (whole.numpy(), pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGITS_TOL * max(np.abs(want).max(), 1.0))
    empty = [b for b, n_b in enumerate(lens) if n_b == 0]
    assert all((got[b] == 0).all() for b in empty)


def test_merge_weighs_ranks_by_their_lse():
    """Two ranks whose log-sum-exps differ by log 3 weigh 3 : 1; an empty
    rank (-1e30) weighs nothing, whatever its output holds; bf16 partials
    merge in f32 and round once."""
    o = torch.stack([torch.full((1, 1, 4), 1.0), torch.full((1, 1, 4), 5.0),
                     torch.full((1, 1, 4), 1e6)])
    lse = torch.tensor([[[np.log(3.0)]], [[0.0]], [[NEG_INF]]], dtype=torch.float32)
    got = tk.merge_partials(o, lse)
    torch.testing.assert_close(got, torch.full((1, 1, 4), 2.0))
    got16 = tk.merge_partials(o.to(torch.bfloat16), lse)
    assert got16.dtype == torch.bfloat16 and (got16.float() == 2.0).all()
    assert (tk.merge_partials(o, torch.full_like(lse, NEG_INF)) == 0).all()


def test_merge_cost_and_lse_bytes():
    """The merge's counted work: a multiply and an add an element of each
    partial, the partials and their f32 lse read, the merge written; the
    decode kernel's lse adds its (B, H) f32 write."""
    cost = tk.merge_partials.cost(4, 2, 8, 32, torch.float32)
    assert cost.flops == 2 * 4 * 2 * 8 * 32
    assert cost.bytes == 4 * 2 * 8 * (32 * 4 + 4) + 2 * 8 * 32 * 4
    base = tk.decode_attention.cost(2, 8, 2, 32, 64, torch.bfloat16)
    with_lse = tk.decode_attention.cost(2, 8, 2, 32, 64, torch.bfloat16, lse=True)
    assert with_lse.flops == base.flops and with_lse.bytes == base.bytes + 4 * 2 * 8
