"""Paged-cache execution of the decoder LM: mixed prefill/decode ticks.

Ported from ``repro/serve/paged_model.py``.  ``init_paged_state`` gives
every global-attention layer a shared block pool ``(num_blocks,
block_size, KV, D)``; sequences address it through a per-slot block table,
so cache memory follows the tokens actually held.  Every other layer (a
local layer's ring buffer, a recurrent state) keeps per-slot state: it is
O(window) or O(1) per sequence and gains nothing from paging.

``make_paged_tick`` builds the engine's one step: ``C`` micro-steps in
which every active slot advances by its own number of tokens (``counts``).
Decoding slots advance one sampled token; prefilling slots consume up to a
whole prompt chunk, so chunked prefill runs interleaved with decode and the
serving path needs no full-sequence attention.  Each micro-step runs the
RMSNorm kernel at every norm site and the paged decode kernel in every
global-attention layer; the other layers run ``lm._decode_layer`` with the
step's ``advance`` mask, which keeps the state of rows that do not
advance (the reference's ``_mask_tree``).

Block 0 of every pool is scratch: rows that do not advance write there and
their outputs are ignored, so no per-slot control flow exists inside a
micro-step.  They still run every layer, and a retired row (a table of
scratch, length 0) attends to exactly scratch position (0, 0); an MoE
layer routes all rows of the micro-step together, so what such a row
reads can take capacity from a real token.  The value written there is
therefore defined as the reference's scatter leaves it: the last such row
in batch order wins.

The reference's state is immutable and donated to each jitted step; here
the pools are written in place.  The write of a token's K/V and the
kernel that attends over it run on one stream, in that order, so the
kernel sees the write.  The reference's
``lax.scan`` loops (over main groups and over micro-steps) are Python
loops; CUDA graphs come in a later slice.
"""

from __future__ import annotations

import torch

from ..kernels import paged_decode_attention
from ..models.layers import (
    apply_rope,
    decode_attention,
    matmul_f32,
    rmsnorm,
    rope_table,
)
from ..models.lm import (
    ModelOptions,
    _decode_layer,
    _init_layer_state,
    _mask_padded_vocab,
    check_supported,
    ffn_block,
    stack_plan,
)

ATTN_IMPLS = ("kernel", "gather")


def _is_paged(spec) -> bool:
    """Global-attention layers page through the block pool; everything
    else (local ring buffers, recurrences) keeps per-slot state."""
    return spec.kind == "attn"


def _init_entry(cfg, spec, max_active, num_blocks, block_size, dtype,
                device, groups=()):
    check_supported(spec)
    if not _is_paged(spec):  # a ring of cfg.window slots, as the reference's
        return _init_layer_state(cfg, spec, max_active, cfg.window or 1,
                                 dtype, device, groups)
    shape = (*groups, num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_state(cfg, max_active: int, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Same skeleton as the reference (prefix/main/tail/len), with every
    global-attention entry pool-shaped and the others per slot; main-group
    entries carry the group axis first.  ``len`` is per-slot tokens in
    context."""
    plan = stack_plan(cfg)
    pool = (max_active, num_blocks, block_size, dtype, device)
    return {
        "prefix": [_init_entry(cfg, s, *pool) for s in plan.prefix],
        "main": [_init_entry(cfg, s, *pool, groups=(plan.num_groups,))
                 for s in plan.pattern],
        "tail": [_init_entry(cfg, s, *pool) for s in plan.tail],
        "len": torch.zeros((max_active,), dtype=torch.int32, device=device),
    }


def all_attention(cfg) -> bool:
    """True when every layer is global attention: the precondition for
    prefix-cache reuse (recurrent or windowed state at a cut point cannot
    be rebuilt from shared KV blocks alone)."""
    plan = stack_plan(cfg)
    return all(_is_paged(s) for s in
               list(plan.prefix) + list(plan.pattern) + list(plan.tail))


def _paged_attn_layer(lparams, cfg, spec, pool, x, sin, cos, lengths, adv,
                      src, tables, opts, attn_impl):
    """One attention layer for one token per slot, against the block pool.
    Writes row ``src[b]``'s K/V for row b into ``pool`` in place (``src``
    is b itself where b advances) and returns the new x."""
    dt = x.dtype
    B = x.shape[0]
    h = rmsnorm(x, lparams["norm1"]["scale"], cfg.norm_eps)
    ap = lparams["attn"]
    # (B,d) @ (d,H*hd): the projections come out in the compute dtype, as
    # the reference's einsums without preferred_element_type do
    q = (h @ ap["wq"].flatten(1).to(dt)).view(B, cfg.num_heads, cfg.head_dim)
    k = (h @ ap["wk"].flatten(1).to(dt)).view(B, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ ap["wv"].flatten(1).to(dt)).view(B, cfg.num_kv_heads, cfg.head_dim)
    if "bq" in ap:
        q, k, v = (q + ap["bq"].to(dt), k + ap["bk"].to(dt),
                   v + ap["bv"].to(dt))
    if "q_norm" in ap:
        q = rmsnorm(q, ap["q_norm"]["scale"], cfg.norm_eps)
        k = rmsnorm(k, ap["k_norm"]["scale"], cfg.norm_eps)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    bs = pool["k"].shape[1]
    # rows that do not advance write the scratch block (0, 0).  Their
    # logical block lengths // bs may lie past the table's end, so the
    # index is masked before the gather (torch does not clamp as JAX does)
    row = torch.arange(B, device=x.device)
    blk = torch.where(adv, tables[row, torch.where(adv, lengths // bs, 0).long()], 0).long()
    off = torch.where(adv, lengths % bs, 0).long()
    pool["k"][blk, off] = k[src]
    pool["v"][blk, off] = v[src]

    if attn_impl == "kernel":
        out = paged_decode_attention(q, pool["k"], pool["v"], tables,
                                     lengths + 1)
    else:  # the plain gather path: each slot's pages as one dense cache
        KV, D = pool["k"].shape[2], pool["k"].shape[3]
        tab = tables.long()
        kc = pool["k"][tab].reshape(B, -1, KV, D)
        vc = pool["v"][tab].reshape(B, -1, KV, D)
        out = decode_attention(q, kc, vc, lengths + 1)
    x = x + out.reshape(B, -1) @ ap["wo"].flatten(0, 1).to(dt)
    # an MoE routes every row, advancing or not, as in the reference
    return ffn_block(lparams, cfg, spec, x, opts)[0]


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked main-group tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _paged_decode_step(params, cfg, state, tables, tokens, adv,
                       opts: ModelOptions, attn_impl: str):
    """One token for every advancing slot against the paged state, which
    is updated in place.  tokens/adv (B,); tables (B, T) int32.  Returns
    the (B, padded_vocab) f32 logits."""
    plan = stack_plan(cfg)
    dt = opts.dtype
    lengths = state["len"]
    x = params["embed"]["table"][tokens.long()].to(dt)
    if cfg.embed_scale:
        # the scale itself is rounded to the compute dtype (45.25 in bf16
        # for d_model 2048), as in the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    sin, cos = rope_table(lengths, cfg.head_dim, cfg.rope_theta)
    # the rows that do not advance all write scratch position (0, 0), each
    # the K/V of the last of them in batch order: the value the reference's
    # scatter leaves, so the repeated writes agree and none races another
    row = torch.arange(adv.shape[0], device=adv.device)
    src = torch.where(adv, row, torch.where(adv, -1, row).amax().clamp(min=0))

    def run(lp, spec, entry, x):
        if _is_paged(spec):
            return _paged_attn_layer(lp, cfg, spec, entry, x, sin, cos,
                                     lengths, adv, src, tables, opts, attn_impl)
        return _decode_layer(lp, cfg, spec, entry, x, sin, cos, lengths, adv,
                             opts)

    for lp, spec, pool in zip(params["prefix"], plan.prefix, state["prefix"]):
        x = run(lp, spec, pool, x)
    for g in range(plan.num_groups):
        for i, spec in enumerate(plan.pattern):
            x = run(_group(params["main"][i], g), spec,
                    _group(state["main"][i], g), x)
    for lp, spec, pool in zip(params["tail"], plan.tail, state["tail"]):
        x = run(lp, spec, pool, x)
    state["len"] = torch.where(adv, lengths + 1, lengths)

    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["head"]["w"])
    logits = matmul_f32(x, head.to(dt))
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return _mask_padded_vocab(logits, cfg)


def make_paged_tick(cfg, opts: ModelOptions = ModelOptions(), *,
                    attn_impl: str = "kernel"):
    """Build the engine's mixed tick.

    ``tick(params, state, tables, feed, counts, active)`` runs
    ``feed.shape[1]`` micro-steps; slot ``b`` advances through
    ``feed[b, :counts[b]]`` (a masked no-op afterwards) and the returned
    logits row is the one produced by its last advanced token: the
    sampling point for decode slots and the first-token logits for slots
    that just finished prefill.  ``attn_impl`` is ``"kernel"`` (the paged
    CUDA kernel) or ``"gather"`` (the plain path tests compare against).
    Returns ``(logits, state)``; the state is updated in place.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")

    def tick(params, state, tables, feed, counts, active):
        B, C = feed.shape
        last = torch.zeros((B, cfg.padded_vocab), dtype=torch.float32,
                           device=feed.device)
        for i in range(C):
            adv = active & (i < counts)
            logits = _paged_decode_step(params, cfg, state, tables,
                                        feed[:, i], adv, opts, attn_impl)
            sel = active & (counts - 1 == i)
            last = torch.where(sel[:, None], logits, last)
        return last, state

    return tick


def _entries(cfg, state, paged: bool):
    """``(entry, stacked)`` for every layer entry of ``state`` that is paged
    (or, with ``paged`` False, per slot); main-group entries are stacked,
    their group axis first."""
    plan = stack_plan(cfg)
    for seg, specs in (("prefix", plan.prefix), ("tail", plan.tail),
                       ("main", plan.pattern)):
        for spec, entry in zip(specs, state[seg]):
            if _is_paged(spec) == paged:
                yield entry, seg == "main"


def make_copy_block(cfg):
    """Pool-slab copy ``src -> dst`` across every paged layer, in place:
    the device half of copy-on-write (the allocator decides when)."""
    def copy(state, src: int, dst: int):
        for entry, stacked in _entries(cfg, state, paged=True):
            for pool in entry.values():
                if stacked:
                    pool[:, dst] = pool[:, src]
                else:
                    pool[dst] = pool[src]
        return state

    return copy


def make_reset_slot(cfg):
    """Per-slot reset for admission, in place: zero the slot's rows of every
    per-slot (non-paged) state leaf and seed its length with the number of
    prefix-cached tokens it adopts.  Paged pools need no reset: block
    contents past a sequence's length are masked by construction."""
    def reset(state, slot: int, n_tokens: int):
        for entry, stacked in _entries(cfg, state, paged=False):
            for t in entry.values():
                if stacked:
                    t[:, slot] = 0
                else:
                    t[slot] = 0
        state["len"][slot] = n_tokens
        return state

    return reset
