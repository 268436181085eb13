"""Decoder LM structure and parameters, ported from ``repro/models/lm.py``.

The layer stack is segmented as in the reference: an unrolled prefix, a
main body of repeating pattern groups whose parameters are stacked on a
leading group axis, and an unrolled tail.  The port keeps the same dict
keys, shapes and axis orders (``wq (d,H,hd)``, ``wo (H,hd,d)``), so the
reference's weights carry across unchanged (``repro_torch.convert``).

Entry points, for stacks of global-attention, local-attention, RG-LRU,
mLSTM and sLSTM layers with dense MLPs or MoE layers, and for the audio
and vision frontends' precomputed embeddings:

- ``init_params``        -- parameters drawn from a torch generator;
- ``forward``            -- full-sequence logits (+ the MoE aux loss),
                            optionally rematerialised per main group;
- ``loss_fn``            -- masked f32 cross-entropy over ``forward``;
- ``forward_with_cache`` -- prefill: ``forward`` that also builds the cache;
- ``init_cache``         -- an empty dense decode cache;
- ``decode_step``        -- one token per row against the cache.

Full-sequence attention runs the flash kernel (with a window for local
layers), decode the dense decode kernel, RG-LRU layers the ``rglru_scan``
kernel and mLSTM layers the ``mlstm_chunk`` kernel
(``ModelOptions.attn_impl``); MoE layers run ``models.moe``, whose
products are plain batched matmuls as in the reference.  The reference's
``lax.scan`` over the main groups is a loop over the stacked leading axis,
and the decode cache (K/V, ring buffers and recurrent states) is written
in place where the reference returns a new one.  The paged engine's tick
lives in ``repro_torch.serve.paged_model``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..convert import cast_params, map_params
from ..device import resolve_device
from ..sharding.collectives import (
    all_to_all,
    copy_to_model,
    gather_stack,
    ordered_max,
    ordered_sum,
    scatter_sum_over_model,
    split_over_model,
    sum_over_model,
)
from ..sharding.ctx import (
    cache_seq_split,
    loss_group,
    model_group,
    rebind,
    sequence_parallel,
    split_stream,
    stream_group,
)
from ..sharding.specs import kv_cache_split
from . import recurrent as rec
from .moe import IMPLS as MOE_IMPLS
from .moe import init_moe, moe_apply
from .layers import (
    ATTN_IMPLS,
    apply_rope,
    block_in,
    block_out,
    cached_decode_attention,
    causal_attention,
    dense_init,
    init_mlp,
    init_rmsnorm,
    matmul_f32,
    mlp_apply,
    rmsnorm,
    rope_table,
    seq_split_decode_attention,
    stream_leaf,
)


@dataclass(frozen=True)
class ModelOptions:
    """Implementation knobs that do not change semantics.  ``attn_impl``
    picks every kernel of the model path (flash attention, decode
    attention, ``rglru_scan``, ``mlstm_chunk``: ``"kernel"``) or their plain
    versions (``"plain"``, which tests and ``chip_smoke.py`` compare
    against).  ``mlstm_chunk`` is the mLSTM recurrence's chunk length, the
    reference's default.  ``moe_impl``, if given, overrides ``MoECfg.impl``
    (the MoE dispatch path: ``"einsum"`` or ``"sort"``).  ``tree_attention``
    makes the plain path of global attention the reference's
    ``tree_causal_attention`` in chunks of ``q_chunk`` (its default); the
    flash kernel, which already does only the causal work, runs as it is.
    The reference's other knobs (its XLA attention's key chunk, Pallas
    hooks) have no counterpart: the kernels take their place."""

    compute_dtype: str = "bfloat16"
    attn_impl: str = "kernel"
    mlstm_chunk: int = 128
    moe_impl: Optional[str] = None
    tree_attention: bool = False
    q_chunk: int = 512

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
        if self.moe_impl is not None and self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


# ----------------------------------------------------------- stack segmenting


@dataclass(frozen=True)
class LayerSpec:
    kind: str  # attn | local | rglru | mlstm | slstm
    use_moe: bool
    d_ff: int  # MLP width for this layer (0 = no MLP sub-block)


def layer_specs(cfg: ArchConfig) -> list:
    specs = []
    for i, kind in enumerate(cfg.layer_kinds):
        use_moe = cfg.moe is not None and i >= cfg.first_dense and kind in ("attn", "local")
        if use_moe:
            ff = 0
        elif cfg.moe is not None and i < cfg.first_dense:
            ff = cfg.first_dense_ff or cfg.d_ff
        elif kind in ("mlstm", "slstm"):
            ff = 0
        else:
            ff = cfg.d_ff
        specs.append(LayerSpec(kind, use_moe, ff))
    return specs


@dataclass(frozen=True)
class StackPlan:
    prefix: tuple  # tuple[LayerSpec]
    pattern: tuple  # tuple[LayerSpec], one period
    num_groups: int
    tail: tuple  # tuple[LayerSpec]


def stack_plan(cfg: ArchConfig) -> StackPlan:
    specs = layer_specs(cfg)
    p = len(cfg.block_pattern)
    prefix = tuple(specs[: cfg.first_dense])
    rest = specs[cfg.first_dense:]
    num_groups = len(rest) // p
    pattern = tuple(rest[:p]) if num_groups else ()
    for g in range(num_groups):
        if tuple(rest[g * p: (g + 1) * p]) != pattern:
            raise ValueError(f"{cfg.name}: layer stack is not periodic")
    tail = tuple(rest[num_groups * p:])
    return StackPlan(prefix, pattern, num_groups, tail)


LAYER_KINDS = ("attn", "local", "rglru", "mlstm", "slstm")


def check_supported(spec: LayerSpec) -> None:
    if spec.kind not in LAYER_KINDS:
        raise ValueError(f"unknown layer kind {spec.kind!r}")


# ------------------------------------------------------------------- params


def _init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, dev = cfg.d_model, gen.device
    hd, H, KV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    out_scale = 1.0 / max(cfg.num_layers, 1) ** 0.5
    attn = {
        "wq": dense_init(gen, (d, H, hd)),
        "wk": dense_init(gen, (d, KV, hd)),
        "wv": dense_init(gen, (d, KV, hd)),
        "wo": dense_init(gen, (H, hd, d), scale=out_scale),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((H, hd), device=dev)
        attn["bk"] = torch.zeros((KV, hd), device=dev)
        attn["bv"] = torch.zeros((KV, hd), device=dev)
    if cfg.qk_norm:
        attn["q_norm"] = init_rmsnorm(hd, dev)
        attn["k_norm"] = init_rmsnorm(hd, dev)
    return attn


def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> dict:
    check_supported(spec)
    d, dev = cfg.d_model, gen.device
    out_scale = 1.0 / max(cfg.num_layers, 1) ** 0.5
    p: dict = {"norm1": init_rmsnorm(d, dev)}
    if spec.kind in ("attn", "local"):
        p["attn"] = _init_attention(gen, cfg)
    elif spec.kind == "rglru":
        p["rglru"] = rec.init_rglru(gen, d, cfg.d_rnn or d, cfg.conv_width)
    elif spec.kind == "mlstm":
        p["mlstm"] = rec.init_mlstm(gen, d, cfg.num_heads, cfg.conv_width)
    else:
        p["slstm"] = rec.init_slstm(gen, d, cfg.num_heads)
    if spec.use_moe:
        p["norm2"] = init_rmsnorm(d, dev)
        p["moe"] = init_moe(gen, d, cfg.moe)
    elif spec.d_ff > 0:
        p["norm2"] = init_rmsnorm(d, dev)
        p["mlp"] = init_mlp(gen, d, spec.d_ff, cfg.gated_mlp, out_scale=out_scale)
    return p


def _put(stacked, layer, g: int) -> None:
    """Copy ``layer``'s leaves into group ``g`` of the stacked tree."""
    if isinstance(layer, dict):
        for k, v in layer.items():
            _put(stacked[k], v, g)
    else:
        stacked[g].copy_(layer)


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                dtype=None) -> dict:
    """Random f32 parameters drawn from ``seed`` on ``device`` (CUDA unless
    the caller asks for the CPU).  Same keys, shapes and scales as the
    reference's ``init_params``; the numbers differ, since torch's
    generator is not JAX's.

    ``dtype``, if given, casts as ``convert.cast_params`` does (norm scales
    and ``F32_LEAVES`` stay f32), each layer as soon as it is drawn: the
    result equals ``cast_params(init_params(cfg, seed, device), dtype)``
    without the whole f32 tree ever existing (deepseek-moe-16b: 30.5 GiB
    in bf16, where the f32 tree alone is 61.0)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = stack_plan(cfg)

    def cast(tree):
        return tree if dtype is None else cast_params(tree, dtype)

    params: dict = {
        "embed": cast({"table": dense_init(gen, (cfg.padded_vocab, cfg.d_model))
                       * cfg.d_model ** 0.5}),
        "final_norm": init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = cast({"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab))})
    if cfg.frontend:
        params["frontend"] = cast(
            {"w": dense_init(gen, (cfg.frontend_dim, cfg.d_model))})
    params["prefix"] = [cast(_init_layer(gen, cfg, s)) for s in plan.prefix]
    params["main"] = []
    for g in range(plan.num_groups):  # drawn group by group, in place
        group = [cast(_init_layer(gen, cfg, s)) for s in plan.pattern]
        if g == 0:
            params["main"] = [
                map_params(lambda _k, t: t.new_empty((plan.num_groups, *t.shape)),
                           layer) for layer in group]
        for stacked, layer in zip(params["main"], group):
            _put(stacked, layer, g)
    params["tail"] = [cast(_init_layer(gen, cfg, s)) for s in plan.tail]
    return params


def _mask_padded_vocab(logits: torch.Tensor, cfg: ArchConfig,
                       offset: int = 0) -> torch.Tensor:
    """Padded vocab columns are masked to -1e30: function-preserving padding.
    ``logits`` hold the columns from ``offset`` on (a rank's vocab block)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(offset, offset + logits.shape[-1],
                       device=logits.device) < cfg.vocab_size
    return torch.where(col, logits, torch.full((), -1e30, device=logits.device))


def _vocab_group(cfg: ArchConfig, local_vocab: int) -> tuple:
    """(group, n, the first column) of a vocab-parallel embedding or head
    whose leaf holds ``local_vocab`` of the padded vocabulary: (None, 1, 0)
    where it holds all of it."""
    group, n, idx = model_group()
    if group is None or local_vocab == cfg.padded_vocab:
        return None, 1, 0
    return group, n, idx * local_vocab


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked main-group tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _layers(tree, plan: StackPlan):
    """``(spec, where, entry)`` for every layer in stack order, where
    ``tree`` is the parameters or a cache (same skeleton): ``where`` is
    ``(segment, index)`` and main-group entries are views into the stacked
    leaves.  The reference's ``lax.scan`` over groups, as a loop."""
    for i, spec in enumerate(plan.prefix):
        yield spec, ("prefix", i), tree["prefix"][i]
    for g in range(plan.num_groups):
        for i, spec in enumerate(plan.pattern):
            yield spec, ("main", i), _group(tree["main"][i], g)
    for i, spec in enumerate(plan.tail):
        yield spec, ("tail", i), tree["tail"][i]


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, the (tied) head accumulated in f32, softcap, vocab mask.
    Under sequence parallelism the norm runs on this rank's positions, which
    are then gathered: the vocab split wins at the head, as in the
    reference."""
    x = rmsnorm(x, stream_leaf(params["final_norm"]["scale"]), cfg.norm_eps)
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["head"]["w"])
    # vocab-parallel: this rank's columns of the head
    group, n, offset = _vocab_group(cfg, head.shape[1])
    logits = matmul_f32(block_in(x, group, n), head.to(x.dtype))
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return _mask_padded_vocab(logits, cfg, offset)


# ------------------------------------------------------------------ forward


def _embed_tokens(params, cfg: ArchConfig, tokens, dtype,
                  scatter: bool = False) -> torch.Tensor:
    """The embedding rows of ``tokens`` (any shape) in ``dtype``, scaled
    where the config asks.  Vocab-parallel under a bound model group whose
    ranks hold vocab blocks of the table: each token's row comes from the
    one rank that holds it, summed over the group (adding zeros: exact);
    with ``scatter``, tokens (B,S) give this rank's block of the positions
    of that sum (sequence parallelism)."""
    # F.embedding, not indexing: on the CPU the backward of indexing adds
    # rows in an order that depends on threads, so two equal train steps
    # could part in the last bits
    table = params["embed"]["table"]
    group, n, offset = _vocab_group(cfg, table.shape[0])
    if group is None:
        x = F.embedding(tokens.long(), table)
    else:
        local = tokens.long() - offset
        own = (local >= 0) & (local < table.shape[0])
        x = F.embedding(torch.where(own, local, 0), table) * own[..., None]
        x = (scatter_sum_over_model(x, group, n, 1) if scatter
             else sum_over_model(x, group, n))
    x = x.to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=x.device)
    return x


def embed_inputs(params, cfg: ArchConfig, tokens, frontend_embeds,
                 dtype) -> torch.Tensor:
    """tokens (B,S) int -> (B,S,d) in ``dtype``.  The scale is rounded to
    ``dtype`` first (45.25 in bf16 for d_model 2048), as in the reference.
    A config with a frontend takes ``frontend_embeds`` (B,F,frontend_dim),
    projects them by ``frontend.w`` in ``dtype`` and puts them ahead of
    the (scaled) tokens: (B, F+S, d).  Other configs ignore them, as the
    reference does.

    Where the stream is split over the sequence (``stream_group``) the
    result is this rank's block of the positions: the vocab-parallel sum
    scattered over them where no frontend comes first, else the whole
    stream, which every rank computes alike, cut."""
    sg, sn, sidx = stream_group()
    vocab_split = _vocab_group(cfg, params["embed"]["table"].shape[0])[0] is not None
    if sg is not None and vocab_split and not cfg.frontend:
        return _embed_tokens(params, cfg, tokens, dtype, scatter=True)
    x = _embed_tokens(params, cfg, tokens, dtype)
    if cfg.frontend:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} takes frontend_embeds "
                             f"(B, {cfg.frontend_len}, {cfg.frontend_dim})")
        # the reference's einsum names no accumulation type: the output is
        # in the compute dtype
        fe = (frontend_embeds.to(device=x.device, dtype=dtype)
              @ params["frontend"]["w"].to(dtype))
        x = torch.cat([fe, x], dim=1)
    return split_over_model(x, sg, sn, sidx, 1)


def _attention_block(aparams, cfg: ArchConfig, x, sin, cos,
                     opts: ModelOptions, kind: str = "attn", whole_kv: bool = False):
    """Self-attention over the sequence (``kind`` "local": within the
    config's window).  x (B,S,d) in the compute dtype.  Returns the output
    projection and the compact (B,S,KV,hd) K/V for the cache.  q/k/v are
    accumulated in f32 and rounded to the compute dtype; the output
    projection comes out in the compute dtype, as in the reference.

    Tensor-parallel (a bound model group, and ``wq`` holding part of the
    heads): Q, K and V are column-parallel, the output projection
    row-parallel (f32 partials summed over the group in rank order, rounded
    once).  Where ``wk``/``wv`` hold every KV head, this rank reads the KV
    heads its query heads map to; the gradients of the leaves every rank
    reads whole (those K/V weights and biases, the qk-norm scales) are
    summed over the group.

    Under sequence parallelism x is this rank's positions: the block takes
    the whole sequence (``block_in``) and gives back its rank's positions
    of the output (``block_out``); the K/V returned cover every position."""
    dt = x.dtype
    H, KV, hd = aparams["wq"].shape[1], aparams["wk"].shape[1], cfg.head_dim
    group, n, idx = model_group()
    if H == cfg.num_heads:  # the heads are not split: the block runs whole
        group, n = None, 1
    ap = dict(aparams)
    sel = None  # the KV heads of this rank's queries, where wk holds every one
    x = block_in(x, group, n)
    B, S, _ = x.shape
    if group is not None:
        for name in ("q_norm", "k_norm"):
            if name in ap:
                ap[name] = {"scale": copy_to_model(ap[name]["scale"], group, n)}
        if KV == cfg.num_kv_heads:  # KV whole: the KV heads of this rank's queries
            heads = range(idx * H, (idx + 1) * H)
            sel = _kv_heads(heads, cfg.num_heads // cfg.num_kv_heads)
            for name in ("wk", "wv", "bk", "bv"):
                if name in ap:
                    leaf = copy_to_model(ap[name], group, n)
                    ap[name] = leaf if whole_kv else _pick(leaf, sel, 1 if name[0] == "w" else 0)
            if not whole_kv:
                KV = len(sel)
    q = matmul_f32(x, ap["wq"].flatten(1).to(dt)).to(dt).view(B, S, H, hd)
    k = matmul_f32(x, ap["wk"].flatten(1).to(dt)).to(dt).view(B, S, KV, hd)
    v = matmul_f32(x, ap["wv"].flatten(1).to(dt)).to(dt).view(B, S, KV, hd)
    if "bq" in ap:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    if "q_norm" in ap:
        q = rmsnorm(q, ap["q_norm"]["scale"], cfg.norm_eps)
        k = rmsnorm(k, ap["k_norm"]["scale"], cfg.norm_eps)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    # the kernel reads the compact K/V through h // G: no GQA repeat
    window = cfg.window if kind == "local" else 0
    ka, va = (_pick(k, sel, 2), _pick(v, sel, 2)) if whole_kv and sel is not None else (k, v)
    out = causal_attention(q, ka, va, opts.attn_impl, window,
                           opts.q_chunk if opts.tree_attention else 0).reshape(B, S, H * hd)
    wo = ap["wo"].flatten(0, 1).to(dt)
    if group is None:
        return block_out(out @ wo), (k, v)
    return block_out(matmul_f32(out, wo), group, n).to(dt), (k, v)


def _pick(x: torch.Tensor, sel, dim: int) -> torch.Tensor:
    """The entries ``sel`` (a range or a tensor of indices) of ``x`` along
    ``dim``."""
    if isinstance(sel, range):
        return x.narrow(dim, sel.start, len(sel))
    return x.index_select(dim, sel.to(x.device))


def _kv_heads(heads: range, G: int):
    """The KV heads that query ``heads`` read (head h reads h // G), as this
    rank's compact K/V: a range where the local heads read them in the
    kernel's h // (local G) order, else one KV head per query head (a
    tensor of indices)."""
    kv = [h // G for h in heads]
    lo, n_kv = kv[0], kv[-1] - kv[0] + 1
    g = len(kv) // n_kv
    if len(kv) % n_kv == 0 and kv == [lo + i // g for i in range(len(kv))]:
        return range(lo, lo + n_kv)
    return torch.tensor(kv)


def _pack_kv_cache(k, v, kind: str, cfg: ArchConfig, max_len: int) -> dict:
    """Full-sequence K/V (B,S,KV,hd) as the decode cache.  Global attention:
    zero-padded to (B, max_len, KV, hd).  Local attention: a ring buffer of
    ``min(window, max_len)`` slots, position p in slot p % w.  Under a bound
    model group whose cache splits over the sequence (``kv_cache_split``
    "seq"), this rank's block of the positions or slots, every KV head:
    rank r holds [r P / n, (r + 1) P / n) of the P the whole cache has.
    Where ``wk`` split the KV heads (``shard_cache_seq``), the rank's heads
    over every position become every head over its positions by one
    all-to-all (``_heads_to_positions``)."""
    B, S = k.shape[:2]
    group, n, idx = model_group()
    if kind == "local":
        w = min(cfg.window, max_len)
        m = min(S, w)
        slots = (torch.arange(S - m, S, device=k.device) % w).long()
        buf_k = k.new_zeros((B, w, *k.shape[2:]))
        buf_v = v.new_zeros((B, w, *v.shape[2:]))
        buf_k[:, slots] = k[:, S - m:]
        buf_v[:, slots] = v[:, S - m:]
        if group is not None and _seq_split(cfg, w, n):
            if k.shape[2] != cfg.num_kv_heads:
                return {"k": _heads_to_positions(buf_k, group, n),
                        "v": _heads_to_positions(buf_v, group, n)}
            size = w // n
            buf_k, buf_v = (b.narrow(1, idx * size, size).clone() for b in (buf_k, buf_v))
        return {"k": buf_k, "v": buf_v}
    pad = max_len - S
    if pad < 0:
        raise ValueError(f"max_len {max_len} is shorter than the sequence "
                         f"{k.shape[1]}")
    if group is not None and _seq_split(cfg, max_len, n):
        if k.shape[2] != cfg.num_kv_heads:
            return {name: _heads_to_positions(F.pad(t, (0, 0, 0, 0, 0, pad)), group, n)
                    for name, t in (("k", k), ("v", v))}
        size = max_len // n
        lo = min(idx * size, S)
        hi = min(lo + size, S)
        return {name: F.pad(t[:, lo:hi], (0, 0, 0, 0, 0, size - (hi - lo)))
                for name, t in (("k", k), ("v", v))}
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


def _seq_split(cfg: ArchConfig, positions: int, n: int) -> bool:
    """Whether a model group of n ranks splits an attention cache of
    ``positions`` over the sequence, as the reference's placement does under
    the bound rules (``sharding.specs.kv_cache_split``)."""
    return kv_cache_split(positions, cfg.num_kv_heads, n, cache_seq_split()) == "seq"


def _heads_to_positions(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, P, KV / n, hd), this rank's KV heads over every position ->
    (B, P / n, KV, hd), every KV head over this rank's block of the
    positions: block j of the positions goes to rank j (one all-to-all),
    and the ranks' heads are joined in rank order."""
    B, P, kv, hd = t.shape
    blocks = t.reshape(B, n, P // n, kv, hd).transpose(0, 1).contiguous()
    got = all_to_all(blocks, group, n, "all_to_all")  # block j: rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(B, P // n, n * kv, hd)


def _apply_layer_seq(lparams, cfg: ArchConfig, spec: LayerSpec, x, sin, cos,
                     opts: ModelOptions, want_state: bool = False,
                     max_len: int = 0):
    """One layer over a full sequence.  Returns (x, aux[, state])."""
    check_supported(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    impl = opts.attn_impl
    h = rmsnorm(x, stream_leaf(lparams["norm1"]["scale"]), cfg.norm_eps)
    if spec.kind in ("attn", "local"):
        mix, (k, v) = _attention_block(lparams["attn"], cfg, h, sin, cos, opts,
                                       spec.kind, whole_kv=want_state)
        state = _pack_kv_cache(k, v, spec.kind, cfg, max_len) if want_state else None
    else:
        if spec.kind == "rglru":
            out = rec.rglru_seq(lparams["rglru"], h, return_state=want_state,
                                impl=impl)
        elif spec.kind == "mlstm":
            out = rec.mlstm_seq(lparams["mlstm"], h, cfg.num_heads,
                                chunk=opts.mlstm_chunk, return_state=want_state,
                                impl=impl)
        else:
            out = rec.slstm_seq(lparams["slstm"], h, cfg.num_heads,
                                return_state=want_state)
        mix, state = out if want_state else (out, None)
    x, moe_aux = ffn_block(lparams, cfg, spec, x + mix, opts)
    if moe_aux is not None:
        aux = moe_aux
    if want_state:
        return x, aux, state
    return x, aux


def ffn_block(lparams, cfg: ArchConfig, spec: LayerSpec, x, opts: ModelOptions):
    """x plus the layer's second sub-block: RMSNorm, then the MoE or the
    dense MLP (none where ``d_ff`` is 0).  x is a sequence (B,S,d) or one
    token per row (B,d); an MoE routes one row's tokens, or all rows'
    tokens, together.  Returns (x, the MoE's aux loss or None).  Under a
    bound model group the dense MLP, and the MoE's routed and shared experts
    (``moe_apply`` reads the group itself), run on the leaves' local blocks
    where the partition splits them; under sequence parallelism x and the
    result are this rank's positions, and both take the whole sequence."""
    if spec.use_moe:
        h2 = rmsnorm(x, stream_leaf(lparams["norm2"]["scale"]), cfg.norm_eps)
        seq = x.dim() == 3
        m = cfg.moe if opts.moe_impl is None else replace(cfg.moe, impl=opts.moe_impl)
        out, aux = moe_apply(lparams["moe"], h2 if seq else h2[:, None], m, cfg.act)
        return x + (out if seq else out[:, 0]), aux
    if spec.d_ff > 0:
        h2 = rmsnorm(x, stream_leaf(lparams["norm2"]["scale"]), cfg.norm_eps)
        group, n, _ = model_group()
        if lparams["mlp"]["w_up"].shape[-1] == spec.d_ff:  # ff not split: whole
            group, n = None, 1
        x = x + mlp_apply(lparams["mlp"], h2, cfg.act, cfg.gated_mlp, group, n)
    return x, None


def _unstack(main: list, num_groups: int) -> list:
    """The main groups' parameters, one list of per-layer trees per group,
    as views of the stacked leaves.  One ``unbind`` per leaf: its backward
    stacks the groups' gradients once, where indexing each group would
    write every group's gradient into a zeroed copy of the whole leaf."""
    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            return [{k: p[g] for k, p in parts.items()} for g in range(num_groups)]
        return tree.unbind(0)
    per_layer = [unbind(tree) for tree in main]
    return [[layer[g] for layer in per_layer] for g in range(num_groups)]


def _run_seq(params, cfg: ArchConfig, tokens, frontend_embeds,
             opts: ModelOptions, want_state: bool, max_len: int,
             remat: bool = False):
    plan = stack_plan(cfg)
    S = tokens.shape[1]
    if cfg.frontend and frontend_embeds is not None:
        S += frontend_embeds.shape[1]
    # sequence parallelism: between blocks the stream holds this rank's
    # block of the positions (``sharding.ctx.split_stream``)
    with split_stream(sequence_parallel(S)):
        x = embed_inputs(params, cfg, tokens, frontend_embeds, opts.dtype)
        positions = torch.arange(S, device=x.device)[None, :]
        sin, cos = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        states = {"prefix": [], "main": [[] for _ in plan.pattern], "tail": []}

        def run(layers, specs, seg, x, aux_total):
            for i, (spec, lp) in enumerate(zip(specs, layers)):
                out = _apply_layer_seq(lp, cfg, spec, x, sin, cos, opts,
                                       want_state=want_state, max_len=max_len)
                x, aux_total = out[0], aux_total + out[1]
                if want_state:
                    (states[seg][i] if seg == "main" else states[seg]).append(out[2])
            return x, aux_total

        x, aux_total = run(params["prefix"], plan.prefix, "prefix", x, aux_total)
        for group in _unstack(params["main"], plan.num_groups):
            if remat:  # the reference's jax.checkpoint around its scan body; the
                # recompute runs under this binding (``rebind``), where a split
                # stream's gathers must run again
                x, aux_total = checkpoint(rebind(run), group, plan.pattern, "main", x,
                                          aux_total, use_reentrant=False)
            else:
                x, aux_total = run(group, plan.pattern, "main", x, aux_total)
        x, aux_total = run(params["tail"], plan.tail, "tail", x, aux_total)
        return _logits(params, cfg, x), aux_total, states


def forward(params, cfg: ArchConfig, tokens, frontend_embeds=None,
            opts: ModelOptions = ModelOptions(), remat: bool = False):
    """Full-sequence forward.  tokens (B,S) -> (logits (B,S+F,V) f32, aux),
    with F the frontend's positions (0 without one) and ``aux`` the MoE
    layers' load-balance losses summed in f32 (0 without MoE).

    ``remat`` recomputes each main group's activations in backward instead
    of keeping them (``torch.utils.checkpoint``): the same numbers, less
    memory.  The reference's save-the-dots policy, a memory trade of XLA's,
    is not copied."""
    logits, aux, _ = _run_seq(params, cfg, tokens, frontend_embeds, opts,
                              want_state=False, max_len=0, remat=remat)
    return logits, aux


def forward_with_cache(params, cfg: ArchConfig, tokens, frontend_embeds=None,
                       max_len: int = 0, opts: ModelOptions = ModelOptions()):
    """Prefill: full-sequence forward that also builds the decode cache.

    Returns (logits (B,S,V) f32, cache) with global-attention caches padded
    to ``max(max_len, S)`` positions, local ones as ring buffers, recurrent
    layers' final states, and ``cache['len']`` set to S (a frontend's
    positions included).  Under a bound model group the logits are this
    rank's vocab block (where the head splits the vocabulary) and the cache
    this rank's, placed as ``sharding.specs.cache_specs`` places it (the
    recurrent states' heads or channels split too), with
    ``cache["max_len"]`` the whole cache's positions, as
    ``sharding.specs.local_cache`` gives it."""
    B, S = tokens.shape
    if cfg.frontend and frontend_embeds is not None:
        S += frontend_embeds.shape[1]
    max_len = max(max_len, S)
    logits, _, states = _run_seq(params, cfg, tokens, frontend_embeds, opts,
                                 want_state=True, max_len=max_len)
    cache = {
        "prefix": states["prefix"],
        "main": [{key: torch.stack([st[key] for st in per_group])
                  for key in per_group[0]} for per_group in states["main"]],
        "tail": states["tail"],
        "len": torch.full((B,), S, dtype=torch.int32, device=logits.device),
    }
    if model_group()[0] is not None:
        cache["max_len"] = max_len
    return logits, cache


# -------------------------------------------------------------------- decode


def _init_layer_state(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      max_len: int, dtype, device, groups=()) -> dict:
    """One layer's empty decode state: K/V of ``max_len`` positions (global
    attention), a ring buffer of ``min(window, max_len)`` (local), or the
    recurrent state (f32, with the conv tail in ``dtype``)."""
    check_supported(spec)
    if spec.kind in ("attn", "local"):
        n = min(cfg.window, max_len) if spec.kind == "local" else max_len
        shape = (*groups, batch, n, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if spec.kind == "rglru":
        return rec.rglru_init_state(batch, cfg.d_rnn or cfg.d_model,
                                    cfg.conv_width, dtype, device, groups)
    if spec.kind == "mlstm":
        return rec.mlstm_init_state(batch, cfg.d_model, cfg.num_heads,
                                    cfg.conv_width, dtype, device, groups)
    return rec.slstm_init_state(batch, cfg.d_model, device, groups)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """An empty decode cache on ``device`` (CUDA unless the caller asks for
    the CPU): per global-attention layer, K and V of shape (batch, max_len,
    KV, hd); per local layer a ring buffer of ``min(window, max_len)``
    slots; per recurrent layer its initial state; the group axis first for
    main-group layers, and ``len`` (batch,) int32."""
    dev = resolve_device(device)
    plan = stack_plan(cfg)
    layer = (batch, max_len, dtype, dev)
    return {
        "prefix": [_init_layer_state(cfg, s, *layer) for s in plan.prefix],
        "main": [_init_layer_state(cfg, s, *layer, groups=(plan.num_groups,))
                 for s in plan.pattern],
        "tail": [_init_layer_state(cfg, s, *layer) for s in plan.tail],
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _keep_rows(new: torch.Tensor, old: torch.Tensor, advance) -> torch.Tensor:
    """``new`` on the rows where ``advance`` is True, ``old`` elsewhere (the
    batch axis leads)."""
    if advance is None:
        return new
    return torch.where(advance.view(-1, *(1,) * (new.dim() - 1)), new, old)


def _decode_layer(lparams, cfg: ArchConfig, spec: LayerSpec, state, x, sin,
                  cos, lengths, advance, opts: ModelOptions, positions=None):
    """One layer, one token per row.  x (B,d).  Updates ``state`` in place
    (rows where ``advance`` is False keep every leaf bit for bit) and
    returns the new x.  Every row computes as if it advanced, as the
    reference's batched step does before ``_merge_slot``: an MoE layer
    routes all rows together, so the rows that stay take capacity too."""
    check_supported(spec)
    h = rmsnorm(x, lparams["norm1"]["scale"], cfg.norm_eps)
    if spec.kind in ("attn", "local"):
        mix = _decode_attention(lparams["attn"], cfg, spec.kind, state, h, sin,
                                cos, lengths, advance, opts, positions)
    else:
        if spec.kind == "rglru":
            mix, new = rec.rglru_step(lparams["rglru"], h, state)
        elif spec.kind == "mlstm":
            mix, new = rec.mlstm_step(lparams["mlstm"], h, state, cfg.num_heads)
        else:
            mix, new = rec.slstm_step(lparams["slstm"], h, state, cfg.num_heads)
        for key, t in new.items():  # the reference's _merge_slot / _mask_tree
            state[key].copy_(_keep_rows(t, state[key], advance))
    return ffn_block(lparams, cfg, spec, x + mix, opts)[0]


def _decode_attention(ap, cfg: ArchConfig, kind: str, state, h, sin, cos,
                      lengths, advance, opts: ModelOptions, positions=None):
    """The attention mix of one decode token per row: writes its K/V into
    ``state`` in place and attends over the cache (global) or the ring
    buffer (local).

    Under a bound model group, this rank's query heads where ``wq`` holds
    part of them (column-parallel, the output projection row-parallel and
    summed over the group in rank order), and its block of the cache as
    ``sharding.specs.cache_specs`` places it, read off its shape against
    the whole cache's positions (``positions``, ``cache["max_len"]``): KV
    heads split, each rank attends its heads over its own; positions
    split, only the rank that holds the new token's slot writes it, and the
    ranks' partial outputs are merged (``layers.seq_split_decode_attention``);
    a whole cache, each rank attends its heads over the KV heads they
    read.  Where the cache holds every KV head over this rank's positions
    while ``wk`` splits them (``shard_cache_seq``), the ranks' new K/V are
    gathered first, so that the rank holding the slot writes every head."""
    dt = h.dtype
    B = h.shape[0]
    H, KV, hd = ap["wq"].shape[1], ap["wk"].shape[1], cfg.head_dim
    group, n, idx = model_group()
    heads_split = group is not None and H != cfg.num_heads
    split = "whole"
    Smax = state["k"].shape[1]
    cache_kv = state["k"].shape[2]
    if group is not None:
        if cache_kv != KV and (cache_kv != cfg.num_kv_heads or KV * n != cache_kv):
            raise ValueError(f"the cache holds {cache_kv} KV heads and wk {KV}")
        S = Smax
        if positions is not None:
            S = min(cfg.window, positions) if kind == "local" else positions
        if S not in (Smax, Smax * n):
            raise ValueError(f"a cache of {S} positions, of which this rank holds {Smax} "
                             f"over {n} ranks")
        split = "kv" if cache_kv != cfg.num_kv_heads else "seq" if S != Smax else "whole"
    # the reference's einsums name no accumulation type here: the
    # projections come out in the compute dtype
    q = (h @ ap["wq"].flatten(1).to(dt)).view(B, H, hd)
    k = (h @ ap["wk"].flatten(1).to(dt)).view(B, KV, hd)
    v = (h @ ap["wv"].flatten(1).to(dt)).view(B, KV, hd)
    if "bq" in ap:
        q, k, v = (q + ap["bq"].to(dt), k + ap["bk"].to(dt),
                   v + ap["bv"].to(dt))
    if "q_norm" in ap:
        q = rmsnorm(q, ap["q_norm"]["scale"], cfg.norm_eps)
        k = rmsnorm(k, ap["k_norm"]["scale"], cfg.norm_eps)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if cache_kv != KV:  # (n, B, KV / n, hd) -> (B, KV, hd): every rank's heads
        k, v = (gather_stack(t, group, n).transpose(0, 1).reshape(B, cache_kv, hd)
                for t in (k, v))
    # local: the ring buffer's slot; global: a row past the end writes the
    # last slot (the reference clamps too)
    S = Smax * n if split == "seq" else Smax
    slot = (lengths % S if kind == "local"
            else torch.clamp(lengths, max=S - 1)).long()
    own = None
    if split == "seq":  # the slot lies in one rank's block: only it writes
        own = slot // Smax == idx
        slot = torch.clamp(slot - idx * Smax, 0, Smax - 1)
    rows = torch.arange(B, device=h.device)
    if advance is not None or own is not None:
        old = (state["k"][rows, slot], state["v"][rows, slot])
    # every row attends over its new K/V, as in the reference's batched
    # step; then the rows that stay get their old K/V back (_merge_slot)
    if own is None:
        state["k"][rows, slot] = k
        state["v"][rows, slot] = v
    else:
        state["k"][rows, slot] = torch.where(own[:, None, None], k, old[0])
        state["v"][rows, slot] = torch.where(own[:, None, None], v, old[1])
    window = cfg.window if kind == "local" else 0
    if split == "seq":
        out = seq_split_decode_attention(q, state["k"], state["v"], lengths + 1, S, group,
                                         n, idx, opts.attn_impl, heads_split)
    elif split == "whole" and heads_split:  # the KV heads this rank's queries read
        sel = _kv_heads(range(idx * H, (idx + 1) * H), cfg.num_heads // cfg.num_kv_heads)
        out = cached_decode_attention(q, _pick(state["k"], sel, 2).contiguous(),
                                      _pick(state["v"], sel, 2).contiguous(), lengths + 1,
                                      opts.attn_impl, window)
    else:
        out = cached_decode_attention(q, state["k"], state["v"], lengths + 1,
                                      opts.attn_impl, window)
    if advance is not None:
        go = advance[:, None, None] if own is None else (advance & own)[:, None, None]
        state["k"][rows, slot] = torch.where(go, k, old[0])
        state["v"][rows, slot] = torch.where(go, v, old[1])
    wo = ap["wo"].flatten(0, 1).to(dt)
    if not heads_split:
        return out.reshape(B, H * hd) @ wo
    return sum_over_model(matmul_f32(out.reshape(B, H * hd), wo), group, n).to(dt)


def decode_step(params, cfg: ArchConfig, cache, tokens,
                opts: ModelOptions = ModelOptions(), advance=None):
    """One serving step: tokens (B,) -> (logits (B,V) f32, cache).

    ``cache['len']`` (B,) is the number of tokens already in context.  The
    cache is updated in place and returned.  ``advance`` (B,) bool, if
    given, limits the step to those rows: the others keep their K/V and
    their length bit for bit (their logits are computed and meaningless).
    That is the reference's batched step followed by ``_merge_slot``,
    without a second copy of the cache; recurrent states are merged row by
    row the same way.

    Under a bound model group (``make_decode_step`` with a mesh) the
    parameters and the cache are this rank's (``_decode_attention``), the
    embedding lookup and the logits vocab-parallel: the logits are this
    rank's vocab block where the head splits the vocabulary."""
    plan = stack_plan(cfg)
    dt = opts.dtype
    lengths = cache["len"]
    x = _embed_tokens(params, cfg, tokens, dt)
    sin, cos = rope_table(lengths, cfg.head_dim, cfg.rope_theta)
    for (spec, _, lp), (_, _, state) in zip(_layers(params, plan),
                                            _layers(cache, plan)):
        x = _decode_layer(lp, cfg, spec, state, x, sin, cos, lengths, advance,
                          opts, cache.get("max_len"))
    cache["len"] = (lengths + 1 if advance is None
                    else torch.where(advance, lengths + 1, lengths))
    return _logits(params, cfg, x), cache


# --------------------------------------------------------------------- loss


class _VocabParallelNLL(torch.autograd.Function):
    """The summed f32 cross-entropy of rows whose vocab columns are split
    over a model group: logits (T, V_local) from column ``offset`` on,
    labels (T,) (negative: masked, no loss and no gradient).  The row max
    and the sum of exponentials are taken over the group in rank order, and
    the label's logit comes from the one rank that holds it; every rank
    returns the same bits.  Backward: softmax minus one-hot on the local
    columns."""

    @staticmethod
    def forward(ctx, logits, labels, group, n, offset):
        V = logits.shape[1]
        m = ordered_max(logits.amax(dim=1), group, n)
        s = ordered_sum(torch.exp(logits - m[:, None]).sum(dim=1), group, n)
        local = labels - offset
        own = (local >= 0) & (local < V)
        local = torch.where(own, local, 0)
        picked = torch.where(own, logits.gather(1, local[:, None])[:, 0], 0.0)
        picked = ordered_sum(picked, group, n)
        mask = labels >= 0
        nll = torch.where(mask, torch.log(s) + m - picked, 0.0).sum()
        ctx.save_for_backward(logits, m, s, local, own & mask, mask)
        return nll

    @staticmethod
    def backward(ctx, grad):
        logits, m, s, local, hit, mask = ctx.saved_tensors
        p = torch.exp(logits - m[:, None]) / s[:, None]
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, local] -= hit.to(p.dtype)
        return p * (mask[:, None] * grad), None, None, None, None


def loss_fn(params, cfg: ArchConfig, batch: dict,
            opts: ModelOptions = ModelOptions(), remat: bool = True):
    """batch: tokens (B,S), labels (B,S) with negative labels masked.
    Returns (loss, metrics): the mean f32 cross-entropy over unmasked
    tokens (over at least one) plus the MoE aux loss times its weight, and
    ``ce_loss``, ``aux_loss``, ``tokens``.  A frontend's prefix positions
    carry no labels: their logits are cut off first.  Under a mesh binding
    (``sharding.ctx.use_rules``) ``batch`` is this rank's rows of the
    bound loss's, ``tokens`` the global count and the loss this rank's
    share: the ranks' mean is the global batch's loss."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("frontend_embeds"), opts, remat=remat)
    if cfg.frontend:
        logits = logits[:, cfg.frontend_len:]
    labels = batch["labels"].long()
    mask = labels >= 0
    group, n, offset = _vocab_group(cfg, logits.shape[-1])
    if group is None:
        # log-softmax and the label's entry in one call, summed over
        # unmasked tokens (the ignored ones give exactly 0 and no gradient)
        nll = F.cross_entropy(logits.flatten(0, 1),
                              labels.masked_fill(~mask, -100).flatten(),
                              ignore_index=-100, reduction="sum")
    else:
        nll = _VocabParallelNLL.apply(logits.flatten(0, 1), labels.flatten(),
                                      group, n, offset)
    count = mask.sum().float()
    group, n = loss_group()
    if group is None:
        loss = nll / torch.clamp(count, min=1.0)
    else:
        # the global batch's mean over n ranks' rows: the count is the
        # global one, and each rank's share is scaled so that the ranks'
        # mean is the global loss (right however the labels are masked)
        count = ordered_sum(count, group, n)
        loss = nll / (torch.clamp(count, min=1.0) / n)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return loss + aux_w * aux, {"ce_loss": loss, "aux_loss": aux,
                                "tokens": count}
