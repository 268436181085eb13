"""Decoder LM structure and parameters, ported from ``repro/models/lm.py``.

The layer stack is segmented as in the reference: an unrolled prefix, a
main body of repeating pattern groups whose parameters are stacked on a
leading group axis, and an unrolled tail.  The port keeps the same dict
keys, shapes and axis orders (``wq (d,H,hd)``, ``wo (H,hd,d)``), so the
reference's weights carry across unchanged (``repro_torch.convert``).

This slice serves attention-only stacks through the paged engine
(``repro_torch.serve.paged_model``).  ``forward``, ``forward_with_cache``
and ``decode_step`` come with the fixed-slot engine in the next slice;
recurrent layers and MoE come in their own slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import dense_init, init_mlp, init_rmsnorm


@dataclass(frozen=True)
class ModelOptions:
    """Implementation knobs that do not change semantics.  The reference's
    other knobs (attention chunking, MoE dispatch, Pallas hooks) come with
    the code paths that read them."""

    compute_dtype: str = "bfloat16"

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


def check_supported(spec: LayerSpec) -> None:
    """This slice ports global-attention layers with a dense MLP."""
    if spec.kind != "attn":
        raise NotImplementedError(
            f"layers of kind {spec.kind!r} come with the recurrent and "
            "local-attention slice of the port")
    if spec.use_moe:
        raise NotImplementedError("MoE layers come with the MoE slice of the port")


# ------------------------------------------------------------------- params


def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec) -> dict:
    check_supported(spec)
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
    p: dict = {"norm1": init_rmsnorm(d, dev), "attn": attn}
    if spec.d_ff > 0:
        p["norm2"] = init_rmsnorm(d, dev)
        p["mlp"] = init_mlp(gen, d, spec.d_ff, cfg.gated_mlp, out_scale=out_scale)
    return p


def _stack(trees: list):
    """Stack same-structured dicts leaf by leaf on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random f32 parameters drawn from ``seed`` on ``device`` (CUDA unless
    the caller asks for the CPU).  Same keys, shapes and scales as the
    reference's ``init_params``; the numbers differ, since torch's
    generator is not JAX's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = stack_plan(cfg)
    params: dict = {
        "embed": {"table": dense_init(gen, (cfg.padded_vocab, cfg.d_model))
                  * cfg.d_model ** 0.5},
        "final_norm": init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab))}
    if cfg.frontend:
        params["frontend"] = {"w": dense_init(gen, (cfg.frontend_dim, cfg.d_model))}
    params["prefix"] = [_init_layer(gen, cfg, s) for s in plan.prefix]
    params["main"] = []
    if plan.num_groups:
        groups = [[_init_layer(gen, cfg, s) for s in plan.pattern]
                  for _ in range(plan.num_groups)]
        params["main"] = [_stack([g[i] for g in groups])
                          for i in range(len(plan.pattern))]
    params["tail"] = [_init_layer(gen, cfg, s) for s in plan.tail]
    return params


def _mask_padded_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Padded vocab columns are masked to -1e30: function-preserving padding."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(col, logits, torch.full((), -1e30, device=logits.device))
