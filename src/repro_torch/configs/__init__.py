"""Config registry: ``get_config(arch_id)`` resolves any assigned arch.

The port keeps its own copy of the JAX package's configs (pure data), so
nothing here imports the reference.  ``reduced_config`` gives a small
same-family config for CPU tests.
"""

from __future__ import annotations

from .base import SHAPES, ArchConfig, MoECfg, ShapeCfg, shape_applicable
from . import (
    deepseek_moe_16b,
    gemma_2b,
    internvl2_26b,
    musicgen_large,
    qwen15_4b,
    qwen2_moe_a27b,
    qwen3_14b,
    recurrentgemma_9b,
    xlstm_125m,
    yi_6b,
)

_REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        musicgen_large,
        qwen15_4b,
        qwen3_14b,
        yi_6b,
        gemma_2b,
        internvl2_26b,
        recurrentgemma_9b,
        deepseek_moe_16b,
        qwen2_moe_a27b,
        xlstm_125m,
    )
}

ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_IDS)}")
    return _REGISTRY[name]


def reduced_config(name: str) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests: same block pattern,
    same attention/MoE/recurrence structure, small dims."""
    full = get_config(name)
    kv = min(full.num_kv_heads, 2) if full.num_kv_heads < full.num_heads else 4
    moe = None
    if full.moe is not None:
        moe = MoECfg(
            num_experts=8,
            num_shared=min(full.moe.num_shared, 2),
            top_k=min(full.moe.top_k, 2),
            d_expert=64,
            capacity_factor=full.moe.capacity_factor,
            group_size=64,
            shared_gate=full.moe.shared_gate,
            impl=full.moe.impl,
        )
    n_layers = 2 * len(full.block_pattern)
    return full.with_(
        name=full.name + "-smoke",
        num_layers=n_layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=0 if full.d_ff == 0 else 256,
        vocab_size=512,
        window=min(full.window, 64) if full.window else 0,
        d_rnn=128 if full.d_rnn else 0,
        moe=moe,
        first_dense=min(full.first_dense, 1),
        first_dense_ff=256 if full.first_dense_ff else 0,
        frontend=full.frontend,
        frontend_dim=64 if full.frontend else 0,
        frontend_len=8 if full.frontend else 0,
    )


__all__ = ["ARCH_IDS", "ArchConfig", "MoECfg", "SHAPES", "ShapeCfg", "get_config",
           "reduced_config", "shape_applicable"]
