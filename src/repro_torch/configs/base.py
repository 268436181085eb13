"""Architecture configuration schema (the port's own copy).

Every assigned architecture is a declarative ``ArchConfig``; the unified
model in ``repro_torch.models.lm`` interprets it.  Configs are *data*, consistent
with the paper's principle that topology should be computed from a small
declarative spec rather than stored ("don't store what you can compute").
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    num_experts: int  # routed experts
    num_shared: int  # always-on shared experts
    top_k: int
    d_expert: int  # per-expert FFN width (fine-grained)
    capacity_factor: float = 1.25
    group_size: int = 512  # dispatch group size (tokens)
    shared_gate: bool = False  # qwen2-moe gates the shared expert output
    aux_loss_weight: float = 0.01
    impl: str = "einsum"  # "einsum" (GShard dense dispatch) | "sort" (argsort dispatch)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    act: str = "silu"  # silu | gelu
    gated_mlp: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0  # gemma-style final-logit soft capping (0 = off)
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    # Block pattern: repeating tuple of block kinds over the layer stack.
    # Kinds: "attn" (global causal), "local" (windowed causal),
    #        "rglru" (Griffin recurrent), "mlstm", "slstm" (xLSTM).
    block_pattern: tuple = ("attn",)
    window: int = 0  # local-attention window (tokens)
    d_rnn: int = 0  # RG-LRU recurrence width
    conv_width: int = 4  # temporal conv width for rglru/mlstm blocks
    moe: Optional[MoECfg] = None
    first_dense: int = 0  # first N layers use a dense MLP even in MoE archs
    first_dense_ff: int = 0  # width of that dense MLP (0 => d_ff)
    # Modality frontend stub (assignment: backbone only, embeddings precomputed)
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 0  # dim of precomputed frontend embeddings
    frontend_len: int = 0  # number of prefix positions provided by the frontend

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ------------------------------------------------------------ properties

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab dim shards
        over the tensor axis (Megatron-style padding; padded logit columns
        are masked to -inf, so the model function is unchanged)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer block kind, expanded from the repeating pattern."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True iff no layer needs a full-sequence KV cache (long_500k eligible)."""
        return all(k != "attn" for k in self.layer_kinds)

    @property
    def has_attention(self) -> bool:
        return any(k in ("attn", "local") for k in self.layer_kinds)

    def param_count(self) -> int:
        """Total parameter count (for roofline MODEL_FLOPS = 6*N*D)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: shared + top_k experts only)."""
        return _count_params(self, active_only=True)

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    total = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head
    total += d  # final norm
    if cfg.frontend:
        total += cfg.frontend_dim * d
    for i, kind in enumerate(cfg.layer_kinds):
        total += 2 * d  # two block norms
        if kind in ("attn", "local"):
            total += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if cfg.qkv_bias:
                total += h * hd + 2 * kv * hd
            if cfg.qk_norm:
                total += 2 * hd
        elif kind == "rglru":
            dr = cfg.d_rnn or d
            total += 2 * d * dr  # x and gate projections
            total += cfg.conv_width * dr  # temporal conv
            total += 3 * dr  # lambda, input-gate, rec-gate params (diagonal)
            total += dr * d  # out projection
        elif kind == "mlstm":
            di = 2 * d  # up-projection factor 2
            total += d * 2 * di  # up proj (x and gate)
            total += cfg.conv_width * di
            total += 3 * di * di // max(cfg.num_heads, 1) * cfg.num_heads  # q,k,v per head
            total += 3 * di  # i,f,o gate projections (per-channel from di)
            total += di * d  # down proj
        elif kind == "slstm":
            # 4 gates, each with input + recurrent (block-diag per head) weights
            total += 4 * d * d + 4 * d * (d // max(cfg.num_heads, 1))
            total += int(d * 4 / 3 * d * 2)  # post-FFN (proj factor 4/3, gated)
        # MLP / MoE
        if kind in ("attn", "local", "rglru"):
            is_moe = cfg.moe is not None and i >= cfg.first_dense
            if is_moe and kind != "rglru":
                m = cfg.moe
                routed = m.num_experts * 3 * d * m.d_expert
                shared = m.num_shared * 3 * d * m.d_expert
                router = d * m.num_experts
                if active_only:
                    routed = m.top_k * 3 * d * m.d_expert
                total += routed + shared + router
                if m.shared_gate:
                    total += d
            elif kind != "rglru" or cfg.d_ff > 0:
                ff = cfg.first_dense_ff if (cfg.moe is not None and i < cfg.first_dense and cfg.first_dense_ff) else cfg.d_ff
                if ff > 0:
                    mult = 3 if cfg.gated_mlp else 2
                    total += mult * d * ff
    return total


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if not.

    long_500k needs sub-quadratic sequence handling: only archs whose
    attention footprint is bounded (pure SSM, or hybrid with *local*
    attention only) qualify.  Full-attention archs skip it.
    """
    if shape.name == "long_500k":
        full_attn = any(k == "attn" for k in cfg.layer_kinds)
        if full_attn:
            return False, "full quadratic attention cannot serve a 524k-token context"
    return True, ""
