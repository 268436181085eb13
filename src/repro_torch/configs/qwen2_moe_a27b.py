"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936, per-expert d_ff=1408. The shared
expert output is gated by a sigmoid (shared_gate). QKV bias on (Qwen1.5
lineage). SwiGLU, RMSNorm, RoPE.
"""

from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    moe=MoECfg(
        num_experts=60,
        num_shared=4,
        top_k=4,
        d_expert=1408,
        capacity_factor=1.25,
        group_size=512,
        shared_gate=True,
    ),
)
