"""deepseek-moe-16b [moe] — fine-grained MoE with shared experts
[arXiv:2401.06066].

28L d_model=2048 16H (kv=16) vocab=102400. 2 shared + 64 routed experts,
top-6, per-expert d_ff=1408. First layer is a dense MLP (width 10944), as in
the paper. SwiGLU everywhere, RMSNorm, RoPE.
"""

from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    moe=MoECfg(
        num_experts=64,
        num_shared=2,
        top_k=6,
        d_expert=1408,
        capacity_factor=1.25,
        group_size=512,
    ),
    first_dense=1,
    first_dense_ff=10944,
)
