"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm on (per-head RMSNorm on q and k), GQA [hf:Qwen/Qwen3-8B]. SwiGLU,
RMSNorm, RoPE theta 1e6, head_dim=128.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
)
