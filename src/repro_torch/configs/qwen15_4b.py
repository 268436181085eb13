"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.

QKV bias on (Qwen1.5 family trait) [hf:Qwen/Qwen1.5-0.5B]. SwiGLU MLP,
RMSNorm, RoPE.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
)
