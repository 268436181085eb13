"""yi-6b [dense] — llama-arch GQA. 32L d_model=4096 32H (kv=4) d_ff=11008
vocab=64000 [arXiv:2403.04652]. SwiGLU, RMSNorm, RoPE.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    act="silu",
    gated_mlp=True,
    rope_theta=5_000_000.0,
)
