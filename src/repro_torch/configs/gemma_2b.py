"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU MLP, head_dim=256 (8*256=2048), MQA, tied embeddings, embeddings scaled
by sqrt(d_model) [arXiv:2403.08295].
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
)
