"""internvl2-26b [vlm] — InternViT + InternLM2-20B backbone [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The InternViT-6B
vision frontend is a stub per the assignment: ``input_specs`` provides
precomputed patch embeddings (hidden 3200) which the MLP projector maps into
256 prefix positions of the LM sequence.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_dim=3200,
    frontend_len=256,
)
