"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (MHA: kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284].
The EnCodec/conditioning frontend is a stub per the assignment: ``input_specs``
provides precomputed conditioning frame embeddings (T5-dim 1024) which the
backbone projects and prepends to the token sequence (in lieu of
cross-attention; backbone-only scope — see DESIGN.md §4).
Non-gated 4x GELU FFN (d_ff = 4 * d_model), LayerNorm-free rms variant kept
consistent with the unified backbone.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    gated_mlp=False,
    rope_theta=10000.0,
    frontend="audio",
    frontend_dim=1024,
    frontend_len=64,
)
