"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. Pattern: two
RG-LRU recurrent blocks then one local-attention block (window 2048).
GeGLU MLP after every temporal-mixing block, head_dim=256, d_rnn=4096,
temporal conv width 4. Sub-quadratic: eligible for long_500k.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    d_rnn=4096,
    conv_width=4,
)
