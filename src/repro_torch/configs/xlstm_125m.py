"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H vocab=50304, d_ff=0 (blocks carry their own expansion:
mLSTM up-projection factor 2, sLSTM post-FFN factor 4/3). Pattern: three
mLSTM blocks then one sLSTM block (xLSTM[3:1]-style). Sub-quadratic (matrix /
scalar memory states only): eligible for long_500k.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    act="gelu",
    gated_mlp=False,
    rope_theta=10000.0,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    conv_width=4,
)
