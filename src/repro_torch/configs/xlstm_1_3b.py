"""xlstm-1.3b [ssm] — 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks. [arXiv:2405.04517]

The xLSTM[7:1]-style stack: most blocks are mLSTM (matrix-memory, fully
parallelizable, post-up-projection with expansion 2), every
`slstm_every`-th block is sLSTM (scalar-memory recurrent, pre-up-projection
with a GELU-gated FFN). d_ff=0 in the assignment because xLSTM blocks carry
their FFN inside the block (projection factor), not as a separate MLP.
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    activation="gelu",
    ssm_expand=2,  # mLSTM up-projection factor
    ssm_head_dim=512,  # d_inner / n_heads = 4096 / 8? -> heads defined below
    slstm_every=8,  # blocks 7, 15, ... are sLSTM (1:8 ratio)
)

SMOKE = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=1024,
    activation="gelu",
    ssm_expand=2,
    ssm_head_dim=128,
    slstm_every=2,
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
