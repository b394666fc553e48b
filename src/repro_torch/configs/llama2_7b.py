"""llama2-7b [dense] — the paper's own serving model (Table I, FP16).

32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000. Used by the
faithful Fig. 6/7 reproduction and by the serving-engine examples.
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=1e4,
    activation="silu",
)

SMOKE = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    activation="silu",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
