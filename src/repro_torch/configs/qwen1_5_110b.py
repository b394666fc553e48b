"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B family scaled per assignment]
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    activation="silu",
)

SMOKE = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    qkv_bias=True,
    rope_theta=1e4,
    activation="silu",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
