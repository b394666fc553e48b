"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA. [hf:THUDM/glm-4-9b]
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=1e4,
    qkv_bias=True,  # GLM-4 uses QKV bias (add_qkv_bias)
    activation="silu",
)

SMOKE = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    qkv_bias=True,
    activation="silu",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
