"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407]
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
    activation="silu",
)

SMOKE = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    activation="silu",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
