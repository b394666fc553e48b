"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP (no gate). [arXiv:2402.16819]
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    rope_theta=1e4,
    activation="relu2",  # squared ReLU, 2-matrix MLP
)

SMOKE = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    activation="relu2",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
