"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

81 Mamba2 layers; a single *weight-shared* attention+MLP block is applied
every `shared_attn_every` layers (Zamba2's "shared transformer block"),
concatenating the layer input with the original embedding is simplified to a
residual application (backbone repro).
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e4,
    activation="silu",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    activation="silu",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=2,
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
