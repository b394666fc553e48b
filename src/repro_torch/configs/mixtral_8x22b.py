"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    rope_theta=1e6,
    window=4096,  # Mixtral SWA
    n_experts=8,
    top_k=2,
    activation="silu",
)

SMOKE = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    window=64,
    n_experts=4,
    top_k=2,
    capacity_factor=4.0,  # dropless at smoke scale: exact prefill/decode parity
    activation="silu",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
