"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191]

Backbone-only per the carve-out: the ViT frontend is stubbed; input_specs()
feeds precomputed patch embeddings (B, S, d_model). M-RoPE splits the rotary
dims into (temporal, height, width) sections = (16, 24, 24) of the 64
half-dims (Qwen2-VL mrope_section = [16, 24, 24]).
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,  # qwen2 keeps QKV bias
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    activation="silu",
    embeds_input=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    qkv_bias=True,
    rope_theta=1e4,
    mrope_sections=(8, 4, 4),  # sums to half of head_dim//2? -> 16 = 32//2
    activation="silu",
    embeds_input=True,
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
