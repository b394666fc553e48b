"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 — MoE, early fusion, iRoPE.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Early-fusion multimodality enters through the (stubbed) vision frontend —
the language backbone here consumes token ids (text path) and is what we
implement. iRoPE: every `nope_interval`-th layer uses no positional
encoding (global attention), the rest use RoPE.
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=5e5,
    nope_interval=4,
    n_experts=16,
    top_k=1,
    activation="silu",
)

SMOKE = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    nope_interval=2,
    n_experts=4,
    top_k=1,
    capacity_factor=8.0,  # dropless at smoke scale: exact prefill/decode parity
    activation="silu",
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
