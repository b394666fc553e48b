"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal. [arXiv:2308.11596]

Backbone-only per the carve-out: the conformer speech frontend
(mel-spectrogram + conv codec) is stubbed; input_specs() feeds precomputed
frame embeddings (B, S_enc, d_model) to the text/unit *encoder-decoder*
transformer implemented here (24 encoder + 24 decoder layers, cross-attn,
MHA kv=16 i.e. no GQA, GELU MLP, learned-free sinusoidal-style RoPE is NOT
used by seamless — it uses relative/none; we use none (nope) for the
encoder and decoder self-attn per the m4t text model's learned positions,
approximated positionless for the backbone repro).
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=1e4,
    activation="gelu",
    embeds_input=True,
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=1024,
    rope_theta=1e4,
    activation="gelu",
    embeds_input=True,
    vocab_pad_multiple=64,
)

register(FULL, SMOKE)
