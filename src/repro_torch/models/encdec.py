"""Encoder-decoder transformer, the seamless-m4t backbone (counterpart of
`repro/models/encdec.py`).

The speech frontend is stubbed, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d). The decoder is a causal
transformer with cross attention over the encoder output in every layer.
RoPE gives positions on both self-attention paths and to the cross
attention's queries (not to its keys, `attention.project_kv`).

Parameters: an `EncDec` module with `enc_layers` (a `transformer.Block` per
encoder layer), `dec_layers` (`DecLayer`: self_attn, cross_attn, mlp and a
norm before each), `enc_final_norm`, `embed`, `final_norm` and `lm_head`.

Decode cache: the self-attention KV {"k", "v": (L, B, Sc, K, dh), "pos"}
plus the static cross-attention KV {"cross_k", "cross_v": (L, B, S_enc, K,
dh), "cross_pos": (B, S_enc)}, projected once at prefill (the paper's
N_input tokens map to encoder frames here). Decode writes the self-attention
slot in place and reads the cross cache only.

Kernel launches per forward, L decoder and Le encoder layers: prefill 2 Le
+ 1 + 3 L + 1 rmsnorm and Le + 2 L flash; a decode step 3 L + 1 rmsnorm and
2 L decode_attention (self and cross).

Under a mesh (`sharding.use_mesh`) the encoder input, the decoder's
embedded tokens (a vocab-parallel lookup, `transformer.embed_lookup`) and
the decode step's token are pinned at the reference's four `constrain`
sites; the encoder's non-causal flash, the cross prefill (Sq != Sk) and the
cross decode run on local shards (`kernels/ops.py`), and the cross cache,
written once at prefill, is laid out by `encdec_cache_axes`. `encdec_forward` is the training
path: differentiable, with naive or chunked attention and, under remat,
each encoder and decoder layer recomputed in the backward
(`model.rmsnorm_calls` counts a train step's norms). Under TRAIN_RULES it
runs on DTensors (`Model.loss`): the encoder's, the decoder's self and the
cross attention each on local shards (`attention._local_core`), the cross
K/V's gradient reaching the encoder through the same redistributions.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import sharding as sh
from ..configs.base import ModelConfig
from ..sharding import constrain
from .attention import (
    Attention,
    attention_forward,
    cross_decode_attention,
    decode_attention,
    init_attention,
    project_kv,
)
from .common import DTYPES, RuntimeFlags, init_normal_, param, rms_norm
from .mlp import MLP, init_mlp, mlp_forward
from .transformer import (
    KV_AXES,
    POS_AXES,
    Block,
    _arange_positions,
    _rope_tables,
    embed_lookup,
    init_block,
    logits_from_hidden,
    remat_on,
    write_positions,
)

__all__ = [
    "DecLayer",
    "EncDec",
    "init_encdec_params",
    "encode",
    "encdec_forward",
    "encdec_prefill",
    "encdec_decode",
    "init_encdec_cache",
    "encdec_cache_axes",
]


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.self_norm = param((cfg.d_model,), ("p_embed",), device, dtype)
        self.self_attn = Attention(cfg, device=device, dtype=dtype)
        self.cross_norm = param((cfg.d_model,), ("p_embed",), device, dtype)
        self.cross_attn = Attention(cfg, device=device, dtype=dtype)
        self.mlp_norm = param((cfg.d_model,), ("p_embed",), device, dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype)


class EncDec(nn.Module):
    """All parameters of an encoder-decoder; `init_encdec_params` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        if not cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name} has no encoder: it is a `transformer.Decoder`")
        dtype = dtype or DTYPES[cfg.dtype]
        d, V = cfg.d_model, cfg.padded_vocab
        self.embed = param((V, d), ("p_vocab", "p_embed"), device, dtype)
        self.enc_final_norm = param((d,), ("p_embed",), device, dtype)
        self.final_norm = param((d,), ("p_embed",), device, dtype)
        self.lm_head = param((d, V), ("p_embed", "p_vocab"), device, dtype)
        self.enc_layers = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype) for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.n_layers))


@torch.no_grad()
def init_encdec_params(cfg: ModelConfig, gen: torch.Generator, device, dtype=None) -> EncDec:
    """Random weights with the reference's shapes and scales (as
    `transformer.init_decoder_params`), drawn on `device` from `gen`."""
    p = EncDec(cfg, device=device, dtype=dtype)
    init_normal_(p.embed, gen, scale=0.02)
    init_normal_(p.lm_head, gen)
    p.enc_final_norm.fill_(1.0)
    p.final_norm.fill_(1.0)
    for blk in p.enc_layers:
        init_block(blk, cfg, gen)
    for lp in p.dec_layers:
        for n in (lp.self_norm, lp.cross_norm, lp.mlp_norm):
            n.fill_(1.0)
        init_attention(lp.self_attn, gen)
        init_attention(lp.cross_attn, gen)
        init_mlp(lp.mlp, gen)
    return p


def _enc_layer(lp: Block, x, cfg, rt, positions, rope):
    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    x = x + attention_forward(lp.attn, h, cfg, rt, positions, rope, causal=False)[0]
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    return x + mlp_forward(lp.mlp, h, cfg)


def encode(params: EncDec, cfg: ModelConfig, rt: RuntimeFlags,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over frame embeddings (B, S_enc, d) -> (B, S_enc, d).
    Under remat (`transformer.remat_on`) each layer runs again in the
    backward, as the reference's `jax.checkpoint` around its layer."""
    positions = _arange_positions(enc_embeds, None)
    rope = _rope_tables(cfg, positions)
    remat = remat_on(rt, params.enc_layers, False)
    x = constrain(enc_embeds, ("batch", "seq", "embed"))
    for lp in params.enc_layers:
        args = (lp, x, cfg, rt, positions, rope)
        x = (checkpoint(sh.bound(_enc_layer), *args, use_reentrant=False) if remat
             else _enc_layer(*args))
    return rms_norm(x, params.enc_final_norm, cfg.norm_eps)


def _dec_layer(lp: DecLayer, x, cfg, rt, positions, rope, enc_out, enc_pos):
    """-> (x, (k, v), (cross k, cross v)). The cross K/V are projected from
    enc_out here, so their gradient reaches the encoder."""
    h = rms_norm(x, lp.self_norm, cfg.norm_eps)
    a, kv = attention_forward(lp.self_attn, h, cfg, rt, positions, rope, causal=True)
    x = x + a
    h = rms_norm(x, lp.cross_norm, cfg.norm_eps)
    ckv = project_kv(lp.cross_attn, enc_out)
    x = x + attention_forward(lp.cross_attn, h, cfg, rt, positions, rope,
                              cross_kv=ckv, cross_pos=enc_pos)[0]
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    return x + mlp_forward(lp.mlp, h, cfg), kv, ckv


def _dec_stack(params: EncDec, cfg, rt, x, positions, enc_out, enc_pos, collect_cache: bool):
    """Decoder layers over (B, S, d) with cross attention on enc_out.
    -> (x, per-layer ((k, v), (cross k, cross v)) if collect_cache). Under
    remat each layer runs again in the backward, as in `encode`."""
    rope = _rope_tables(cfg, positions)
    remat = remat_on(rt, params.dec_layers, collect_cache)
    kvs = []
    for lp in params.dec_layers:
        args = (lp, x, cfg, rt, positions, rope, enc_out, enc_pos)
        if remat:
            x = checkpoint(sh.bound(_dec_layer), *args, use_reentrant=False)[0]
            continue
        x, kv, ckv = _dec_layer(*args)
        if collect_cache:
            kvs.append((kv, ckv))
    return x, kvs


def _encode_and_decode(params, cfg, rt, enc_embeds, dec_tokens, collect_cache: bool):
    enc_out = encode(params, cfg, rt, enc_embeds)
    enc_pos = _arange_positions(enc_out, None)
    positions = _arange_positions(dec_tokens, None)
    x = constrain(embed_lookup(params.embed, dec_tokens), ("batch", "seq", "embed"))
    x, kvs = _dec_stack(params, cfg, rt, x, positions, enc_out, enc_pos, collect_cache)
    return x, kvs, positions, enc_pos


def encdec_forward(
    params: EncDec,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    enc_embeds: torch.Tensor,  # (B, S_enc, d)
    dec_tokens: torch.Tensor,  # (B, S_dec)
) -> Tuple[torch.Tensor, dict]:
    """Teacher-forced forward. Returns (logits (B, S_dec, V), {}).
    Differentiable (the training path, `Model.loss`); prefill and decode
    run under `torch.no_grad()`."""
    x, _, _, _ = _encode_and_decode(params, cfg, rt, enc_embeds, dec_tokens, False)
    return logits_from_hidden(params, cfg, x), {}


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int,
                      device, dtype=None) -> dict:
    """Zeroed cache: self-attention slots empty (pos -1); the cross cache
    zeros with positions 0, as the reference's."""
    dtype = dtype or DTYPES[cfg.dtype]
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(S):
        return torch.zeros((L, batch, S, K, dh), dtype=dtype, device=device)

    return {
        "k": zeros(cache_len),
        "v": zeros(cache_len),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
        "cross_k": zeros(enc_len),
        "cross_v": zeros(enc_len),
        "cross_pos": torch.zeros((batch, enc_len), dtype=torch.int32, device=device),
    }


def encdec_cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of `init_encdec_cache`'s tree, the reference's."""
    return {"k": KV_AXES, "v": KV_AXES, "pos": POS_AXES,
            "cross_k": KV_AXES, "cross_v": KV_AXES, "cross_pos": POS_AXES}


@torch.no_grad()
def encdec_prefill(
    params: EncDec,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    enc_embeds: torch.Tensor,  # (B, S_enc, d)
    dec_tokens: torch.Tensor,  # (B, S_dec)
) -> Tuple[torch.Tensor, dict]:
    """Encode, run the decoder over its prompt; returns (last-position
    logits (B, V), cache)."""
    x, kvs, positions, enc_pos = _encode_and_decode(params, cfg, rt, enc_embeds,
                                                     dec_tokens, True)
    cache = {
        "k": torch.stack([kv[0] for kv, _ in kvs]),
        "v": torch.stack([kv[1] for kv, _ in kvs]),
        "pos": positions.to(torch.int32).contiguous(),
        "cross_k": torch.stack([ckv[0] for _, ckv in kvs]),
        "cross_v": torch.stack([ckv[1] for _, ckv in kvs]),
        "cross_pos": enc_pos.to(torch.int32).contiguous(),
    }
    return logits_from_hidden(params, cfg, x[:, -1]), cache


@torch.no_grad()
def encdec_decode(
    params: EncDec,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    cache: dict,
    token: torch.Tensor,  # (B,)
    pos: torch.Tensor,  # (B,) int32
) -> Tuple[torch.Tensor, dict]:
    """One decode step: returns (logits (B, V), the cache, its self-attention
    part updated in place)."""
    x = constrain(embed_lookup(params.embed, token), ("batch", "embed"))
    pos = pos.to(torch.int32)
    flat_slot = write_positions(cache, pos, 0)
    rope = _rope_tables(cfg, pos[:, None])
    Se = cache["cross_pos"].shape[1]
    beyond = torch.full_like(pos, Se)  # no encoder position reaches it
    for i, lp in enumerate(params.dec_layers):
        h = rms_norm(x, lp.self_norm, cfg.norm_eps)
        x = x + decode_attention(lp.self_attn, h, pos, rope, flat_slot, cache["k"][i],
                                 cache["v"][i], cache["pos"])
        h = rms_norm(x, lp.cross_norm, cfg.norm_eps)
        x = x + cross_decode_attention(lp.cross_attn, h, rope, cache["cross_k"][i],
                                       cache["cross_v"][i], cache["cross_pos"], beyond)
        h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
        x = x + mlp_forward(lp.mlp, h, cfg)
    return logits_from_hidden(params, cfg, x), cache
