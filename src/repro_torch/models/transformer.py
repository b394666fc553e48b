"""Decoder-only stack, dense, vlm and moe families (counterpart of
`repro/models/transformer.py`).

Parameters: a `Decoder` module whose `layers` is an `nn.ModuleList` of
per-layer `Block`s; the reference keeps a leading layer axis on each leaf
instead (`convert.py` splits it). The uniform stack is a Python loop over
the blocks; iRoPE's per-layer RoPE flag is a Python `if` per layer. A moe
block holds `moe` (routed experts, `moe.py`) where a dense one holds `mlp`,
and `decoder_forward` returns the router aux losses summed over layers.

Inputs are tokens (B, S) or frontend embeddings (B, S, d) (vlm); decode
embeds the generated tokens. Tied embeddings have no `lm_head`: the logits
use a view of `embed.T`.

Cache: {"k", "v": (L, B, Sc, K, dh), "pos": (B, Sc) int32}, the reference's
layout; decode updates it in place. Sliding-window serving
(`window_override`) uses the same buffers as a ring (slot = pos % Sc).

Not ported yet (they raise): hybrid (zamba2), ssm (xlstm), enc-dec.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import Attention, attention_forward, decode_attention, init_attention
from .common import DTYPES, RuntimeFlags, init_normal_, param, rms_norm
from .mlp import MLP, init_mlp, mlp_forward
from .moe import MoE, init_moe, moe_forward
from .rope import mrope_tables, rope_tables, text_mrope_positions

__all__ = [
    "Block",
    "Decoder",
    "init_decoder_params",
    "decoder_forward",
    "decoder_prefill",
    "decoder_decode",
    "init_decode_cache",
    "logits_from_hidden",
    "embed_inputs",
]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe") or cfg.n_encoder_layers:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


class Block(nn.Module):
    """Pre-norm attention + MLP residual block; `moe` in place of `mlp` when
    the config has experts (the reference's tree keys)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.attn_norm = param((cfg.d_model,), device, dtype)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.mlp_norm = param((cfg.d_model,), device, dtype)
        if cfg.n_experts:
            self.moe = MoE(cfg, device=device, dtype=dtype)
        else:
            self.mlp = MLP(cfg, device=device, dtype=dtype)


class Decoder(nn.Module):
    """All parameters of a dense, vlm or moe decoder; `init_decoder_params` fills
    them. `lm_head` is None under tied embeddings."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        _check_supported(cfg)
        dtype = dtype or DTYPES[cfg.dtype]
        self.embed = param((cfg.padded_vocab, cfg.d_model), device, dtype)
        self.final_norm = param((cfg.d_model,), device, dtype)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((cfg.d_model, cfg.padded_vocab), device, dtype))
        self.layers = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype) for _ in range(cfg.n_layers)
        )


@torch.no_grad()
def init_decoder_params(
    cfg: ModelConfig, gen: torch.Generator, device, dtype=None
) -> Decoder:
    """Random weights with the reference's shapes and scales: embed 0.02,
    wo 1/sqrt(H*dh), the leading dim otherwise (fan-in; E for the expert
    weights), norms ones. Drawn on `device` from
    `gen` (a generator of that device)."""
    p = Decoder(cfg, device=device, dtype=dtype)
    init_normal_(p.embed, gen, scale=0.02)
    p.final_norm.fill_(1.0)
    if p.lm_head is not None:
        init_normal_(p.lm_head, gen)
    for blk in p.layers:
        blk.attn_norm.fill_(1.0)
        blk.mlp_norm.fill_(1.0)
        init_attention(blk.attn, gen)
        if cfg.n_experts:
            init_moe(blk.moe, gen)
        else:
            init_mlp(blk.mlp, gen)
    return p


# ---------------------------------------------------------------------------
# shared forward pieces
# ---------------------------------------------------------------------------


def embed_inputs(params: Decoder, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d); (B, S, d) frontend embeds pass through."""
    if inputs.dim() == 3:
        return inputs
    return params.embed[inputs.long()]


def logits_from_hidden(params: Decoder, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w = params.embed.T if params.lm_head is None else params.lm_head  # tied: a view
    return h @ w


def _uses_rope(cfg: ModelConfig, i: int) -> bool:
    """iRoPE: layer i skips RoPE when (i + 1) % nope_interval == 0."""
    return not cfg.nope_interval or (i + 1) % cfg.nope_interval != 0


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor,
                 mrope_positions: Optional[torch.Tensor] = None):
    """Angle tables for positions (B, S), shared by every RoPE layer; M-RoPE
    archs take the (3, B, S) streams, text positions when none are given."""
    if cfg.mrope_sections:
        m = text_mrope_positions(positions) if mrope_positions is None else mrope_positions
        return mrope_tables(m, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _attn_block_apply(lp: Block, x, cfg, rt, positions, rope, window: int):
    """-> (x, (k, v), aux losses of this block)."""
    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    a, kv = attention_forward(lp.attn, h, cfg, rt, positions, rope, causal=True,
                              window=window)
    x = x + a
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.n_experts:
        m, aux = moe_forward(lp.moe, h, cfg, rt.moe_dispatch)
    else:
        m, aux = mlp_forward(lp.mlp, h, cfg), {}
    return x + m, kv, aux


def _attn_block_decode(lp: Block, x, cfg, rt, pos, rope, flat_slot, ck, cv, cache_pos,
                       window: int):
    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    x = x + decode_attention(lp.attn, h, pos, rope, flat_slot, ck, cv, cache_pos,
                             window=window)
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.n_experts:  # each row is its own group of one token (C = 8)
        return x + moe_forward(lp.moe, h[:, None], cfg, rt.moe_dispatch, aux=False)[0][:, 0]
    return x + mlp_forward(lp.mlp, h, cfg)


# ---------------------------------------------------------------------------
# uniform (dense / vlm / moe) stack
# ---------------------------------------------------------------------------


def _uniform_stack(params: Decoder, cfg, rt, x, positions, mrope_positions,
                   collect_cache: bool):
    """-> (x, per-layer (k, v) if collect_cache, aux losses summed over
    layers: zeros-started for moe configs, {} otherwise)."""
    window = rt.window_for(cfg.window)
    rope = _rope_tables(cfg, positions, mrope_positions)
    aux = (dict.fromkeys(("moe_lb_loss", "moe_z_loss"),
                         torch.zeros((), dtype=torch.float32, device=x.device))
           if cfg.n_experts else {})
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i, lp in enumerate(params.layers):
        x, kv, a = _attn_block_apply(lp, x, cfg, rt, positions,
                                     rope if _uses_rope(cfg, i) else None, window)
        for name, v in a.items():
            aux[name] = aux[name] + v
        if collect_cache:
            kvs.append(kv)
    return x, kvs, aux


def _uniform_decode(params: Decoder, cfg, rt, x, pos, cache: dict):
    """Write-then-attend decode. The new position goes into cache["pos"]
    before the first layer, so every layer's kernel sees the fresh slot.

    Writing first equals the reference's two-part softmax whenever the slot
    a step overwrites is one the reference does not attend to: an empty slot
    (pos < Sc), or, in a ring (slot = pos % Sc) that holds the whole window,
    the slot of pos - Sc, outside the window. A step at pos >= Sc into a
    cache smaller than the window would overwrite a slot still inside it,
    so it raises.

    The check reads the positions only where they already are on the host
    (CPU tensors): on the card it would cost a device-to-host sync every
    step. There `InferenceEngine.submit` keeps every position below Sc
    (prompt + new tokens <= max_seq), checked on the host at admission."""
    window = rt.window_for(cfg.window)
    Sc = cache["k"].shape[2]
    if window and Sc < window and not pos.is_cuda and int(pos.max()) >= Sc:
        raise ValueError(f"position {int(pos.max())} would wrap a cache of {Sc} slots, "
                         f"smaller than the window {window}")
    slot = (pos % Sc).long()  # ring-buffer slot (full cache: pos < Sc)
    flat_slot = torch.arange(x.shape[0], device=x.device) * Sc + slot
    cache["pos"].view(-1).index_copy_(0, flat_slot, pos)
    rope = _rope_tables(cfg, pos[:, None])
    for i, lp in enumerate(params.layers):
        x = _attn_block_decode(
            lp, x, cfg, rt, pos, rope if _uses_rope(cfg, i) else None, flat_slot,
            cache["k"][i], cache["v"][i], cache["pos"], window,
        )
    return x, cache


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _arange_positions(inputs: torch.Tensor, positions: Optional[torch.Tensor]):
    """Prefill positions. The flash kernel assumes arange positions, so a
    call on the card with any other positions raises."""
    B, S = inputs.shape[:2]
    if positions is not None:
        if inputs.is_cuda:
            raise ValueError("explicit positions: the flash kernel takes arange only")
        return positions
    return torch.arange(S, dtype=torch.int32, device=inputs.device).expand(B, S)


@torch.no_grad()
def decoder_forward(
    params: Decoder,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    inputs: torch.Tensor,  # (B, S) tokens or (B, S, d) embeds
    positions: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
) -> Tuple[torch.Tensor, dict]:
    """Full forward to logits. Returns (logits (B, S, V), aux): the moe
    router losses summed over layers, {} for dense and vlm."""
    positions = _arange_positions(inputs, positions)
    x = embed_inputs(params, cfg, inputs)
    x, _, aux = _uniform_stack(params, cfg, rt, x, positions, mrope_positions,
                               collect_cache=False)
    return logits_from_hidden(params, cfg, x), aux


def init_decode_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device, dtype=None
) -> dict:
    """Zeroed decode cache, every slot empty (pos -1).

    cache_len: KV capacity (== seq_len, or window size for ring caches)."""
    _check_supported(cfg)
    dtype = dtype or DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decoder_prefill(
    params: Decoder,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    inputs: torch.Tensor,  # (B, S) tokens or (B, S, d) embeds
    positions: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
) -> Tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B, V), cache)."""
    positions = _arange_positions(inputs, positions)
    x = embed_inputs(params, cfg, inputs)
    x, kvs, _ = _uniform_stack(params, cfg, rt, x, positions, mrope_positions,
                               collect_cache=True)
    cache = {
        "k": torch.stack([k for k, _ in kvs]),  # (L, B, S, K, dh)
        "v": torch.stack([v for _, v in kvs]),
        "pos": positions.to(torch.int32).contiguous(),
    }
    return logits_from_hidden(params, cfg, x[:, -1]), cache


@torch.no_grad()
def decoder_decode(
    params: Decoder,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    cache: dict,
    token: torch.Tensor,  # (B,) int tokens or (B, d) embeds (vlm)
    pos: torch.Tensor,  # (B,) int32
) -> Tuple[torch.Tensor, dict]:
    """One decode step: returns (logits (B, V), the cache updated in place)."""
    if cfg.embeds_input and token.dim() == 2:
        x = token
    else:
        x = params.embed[token.long()]
    x, cache = _uniform_decode(params, cfg, rt, x, pos.to(torch.int32), cache)
    return logits_from_hidden(params, cfg, x), cache
