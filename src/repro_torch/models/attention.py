"""Grouped-query attention: prefill and decode (counterpart of
`repro/models/attention.py`).

  * naive  — materialises (B, K, G, Sq, Sk) scores; the CPU path.
  * pallas — the flash kernel (`kernels/ops.flash_attention`); what "auto"
             takes on the card. The name follows the reference's flag.

GQA is native: q is shaped (B, S, K, G, dh) against KV (B, S, K, dh).

Decode writes the fresh token's K/V into its cache slot first and then
attends over the cache (`ops.decode_attention`). That equals the
reference's two-part softmax (cache + fresh token) whenever the slot it
overwrites was already masked: an empty slot (pos < Sc), or pos - Sc outside
a window <= Sc. `InferenceEngine` sizes requests so that pos < Sc holds.

Not ported yet (they raise): qkv_bias, M-RoPE, iRoPE, cross-attention,
chunked attention.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import RuntimeFlags, init_normal_, param
from .rope import rotate

__all__ = [
    "Attention",
    "init_attention",
    "naive_attention",
    "attention_core",
    "attention_forward",
    "decode_attention",
]

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.qkv_bias or cfg.mrope_sections or cfg.nope_interval:
            raise NotImplementedError(
                "qkv_bias / M-RoPE / iRoPE attention is not ported yet"
            )
        d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((d, H, dh), device, dtype)
        self.wk = param((d, K, dh), device, dtype)
        self.wv = param((d, K, dh), device, dtype)
        self.wo = param((H, dh, d), device, dtype)


def init_attention(p: Attention, gen: torch.Generator) -> Attention:
    H, dh = p.wo.shape[:2]
    init_normal_(p.wq, gen)
    init_normal_(p.wk, gen)
    init_normal_(p.wv, gen)
    init_normal_(p.wo, gen, scale=1.0 / math.sqrt(H * dh))
    return p


# ---------------------------------------------------------------------------
# score/softmax/mix cores
# ---------------------------------------------------------------------------


def _mask_ok(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(B, Sq, Sk) validity; k_pos < 0 marks padding slots."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok


def naive_attention(
    q: torch.Tensor,  # (B, Sq, K, G, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dh)
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    causal: bool,
    window: int,
) -> torch.Tensor:
    dh = q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() / math.sqrt(dh)
    ok = _mask_ok(q_pos, k_pos, causal, window)  # (B, Sq, Sk)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    # fully-masked rows emit 0 (the online-softmax l = 0 convention)
    p = p * ok.any(-1)[:, None, None, :, None].to(p.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def attention_core(
    q, k, v, q_pos, k_pos, causal: bool, window: int, rt: RuntimeFlags
) -> torch.Tensor:
    """q_pos/k_pos are arange positions here (see decoder_forward)."""
    if rt.attn_impl_for(q.is_cuda) == "pallas":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return naive_attention(q, k, v, q_pos, k_pos, causal, window)


# ---------------------------------------------------------------------------
# full layers
# ---------------------------------------------------------------------------


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, N, dh) -> (B, S, N, dh) as one matmul."""
    d, n, dh = w.shape
    return (x @ w.view(d, n * dh)).view(*x.shape[:-1], n, dh)


def _project_qkv(
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # rope_tables, None = NoPE
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _project(x, p.wq), _project(x, p.wk), _project(x, p.wv)
    if rope is not None:
        q, k = rotate(q, rope), rotate(k, rope)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (..., H, dh) @ wo (H, dh, d) -> (..., d)."""
    H, dh, d = wo.shape
    return out.reshape(*out.shape[:-2], H * dh) @ wo.view(H * dh, d)


def attention_forward(
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    rt: RuntimeFlags,
    positions: torch.Tensor,  # (B, S)
    rope: Tuple[torch.Tensor, torch.Tensor],  # rope_tables(positions)
    *,
    causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out (B, S, d), (k, v) for cache collection)."""
    B, S, _ = x.shape
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, rope)
    qg = q.view(B, S, K, G, cfg.head_dim)
    out = attention_core(qg, k, v, positions, positions, causal, window, rt)
    return _out_proj(out.reshape(B, S, cfg.n_heads, cfg.head_dim), p.wo), (k, v)


def decode_attention(
    p: Attention,
    x: torch.Tensor,  # (B, d) — one new token per sequence
    pos: torch.Tensor,  # (B,) int32 current position
    rope: Tuple[torch.Tensor, torch.Tensor],  # rope_tables(pos[:, None])
    flat_slot: torch.Tensor,  # (B,) int64: b * Sc + pos % Sc, the new token's row
    cache_k: torch.Tensor,  # (B, Sc, K, dh) — this layer's cache, updated in place
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # (B, Sc) int32, pos already written at the slot
    *,
    window: int = 0,
) -> torch.Tensor:
    """One decode step: write the new K/V at its slot, attend over the cache.

    The cache tensors are updated in place (the reference rebuilds them
    functionally); at full width a per-step copy would double the KV
    traffic. Returns out (B, d)."""
    q, k, v = _project_qkv(p, x[:, None, :], rope)
    K, dh = cache_k.shape[2:]
    cache_k.view(-1, K, dh).index_copy_(0, flat_slot, k[:, 0])
    cache_v.view(-1, K, dh).index_copy_(0, flat_slot, v[:, 0])
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, cache_pos, pos, window=window)
    return _out_proj(out, p.wo)
