"""Flash-decoding on the card: wrapper over `csrc/decode_attention.cu`.

Replaces the Pallas kernel `repro/kernels/decode_attention.py:decode_attention`;
the plain version is `ref.decode_attention`. The kernel reads the cache in
the model's (B, Sc, K, dh) layout through strides.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import HEAD_DIMS

__all__ = ["decode_attention", "MAX_GROUP"]

MAX_GROUP = 8  # query heads per KV head that one CTA holds


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Sc, K, dh)
    v: torch.Tensor,  # (B, Sc, K, dh)
    kv_pos: torch.Tensor,  # (B, Sc) int32, -1 = empty
    pos: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    """One query token per sequence against its cache; returns (B, H, dh)."""
    B, H, dh = q.shape
    Bk, Sc, K, dhk = k.shape
    if not all(t.is_cuda for t in (q, k, v, kv_pos, pos)):
        raise ValueError("decode_attention kernel: tensors must be on the card")
    if k.shape != v.shape or Bk != B or dhk != dh or H % K or H // K > MAX_GROUP:
        raise ValueError(
            f"decode_attention kernel: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"(G <= {MAX_GROUP})"
        )
    if kv_pos.shape != (B, Sc) or pos.shape != (B,):
        raise ValueError("decode_attention kernel: kv_pos (B, Sc), pos (B,)")
    if kv_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("decode_attention kernel: kv_pos and pos must be int32")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("decode_attention kernel: q, k, v dtypes differ")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: dh={dh} not in {HEAD_DIMS}")
    if (q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1
            or kv_pos.stride(-1) != 1 or not pos.is_contiguous()):
        raise ValueError("decode_attention kernel: inner axes must be contiguous")
    out = torch.empty((B, H, dh), dtype=q.dtype, device=q.device)
    lib = _build.library()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, H, K, Sc,
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], kv_pos.stride(0),
        *out.stride()[:2], dh, int(window), 1.0 / math.sqrt(dh),
        _build.dtype_code(q, "decode_attention"), _build.stream_of(q),
    )
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
