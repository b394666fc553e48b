"""Flash-decoding on the card: wrapper over `csrc/decode_attention.cu`.

Replaces the Pallas kernel `repro/kernels/decode_attention.py:decode_attention`;
the plain version is `ref.decode_attention`. The kernel reads the cache in
the model's (B, Sc, K, dh) layout through strides.

A CTA holds 1, 2 or 4 query heads of one KV head: a KV head's G query heads
(any G) are cut into `head_groups` of the largest of those sizes that
divides G, each of which reads the KV head's rows. Few long sequences leave
most SMs idle with one CTA per (row, head group), so the cache is split into
ranges of whole 64-slot tiles (`decode_splits`), one CTA each, merged by the
last CTA of each (row, head group) in the same launch. The merge counters are zeroed
once per device and left zero by every call; calls that share them must run
on one stream.

With `return_lse=True` the same launch returns the f32 output and each (row,
head)'s log-sum-exp of its valid scores (-inf, and an output of 0, where no
slot is valid): the parts that the sharded decode over a cache cut by slots
merges across ranks (`ops.decode_attention`). Those launches count under
`LAUNCHES["decode_attention_lse"]`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import _build
from .flash_attention import HEAD_DIMS

__all__ = ["decode_attention", "decode_splits", "head_groups", "CTA_HEADS", "MAX_SPLITS",
           "TILE"]

CTA_HEADS = (4, 2, 1)  # the query heads one CTA may hold, the largest that divides G
MAX_SPLITS = 64  # the kernel's bound on splits per (row, KV head)
TILE = 64  # cache slots per tile: a split holds whole tiles

_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def head_groups(G: int) -> int:
    """How many CTAs share one KV head's G query heads: groups of the largest
    size in CTA_HEADS that divides G. On the H100 four heads a CTA beat all
    16 in one CTA at every glm4-9b shape timed (PERF.md)."""
    return G // next(gc for gc in CTA_HEADS if G % gc == 0)


def decode_splits(B: int, K: int, Sc: int, n_sm: int) -> int:
    """How many splits of the cache each of the B * K (row, head group) CTAs
    gets: enough CTAs for about one wave of `n_sm` SMs, each split whole
    tiles, never more splits than tiles, and 1 when B * K CTAs already fill
    the card."""
    n_tiles = max(1, -(-Sc // TILE))
    if B * K >= n_sm:
        return 1
    want = min(-(-n_sm // (B * K)), n_tiles, MAX_SPLITS)
    per = -(-n_tiles // want)  # tiles per split
    return -(-n_tiles // per)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least n int32 zeros on `device`, kept across calls."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 2 * (0 if c is None else c.numel())), dtype=torch.int32,
                        device=device)
        _COUNTERS[device] = c
    return c


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Sc, K, dh)
    v: torch.Tensor,  # (B, Sc, K, dh)
    kv_pos: torch.Tensor,  # (B, Sc) int32, -1 = empty
    pos: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
    return_lse: bool = False,
):
    """One query token per sequence against its cache; returns (B, H, dh) in
    q's dtype, or with `return_lse` (the output (B, H, dh) f32, its lse (B, H)
    f32)."""
    B, H, dh = q.shape
    Bk, Sc, K, dhk = k.shape
    _build.refuse_grad("decode_attention", q, k, v)  # no backward, in either package
    if not all(t.is_cuda for t in (q, k, v, kv_pos, pos)):
        raise ValueError("decode_attention kernel: tensors must be on the card")
    if k.shape != v.shape or Bk != B or dhk != dh or H % K:
        raise ValueError(
            f"decode_attention kernel: q {tuple(q.shape)} k {tuple(k.shape)}"
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
    kst, vst = (_build.row_strides(t.shape, t.stride()) for t in (k, v))
    # rows read 16 bytes at a time: q by plain loads, k and v by cp.async
    for name, t, st in (("q", q, q.stride()[:2]), ("k", k, kst), ("v", v, vst)):
        _build.check_aligned(f"decode_attention kernel: {name}", t.data_ptr(), st,
                             t.element_size())
    n_hg = head_groups(H // K)
    splits = decode_splits(B, K * n_hg, Sc, _build.sm_count(q.device.index))
    out = torch.empty((B, H, dh), dtype=torch.float32 if return_lse else q.dtype,
                      device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    part = counters = None
    if splits > 1:
        part = torch.empty(B * K * splits * (H // K) * (dh + 2), dtype=torch.float32,
                           device=q.device)
        counters = _counters(q.device, B * K * n_hg)
    lib = _build.library()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        pos.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        B, H, K, n_hg, Sc, splits,
        *q.stride()[:2], *kst, *vst, kv_pos.stride(0),
        *out.stride()[:2], dh, int(window), 1.0 / math.sqrt(dh),
        _build.dtype_code(q, "decode_attention"), _build.stream_of(q),
    )
    _build.check(err, "decode_attention")
    _build.LAUNCHES["decode_attention_lse" if return_lse else "decode_attention"] += 1
    return (out, lse) if return_lse else out
