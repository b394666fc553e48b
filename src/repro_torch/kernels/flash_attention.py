"""Prefill flash attention on the card: wrapper over `csrc/flash_attention.cu`.

Replaces the Pallas kernel `repro/kernels/flash_attention.py:flash_attention`;
the plain version is `ref.flash_attention`. The kernel reads q, k, v and
writes o through strides, so callers pass the model layout as it is.

The dtype picks the kernel: bf16 and f16 take the tensor-core kernel (TMA
loads, wgmma), f32 the FMA kernel. The tensor-core kernel's TMA maps need
16-byte aligned base pointers and strides (`_build.check_aligned`); anything
else raises rather than take another kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "HEAD_DIMS", "TMA_DTYPES"]

HEAD_DIMS = (16, 32, 64, 112, 128)  # dh values the kernels are instantiated for
TMA_DTYPES = (torch.bfloat16, torch.float16)  # dtypes of the tensor-core kernel


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dh)
    *,
    causal: bool = True,
    window: int = 0,
    kv_len: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention over arange positions, query row i at position `q_offset`
    + i (one rank's block of rows under context parallelism); returns (B,
    Sq, H, dh), q's dtype."""
    B, Sq, H, dh = q.shape
    Bk, Sk, K, dhk = k.shape
    _build.refuse_grad("flash_attention", q, k, v)  # no backward, in either package
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel: tensors must be on the card")
    if k.shape != v.shape or Bk != B or dhk != dh or H % K:
        raise ValueError(
            f"flash_attention kernel: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention kernel: q, k, v dtypes differ")
    if q_offset < 0:
        raise ValueError(f"flash_attention kernel: q_offset {q_offset} < 0")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: dh={dh} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention kernel: the dh axis must be contiguous")
    strides = [_build.row_strides(t.shape, t.stride()) for t in (q, k, v)]
    if q.dtype in TMA_DTYPES:  # the tensor-core kernel's TMA maps
        for name, t, st in zip("qkv", (q, k, v), strides):
            _build.check_aligned(f"flash_attention kernel: {name}", t.data_ptr(), st,
                                 t.element_size())
    kv_len = Sk if kv_len is None else min(int(kv_len), Sk)
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    lib = _build.library()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, K, Sq, Sk, *strides[0], *strides[1], *strides[2], *out.stride()[:3],
        dh, int(causal), int(window), kv_len, int(q_offset), 1.0 / math.sqrt(dh),
        _build.dtype_code(q, "flash_attention"), _build.stream_of(q),
    )
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
