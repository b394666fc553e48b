"""RMSNorm on the card: wrapper over `csrc/rmsnorm.cu`.

Replaces the Pallas kernel `repro/kernels/rmsnorm.py:rmsnorm`; the plain
version is `ref.rmsnorm`. Bytes-bound: one read and one write per row.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) on the card, its rows a view of one stride (a slice such
    as x[:, -1] is fine); gamma (d,) of x's dtype or f32. Returns a
    contiguous tensor of x's shape and dtype."""
    if not (x.is_cuda and gamma.is_cuda):
        raise ValueError("rmsnorm kernel: tensors must be on the card")
    d = x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"rmsnorm kernel: gamma {tuple(gamma.shape)} for d={d}")
    if x.stride(-1) != 1 or not gamma.is_contiguous():
        raise ValueError("rmsnorm kernel: the d axis and gamma must be contiguous")
    rows = x.view(-1, d)  # raises where the rows are not one stride apart
    if gamma.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rmsnorm kernel: gamma {gamma.dtype} with x {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = lib.rmsnorm_fwd(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows.shape[0], d,
        rows.stride(0), float(eps), _build.dtype_code(x, "rmsnorm"),
        _build.dtype_code(gamma, "rmsnorm"), _build.stream_of(x),
    )
    _build.check(err, "rmsnorm")
    _build.LAUNCHES["rmsnorm"] += 1
    return out
