"""Dispatch over the hand-written kernels (counterpart of `repro/kernels/ops.py`).

A CUDA tensor goes to its kernel, which launches or raises; a CPU tensor
goes to the plain version in `ref`. Nothing falls back from the card to the
plain path. `LAUNCHES` counts kernel launches per kernel.

`rmsnorm` is differentiable: `RMSNormFn` runs the forward kernel and, for
the gradient, the backward kernel (the plain versions on the CPU, through
the same Function). The attention kernels have no backward, in this package
or the reference: their raw wrappers raise on inputs that require grad, and
training takes the naive or chunked attention (`RuntimeFlags.attn_impl_for`).
"""

from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .rmsnorm import rmsnorm_bwd as _rmsnorm_bwd_kernel

__all__ = ["LAUNCHES", "reset_launches", "flash_attention", "decode_attention", "rmsnorm",
           "RMSNormFn"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(
    q: torch.Tensor,  # (B, Sq, K, G, dh) — model-layer layout
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention over arange positions (the kernel's only position layout)."""
    B, Sq, K, G, dh = q.shape
    qh = q.view(B, Sq, K * G, dh)  # a view: raises rather than copy
    if q.is_cuda:
        out = _flash_kernel(qh, k, v, causal=causal, window=window)
    else:
        out = ref.flash_attention(qh, k, v, causal=causal, window=window)
    return out.view(B, Sq, K, G, dh)


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Sc, K, dh)
    v: torch.Tensor,
    kv_pos: torch.Tensor,  # (B, Sc) int32
    pos: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    if q.is_cuda:
        return _decode_kernel(q, k, v, kv_pos, pos, window=window)
    return ref.decode_attention(q, k, v, kv_pos, pos, window=window)


class RMSNormFn(torch.autograd.Function):
    """rmsnorm with its gradient: the forward and backward kernels on the
    card, `ref.rmsnorm` and `ref.rmsnorm_bwd` on the CPU. Saves x and gamma
    only; the backward recomputes the row scale."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if x.is_cuda:
            return _rmsnorm_kernel(x, gamma, eps)
        return ref.rmsnorm(x, gamma, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, gamma = ctx.saved_tensors
        bwd = _rmsnorm_bwd_kernel if x.is_cuda else ref.rmsnorm_bwd
        dx, dgamma = bwd(x, gamma, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dgamma if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return RMSNormFn.apply(x, gamma, eps)
