"""Rotary position embeddings (counterpart of `repro/models/rope.py`).

Split-half rotation with f32 angles, as the reference: the first and second
halves of the head dim form the (x1, x2) pairs. The angle tables depend on
positions only, so the stack builds them once per forward (`rope_tables`)
and every layer rotates with them (`rotate`); XLA makes the same hoist for
the reference. M-RoPE is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rope_freqs", "rope_tables", "rotate", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, exps)  # a Python base: no host-to-device copy


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> f32 (cos, sin) tables (B, S, 1, D), laid out for
    `rotate`: cos = [cos, cos], sin = [-sin, sin] over the two halves."""
    inv = rope_freqs(head_dim, theta, positions.device)  # (D/2,)
    angles = positions[..., None, None].float() * inv  # (B, S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x (B, S, H, D): [x1 cos - x2 sin, x2 cos + x1 sin] in f32, cast back."""
    cos, sin = tables
    xf = x.float()
    swapped = torch.roll(xf, xf.shape[-1] // 2, dims=-1)  # [x2, x1]
    return (xf * cos + swapped * sin).to(x.dtype)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, head_dim: int, theta: float
) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    return rotate(x, rope_tables(positions, head_dim, theta))
