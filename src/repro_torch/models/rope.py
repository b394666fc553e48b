"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE
(counterpart of `repro/models/rope.py`).

Split-half rotation with f32 angles, as the reference: the first and second
halves of the head dim form the (x1, x2) pairs. The angle tables depend on
positions only, so the stack builds them once per forward (`rope_tables`,
`mrope_tables`) and every layer rotates with them (`rotate`); XLA makes the
same hoist for the reference.

M-RoPE splits the head_dim/2 frequency bands into sections driven by
(temporal, height, width) position streams; text tokens carry identical
(t, h, w), so M-RoPE degrades to RoPE for pure text. [arXiv:2409.12191]
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..sharding import replicated_like

__all__ = [
    "rope_freqs",
    "rope_tables",
    "mrope_tables",
    "rotate",
    "apply_rope",
    "apply_mrope",
    "text_mrope_positions",
]


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
    # (D/2,), replicated on positions' mesh when they are a DTensor
    inv = replicated_like(positions, rope_freqs(head_dim, theta, positions.device))
    return _tables(positions[..., None, None].float() * inv)  # angles (B, S, 1, D/2)


def mrope_tables(
    positions3: torch.Tensor, head_dim: int, theta: float, sections: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE tables: positions3 (3, B, S) t/h/w streams, `sections` (summing
    to head_dim/2) the number of frequency bands each stream drives."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to {half}")
    inv = replicated_like(positions3, rope_freqs(head_dim, theta, positions3.device))
    # (B, S, D/2): each band's driving stream, stream i repeated over its
    # sections[i] bands (slices and a cat: no index tensor built on the
    # host, which would have to be put on the mesh)
    pos = torch.cat([positions3[i].float()[..., None].expand(*positions3.shape[1:], n)
                     for i, n in enumerate(sections)], -1)
    return _tables(pos[..., None, :] * inv)  # angles (B, S, 1, D/2)


def _tables(angles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x (B, S, H, D): [x1 cos - x2 sin, x2 cos + x1 sin] in f32, cast back."""
    cos, sin = tables
    xf = x.float()
    h = xf.shape[-1] // 2
    swapped = torch.cat([xf[..., h:], xf[..., :h]], -1)  # [x2, x1] (DTensor has no roll)
    return (xf * cos + swapped * sin).to(x.dtype)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, head_dim: int, theta: float
) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    return rotate(x, rope_tables(positions, head_dim, theta))


def apply_mrope(
    x: torch.Tensor,
    positions3: torch.Tensor,  # (3, B, S)
    head_dim: int,
    theta: float,
    sections: Sequence[int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE on x (B, S, H, D)."""
    return rotate(x, mrope_tables(positions3, head_dim, theta, sections))


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (3, B, S): text tokens share t = h = w = pos."""
    return positions[None].expand(3, *positions.shape)
