"""Gated feed-forward block (counterpart of `repro/models/mlp.py`).

The port runs the gated (SiLU/GELU) form: w1, w3 (d, f) and w2 (f, d).
The matmuls stay `torch.matmul`, as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import activation_fn, init_normal_, param

__all__ = ["MLP", "init_mlp", "mlp_forward"]


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.activation not in ("silu", "gelu"):
            raise NotImplementedError(f"{cfg.activation} MLP is not ported yet")
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = param((d, f), device, dtype)
        self.w2 = param((f, d), device, dtype)
        self.w3 = param((d, f), device, dtype)


def init_mlp(p: MLP, gen: torch.Generator) -> MLP:
    for w in (p.w1, p.w2, p.w3):
        init_normal_(w, gen)
    return p


def mlp_forward(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = act(x @ p.w1) * (x @ p.w3)
    return h @ p.w2
