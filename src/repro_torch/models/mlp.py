"""Feed-forward blocks (counterpart of `repro/models/mlp.py`): gated
(SiLU/GELU: w1, w3 (d, f) and w2 (f, d)) and two-matrix squared-ReLU
(Nemotron-4: w1 and w2, no w3). The matmuls stay `torch.matmul`, as the
reference leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..sharding import constrain
from .common import activation_fn, init_normal_, param

__all__ = ["MLP", "init_mlp", "mlp_forward"]


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = param((d, f), ("p_embed", "p_ffn"), device, dtype)
        self.w2 = param((f, d), ("p_ffn", "p_embed"), device, dtype)
        self.w3 = (param((d, f), ("p_embed", "p_ffn"), device, dtype)
                   if cfg.activation in ("silu", "gelu") else None)


def init_mlp(p: MLP, gen: torch.Generator) -> MLP:
    for w in (p.w1, p.w2, p.w3):
        if w is not None:
            init_normal_(w, gen)
    return p


def mlp_forward(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = activation_fn(cfg.activation)(x @ p.w1)
    if p.w3 is not None:
        h = h * (x @ p.w3)
    h = constrain(h, ("batch", "seq", "ffn") if x.dim() == 3 else ("batch", "ffn"))
    y = h @ p.w2
    return constrain(y, ("batch", "seq_res", "embed") if x.dim() == 3 else ("batch", "embed"))
