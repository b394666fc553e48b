"""Feed-forward blocks (counterpart of `repro/models/mlp.py`): gated
(SiLU/GELU: w1, w3 (d, f) and w2 (f, d)) and two-matrix squared-ReLU
(Nemotron-4: w1 and w2, no w3). The matmuls stay `torch.matmul`, as the
reference leaves them to XLA. Under context parallelism
(`RuntimeFlags.attn_seq_shard`) the dense block's products run on each
rank's query rows, the rows its attention core computed.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import sharding as sh
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


def mlp_forward(p: MLP, x: torch.Tensor, cfg: ModelConfig,
                seq_shard: bool = False) -> torch.Tensor:
    """With `seq_shard` (context parallelism) under a mesh, the three
    products run on the query rows the attention core took (`_rows_local`);
    the result leaves through the reference's own constraint."""
    if seq_shard and isinstance(x, DTensor) and x.dim() == 3:
        return constrain(_rows_local(p, x, cfg), ("batch", "seq_res", "embed"))
    h = activation_fn(cfg.activation)(x @ p.w1)
    if p.w3 is not None:
        h = h * (x @ p.w3)
    h = constrain(h, ("batch", "seq", "ffn") if x.dim() == 3 else ("batch", "ffn"))
    y = h @ p.w2
    return constrain(y, ("batch", "seq_res", "embed") if x.dim() == 3 else ("batch", "embed"))


def _rows_local(p: MLP, x: DTensor, cfg: ModelConfig) -> DTensor:
    """The MLP's products in one `run_local`, mesh dim by mesh dim: one that
    shards the weights' ffn dim keeps them so, with x whole, and the result
    is a partial sum (tensor parallelism, as without the flag); one that
    "attn_q_seq" takes, where x is replicated or cut by rows, cuts x's rows
    there (a replicated x locally: nothing moves) and the result keeps
    them, the weights whole; on any other the weights are whole (their FSDP
    shards gathered) and the result is placed as x's rows (batch)."""
    rows = sh.dims_sharding(sh.placements_of(x.shape, ("batch", "attn_q_seq", None)), 1)
    ffn_in, ffn_out, seq = Shard(1), Shard(0), Shard(1)
    x_pl, w_pl, w2_pl, y_pl = [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, p.w1.placements)):
        if wp == ffn_in:
            x_pl.append(Replicate()), w_pl.append(ffn_in), w2_pl.append(ffn_out)
            y_pl.append(Partial())
        elif i in rows and xp in (Replicate(), seq):
            x_pl.append(seq), w_pl.append(Replicate()), w2_pl.append(Replicate())
            y_pl.append(seq)
        else:
            keep = xp if isinstance(xp, Shard) and xp.dim < x.dim() - 1 else Replicate()
            x_pl.append(keep), w_pl.append(Replicate()), w2_pl.append(Replicate())
            y_pl.append(keep)
    act = activation_fn(cfg.activation)

    def products(xl, w1, w2, *w3):
        h = act(xl @ w1)
        if w3:
            h = h * (xl @ w3[0])
        return h @ w2

    gated = () if p.w3 is None else (p.w3,)
    return sh.run_local(products, y_pl, (x_pl, w_pl, w2_pl) + (w_pl,) * len(gated),
                        x, p.w1, p.w2, *gated)
