"""Mixture-of-experts MLP with capacity-based top-k dispatch (counterpart of
`repro/models/moe.py`).

Mixtral-8x22B: 8 experts top-2; Llama-4-Scout: 16 experts top-1.

Dispatch works per batch row. Each token picks its top-k experts; its place
in an expert's buffer is a cumulative sum over the token-major (token, k)
picks, and picks beyond the capacity C = ceil8(S*k/E * capacity_factor) are
dropped (the token passes on the residual). dispatch="scatter" moves tokens
into (B, E, C, d) buffers and back by indexing; dispatch="einsum" is the
Mesh-TF one-hot form over the combine tensor (B, S, E, C).

The expert products are `torch.bmm` over the fixed-shape buffers, as the
reference leaves its einsums to XLA: every expert's weights are read on
every call, however few tokens picked it, and nothing reads a routing
result back to the host, so a step needs no device-to-host sync.

Router aux outputs: the Switch-style load-balancing loss and the router
z-loss. Under a mesh each rank takes its rows' share of their batch means,
the shares are summed over the ranks, and the load-balancing product is
taken of the whole batch's means (a mean of per-rank products would be
another number).

Under a mesh (`sharding.use_mesh`) the routing, `_dispatch` and `_combine`
run on each rank's batch rows (`sharding.run_local`), which is what the
reference's per-row `vmap` asks of GSPMD: the data movement stays local to
the batch shard. The router is replicated; the expert products run as
DTensor `bmm`s on the weights as their axes place them (PREFILL/DECODE
rules: "experts" replicated, "ffn" over "model"), so `w2`'s product is a
partial sum that `_combine`, linear in it, carries to the output's
constraint. The reference's five `constrain` sites are kept; the port's
expert hidden is (E, B*C, f), so its ("batch", "experts", None, "ffn")
reads ("experts", "batch", "ffn") here. In training the router's gradient
(and the combine's gate weights', against `w2`'s partial sum) is each
rank's rows' part, a partial sum (`sharding.run_local`); the expert
weights' gradients come out of DTensor's `bmm`s placed as `p_experts` and
`p_ffn` place the weights.
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import sharding as sh
from ..configs.base import ModelConfig
from ..sharding import constrain
from .common import activation_fn, init_normal_, param

__all__ = ["MoE", "init_moe", "moe_forward", "expert_capacity"]


def expert_capacity(cfg: ModelConfig, seq: int) -> int:
    cap = int(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)  # the reference pads to 8 for its tiling


class MoE(nn.Module):
    """router (d, E); w1, w3 (E, d, f) and w2 (E, f, d); w3 only for gated
    activations."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param((d, E), ("p_embed", None), device, dtype)
        self.w1 = param((E, d, f), ("p_experts", "p_embed", "p_ffn"), device, dtype)
        self.w2 = param((E, f, d), ("p_experts", "p_ffn", "p_embed"), device, dtype)
        self.w3 = (param((E, d, f), ("p_experts", "p_embed", "p_ffn"), device, dtype)
                   if cfg.activation in ("silu", "gelu") else None)


def init_moe(p: MoE, gen: torch.Generator) -> MoE:
    """The reference's scales: 1/sqrt(d) for the router, 1/sqrt(E) (its
    leading dim) for the expert weights."""
    for w in (p.router, p.w1, p.w2, p.w3):
        if w is not None:
            init_normal_(w, gen)
    return p


def _route(p: MoE, x: torch.Tensor, cfg: ModelConfig, C: int):
    """Top-k routing and capacity positions. Returns (gate_w, gate_idx,
    pos_sel, keep_k) of shape (B, S, k), (sel, keep) of (B, S, k, E) and
    (probs, logits) of (B, S, E), as the reference's `_route`. `p` needs
    only its `router`."""
    E, k = cfg.n_experts, cfg.top_k
    B, S, _ = x.shape
    logits = (x @ p.router).float()  # in x's dtype, then f32, as the reference
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first on ties, so does a stable
    # descending sort; torch.topk promises no order
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[..., :k], gate_idx[..., :k]
    if k > 1:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = (gate_idx[..., None] == torch.arange(E, device=x.device)).to(torch.int32)
    pos = (sel.view(B, S * k, E).cumsum(1) - 1).view(B, S, k, E)  # token-major
    keep = (pos < C) & (sel > 0)
    pos_sel = (pos * sel).sum(-1)
    keep_k = keep.any(-1)
    return gate_w, gate_idx, pos_sel, keep_k, sel, keep, probs, logits


def _experts(p: MoE, xe: torch.Tensor, act) -> torch.Tensor:
    """(B, E, C, d) -> (B, E, C, d): each expert's MLP over its buffer rows."""
    B, E, C, d = xe.shape
    xf = xe.transpose(0, 1).reshape(E, B * C, d)
    h = act(torch.bmm(xf, p.w1))
    if p.w3 is not None:
        h = h * torch.bmm(xf, p.w3)
    h = constrain(h, ("experts", "batch", "ffn"))  # the reference's (B, E, C, f) site
    return torch.bmm(h, p.w2).view(E, B, C, d).transpose(0, 1)


def _dispatch(x: torch.Tensor, gate_idx, pos_sel, keep_k, E: int, C: int):
    """Scatter tokens into (B, E, C, d) expert buffers. Dropped picks go to
    an extra row E that is cut off; kept picks have distinct (e, c) slots.
    Returns the buffers and the (expert, slot) of every pick."""
    B, S, k = gate_idx.shape
    d = x.shape[-1]
    e_idx = torch.where(keep_k, gate_idx, E)
    c_idx = torch.where(keep_k, pos_sel, 0)
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    buf = x.new_zeros(B, E + 1, C, d)
    buf[b_idx, e_idx, c_idx] = x[:, :, None, :].expand(B, S, k, d)
    return buf[:, :E], e_idx, c_idx


def _combine(ye: torch.Tensor, e_idx, c_idx, gate_w, keep_k) -> torch.Tensor:
    """Gather each pick's expert output and sum the picks by gate weight;
    a dropped pick has weight 0 (its index is clamped to a real row)."""
    B, E = ye.shape[:2]
    b_idx = torch.arange(B, device=ye.device)[:, None, None]
    yk = ye[b_idx, e_idx.clamp_max(E - 1), c_idx]  # (B, S, k, d)
    w = gate_w.to(ye.dtype) * keep_k.to(ye.dtype)
    return torch.einsum("bskd,bsk->bsd", yk, w)


def _einsum_combine(gate_w, pos_sel, keep_k, sel, keep, C: int, dtype) -> torch.Tensor:
    """The Mesh-TF combine tensor (B, S, E, C): each kept pick's gate weight
    at its (expert, slot)."""
    e_oh = (sel * keep).to(dtype) * gate_w[..., None].to(dtype)
    slot = torch.where(keep_k, pos_sel, C)  # C: no slot, an all-zero one-hot row
    c_oh = (slot[..., None] == torch.arange(C, device=slot.device)).to(dtype)
    return torch.einsum("bske,bskc->bsec", e_oh, c_oh)


_Router = collections.namedtuple("_Router", "router")  # a rank's local router for `_route`


def _rows(x: torch.Tensor):
    """Under a mesh, the placements of x's batch rows: sharded as "batch"
    resolves, every other dim replicated (one list serves every tensor
    with the batch first); None off a mesh."""
    if not isinstance(x, DTensor):
        return None
    return sh.placements_of(x.shape, ("batch",) + (None,) * (x.dim() - 1))


def moe_forward(
    p: MoE, x: torch.Tensor, cfg: ModelConfig, dispatch: str = "scatter",
    aux: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d), aux losses). aux=False skips the aux
    losses and returns {} (prefill and decode discard them; the reference's
    jit drops them there unevaluated). Under a mesh the aux losses are
    replicated DTensors of the whole batch's means (`_aux_means`)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, S)
    act = activation_fn(cfg.activation)
    rows = _rows(x)
    if rows is None:
        gate_w, gate_idx, pos_sel, keep_k, sel, keep, probs, logits = _route(p, x, cfg, C)
    else:  # each rank routes its batch rows
        rep = [Replicate()] * len(rows)
        gate_w, gate_idx, pos_sel, keep_k, sel, keep, probs, logits = sh.run_local(
            lambda r, xl: _route(_Router(r), xl, cfg, C), (rows,) * 8, (rep, rows), p.router, x)

    if dispatch == "scatter":
        if rows is None:
            xe, e_idx, c_idx = _dispatch(x, gate_idx, pos_sel, keep_k, E, C)
        else:
            xe, e_idx, c_idx = sh.run_local(lambda *a: _dispatch(*a, E, C), (rows,) * 3,
                                            (rows,) * 4, x, gate_idx, pos_sel, keep_k)
        xe = constrain(xe, ("batch", "experts", None, "embed"))
        ye = _experts(p, xe, act)
        if rows is None:
            out = _combine(ye, e_idx, c_idx, gate_w, keep_k)
        else:  # linear in ye: a partial sum over "model" stays one
            ye_pl = [q if isinstance(q, Partial) else r for q, r in zip(ye.placements, rows)]
            out = sh.run_local(_combine, ye_pl, (ye_pl,) + (rows,) * 4,
                               ye, e_idx, c_idx, gate_w, keep_k)
    elif dispatch == "einsum":
        if rows is None:
            combine = _einsum_combine(gate_w, pos_sel, keep_k, sel, keep, C, x.dtype)
        else:
            combine = sh.run_local(
                lambda *a: _einsum_combine(*a, C, x.dtype), rows, (rows,) * 5,
                gate_w, pos_sel, keep_k, sel, keep)
        combine = constrain(combine, ("batch", "seq", "experts", None))
        disp = (combine > 0).to(x.dtype)
        xe = constrain(torch.einsum("bsec,bsd->becd", disp, x),
                       ("batch", "experts", None, "embed"))
        ye = _experts(p, xe, act)
        out = torch.einsum("bsec,becd->bsd", combine, ye)
    else:
        raise ValueError(dispatch)
    out = constrain(out, ("batch", "seq_res", "embed"))
    if not aux:
        return out, {}
    if rows is None:
        frac_tokens, frac_prob, z_loss = _aux_means(sel, probs, logits, k)
    else:  # each rank's share of the batch means, summed over the ranks
        part = [Partial() if r == Shard(0) else Replicate() for r in rows]
        shares = sh.run_local(lambda *a: _aux_means(*a, k, a[0].shape[0] / B), (part,) * 3,
                              (rows,) * 3, sel, probs, logits)
        frac_tokens, frac_prob, z_loss = (sh.redistribute(t, [Replicate()] * len(rows))
                                          for t in shares)
    lb_loss = E * (frac_tokens * frac_prob).sum()
    return out, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _aux_means(sel, probs, logits, k: int, share: float = 1.0):
    """The router losses' batch means over the rows given, times `share`,
    their part of the whole batch (1 off a mesh): (the share of picks each
    expert got (E,), its mean router probability (E,), the mean squared
    logsumexp of the router logits). Each of the k picks counts 1/k, so a
    balanced router's load-balancing loss E sum(frac_tokens frac_prob) is
    exactly 1. The product is taken of the whole batch's means, after the
    ranks' shares are summed."""
    means = (sel.float().sum(2).mean((0, 1)) / k, probs.mean((0, 1)),
             torch.logsumexp(logits, dim=-1).square().mean())
    return means if share == 1 else tuple(m * share for m in means)
