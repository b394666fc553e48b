"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, sequential) (counterpart of `repro/models/xlstm.py`). [arXiv:2405.04517]

mLSTM cell (per head, value dim Pv, key dim Pk):

    C_t = f_t C_{t-1} + i_t v_t k_t^T        C: (Pv, Pk)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

with an exp input gate, a sigmoid forget gate and a running stabiliser m_t
(starting at -1e30). Prefill runs the chunkwise form (intra-chunk quadratic,
a Python loop carrying (C, n, m) across chunks); decode the plain recurrence.
Padded steps have ipre = -1e30 (no input) and log f = 0 (no decay).

sLSTM is sequential (scalar memories, block-diagonal recurrent gate
matrices): a Python loop over time, then RMSNorm and a GELU-gated FFN of
4/3 d rounded up to a multiple of 128 (`slstm_ffn_dim`).

Plain PyTorch throughout, as the reference is plain jnp; the inner RMSNorms
go through the rmsnorm kernel on the card. Decode updates the states in
place (as the KV cache): xlstm-1.3b's mLSTM C is 42 x 4 x 1024 x 1024 f32,
0.7 GB per batch row.

Under a mesh (`sharding.use_mesh`) the projections are DTensor products on
the weights as their axes place them; each recurrence runs in one
`sharding.run_local` on the local shards, so the host pays DTensor's
dispatch once a block, not once an op or a time step:

  * mLSTM prefill: the chunked scan on each rank's batch rows and heads
    ("inner" on the head count); its output is sharded on "inner", which
    the inner norm gathers (`ops.rmsnorm`).
  * mLSTM decode, on the cache's layout (the reference's axes: C (B, nh,
    P_value, P_key) sharded on its value dim, n (B, nh, P_key) on its key
    dim, m by batch only): C's readout C q sums over the key dim, which
    every rank holds whole, so it comes out sharded on the value dim and
    is gathered; n . q sums over n's sharded key dim, so the core returns
    it as a partial sum, which the readout reduces. Nothing gathers C.
  * sLSTM: the whole time loop (prefill) or step (decode) on each rank's
    batch rows, r_gates replicated.

In training (`Model.loss` under TRAIN_RULES) the mLSTM scan's inputs are
all sharded, so their gradients come back sharded as they went in; the
sLSTM's r_gates, replicated beside sharded rows, gets each rank's rows'
part of its gradient, a partial sum (`sharding.run_local`), and the loop
still reads one `_recurrent_weights` copy, never one a step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import sharding as sh
from ..configs.base import ModelConfig
from ..sharding import constrain
from .common import init_normal_, param, rms_norm
from .mamba2 import _causal_conv, _push, _roll_ctx

__all__ = [
    "MLSTM",
    "SLSTM",
    "init_mlstm",
    "mlstm_forward",
    "mlstm_decode_step",
    "init_mlstm_state",
    "init_slstm",
    "slstm_forward",
    "slstm_decode_step",
    "init_slstm_state",
    "slstm_ffn_dim",
]

NEG_INF = -1e30


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """The reference's leaves: w_up, w_z (d, di), conv (cw, di), wq, wk, wv
    (di, di), w_if (di, 2 nh), b_if (2 nh,), skip and norm (di,), w_down (di, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, di, nh, cw = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.ssm_conv
        self.w_up = param((d, di), ("p_embed", "p_inner"), device, dtype)
        self.w_z = param((d, di), ("p_embed", "p_inner"), device, dtype)
        self.conv = param((cw, di), (None, "p_inner"), device, dtype)
        self.wq = param((di, di), ("p_inner", None), device, dtype)
        self.wk = param((di, di), ("p_inner", None), device, dtype)
        self.wv = param((di, di), ("p_inner", "p_inner"), device, dtype)
        self.w_if = param((di, 2 * nh), ("p_inner", None), device, dtype)
        self.b_if = param((2 * nh,), (None,), device, dtype)
        self.skip = param((di,), ("p_inner",), device, dtype)
        self.norm = param((di,), ("p_inner",), device, dtype)
        self.w_down = param((di, d), ("p_inner", "p_embed"), device, dtype)


def init_mlstm(p: MLSTM, gen: torch.Generator) -> MLSTM:
    for w in (p.w_up, p.w_z, p.wq, p.wk, p.wv, p.w_down):
        init_normal_(w, gen)
    init_normal_(p.conv, gen, scale=0.5)
    init_normal_(p.w_if, gen, scale=0.01)
    p.b_if.zero_()
    p.skip.fill_(1.0)
    p.norm.fill_(1.0)
    return p


def init_mlstm_state(cfg: ModelConfig, batch: int, device, dtype) -> dict:
    nh, P = cfg.n_heads, cfg.d_inner // cfg.n_heads
    cw, di = cfg.ssm_conv, cfg.d_inner
    return {
        "C": torch.zeros((batch, nh, P, P), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, P), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), NEG_INF, dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, di), dtype=dtype, device=device),
    }


def _mlstm_proj(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, conv_prior=None):
    """x (B,S,d) -> q,k,v (B,S,nh,P), gates (B,S,nh) f32, z (B,S,di), raw up, conv out."""
    B, S, _ = x.shape
    nh, P = cfg.n_heads, cfg.d_inner // cfg.n_heads
    up = x @ p.w_up
    z = x @ p.w_z
    c = _causal_conv(up, p.conv, conv_prior)
    q = (c @ p.wq).view(B, S, nh, P)
    k = (c @ p.wk).view(B, S, nh, P) / math.sqrt(P)
    v = (up @ p.wv).view(B, S, nh, P)
    gates = (c @ p.w_if).float() + p.b_if
    return q, k, v, gates[..., :nh], gates[..., nh:], z, up, c


def _mlstm_scan(q, k, v, ipre, fpre, cfg: ModelConfig, chunk: int, prior: dict):
    """The chunkwise scan over the heads given (q, k, v (B, S, nh, P); the
    gates' preactivations (B, S, nh) f32): -> (h (B, S, nh P) in q's dtype,
    C, n, m)."""
    B, S, nh, P = q.shape
    logf = F.logsigmoid(fpre)
    Q = min(chunk, S)
    pad = (-S) % Q

    def padq(a, fill=0.0):  # along the sequence axis
        return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad), value=fill) if pad else a

    Sp = S + pad
    nc = Sp // Q
    qc, kc, vc = (padq(t).view(B, nc, Q, nh, P) for t in (q, k, v))
    ic = padq(ipre, NEG_INF).view(B, nc, Q, nh)
    cum = torch.cumsum(padq(logf, 0.0).view(B, nc, Q, nh), dim=2)  # inclusive log-decay

    # intra-chunk: D_ij = cum_i - cum_j + ipre_j for j <= i
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    D = cum[:, :, :, None, :] - cum[:, :, None, :, :] + ic[:, :, None, :, :]
    D = D.masked_fill(~causal[None, None, :, :, None], NEG_INF)  # (B, nc, i, j, nh)
    m_intra = D.amax(dim=3)  # (B, nc, i, nh)

    C_hat = prior.get("C")
    if C_hat is None:
        C_hat = torch.zeros((B, nh, P, P), dtype=torch.float32, device=q.device)
        n_hat = torch.zeros((B, nh, P), dtype=torch.float32, device=q.device)
        m_prev = torch.full((B, nh), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        n_hat, m_prev = prior["n"], prior["m"]

    hs = torch.empty((B, nc, Q, nh, P), dtype=torch.float32, device=q.device)
    for c in range(nc):  # scaled state: actual = hat * exp(m_prev)
        qx, kx, vx = qc[:, c].float(), kc[:, c].float(), vc[:, c].float()
        Dx, mx, cumx, icx = D[:, c], m_intra[:, c], cum[:, c], ic[:, c]
        m_i = torch.maximum(mx, cumx + m_prev[:, None, :])  # (B, i, nh)
        w_intra = torch.exp(Dx - m_i[:, :, None, :])  # (B, i, j, nh)
        w_inter = torch.exp(cumx + m_prev[:, None, :] - m_i)  # (B, i, nh)
        sq = torch.einsum("bihp,bjhp->bhij", qc[:, c], kc[:, c]).float()
        wq = sq * w_intra.permute(0, 3, 1, 2)  # (B, nh, i, j)
        num = torch.einsum("bhij,bjhp->bihp", wq, vx)
        # C_hat is (B, nh, P_value, P_key): contract q over the KEY dim.
        num = num + torch.einsum("bihk,bhvk->bihv", qx, C_hat) * w_inter[..., None]
        nvec = torch.einsum("bijh,bjhp->bihp", w_intra, kx)
        nvec = nvec + w_inter[..., None] * n_hat[:, None]
        qn = (qx * nvec).sum(-1)  # (B, i, nh)
        denom = torch.maximum(qn.abs(), torch.exp(-m_i))
        hs[:, c] = num / denom[..., None]
        # chunk-end state update
        cum_Q = cumx[:, -1, :]  # (B, nh)
        d_end = cum_Q[:, None, :] - cumx + icx  # (B, j, nh)
        m_end = torch.maximum(cum_Q + m_prev, d_end.amax(dim=1))
        w_end = torch.exp(d_end - m_end[:, None, :])  # (B, j, nh)
        decay = torch.exp(cum_Q + m_prev - m_end)  # (B, nh)
        C_hat = decay[:, :, None, None] * C_hat + torch.einsum(
            "bjhp,bjhr->bhpr", vx * w_end[..., None], kx)
        n_hat = decay[:, :, None] * n_hat + torch.einsum("bjh,bjhp->bhp", w_end, kx)
        m_prev = m_end
    h = hs.view(B, Sp, nh, P)[:, :S].reshape(B, S, nh * P).to(q.dtype).contiguous()
    return h, C_hat, n_hat, m_prev


def _mlstm_out(p: MLSTM, h, conv_out, z, cfg: ModelConfig) -> torch.Tensor:
    """per-head norm, learnable skip (conv path), output gate, down-projection"""
    h = rms_norm(h, p.norm, cfg.norm_eps)
    h = h + p.skip * conv_out
    h = h * F.silu(z)
    out = h @ p.w_down
    return constrain(out, ("batch", "seq", "embed") if out.dim() == 3 else ("batch", "embed"))


def mlstm_forward(
    p: MLSTM,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    chunk: int = 256,
    state: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    prior = state or {}
    q, k, v, ipre, fpre, z, up_raw, conv_out = _mlstm_proj(p, x, cfg, prior.get("conv"))
    if not isinstance(x, DTensor):
        h, C, n, m = _mlstm_scan(q, k, v, ipre, fpre, cfg, chunk, prior)
    else:  # each rank's batch rows and heads ("inner" on the head count)
        pl = sh.placements_of((x.shape[0], cfg.n_heads), ("batch", "inner"))
        bd, hd = sh.dims_sharding(pl, 0), sh.dims_sharding(pl, 1)
        seq, heads = sh.placed({0: bd, 2: hd}), sh.placed({0: bd, 1: hd})
        names = [k for k in ("C", "n", "m") if k in prior]
        h, C, n, m = sh.run_local(
            lambda *a: _mlstm_scan(*a[:5], cfg, chunk, dict(zip(names, a[5:]))),
            (seq, heads, heads, heads), (seq,) * 5 + (heads,) * len(names),
            q, k, v, ipre, fpre, *(prior[k] for k in names))
    out = _mlstm_out(p, h, conv_out, z, cfg)
    new_conv = _roll_ctx(up_raw, prior.get("conv"), cfg.ssm_conv)
    return out, {"C": C, "n": n, "m": m, "conv": new_conv}


def _mlstm_cell(q, q_key, k, k_key, v_value, ipre, fpre, C, n, m):
    """One step of the (C, n, m) recurrence, in place, on the state shards
    given -> (C q (B, nh, P_value shard), n . q (B, nh), summed over the key
    shard only; m's new value). `q_key`/`k_key` are q/k cut as n's key dim
    is, `v_value` v as C's value dim is (whole off a mesh)."""
    logf = F.logsigmoid(fpre)
    m_new = torch.maximum(logf + m, ipre)
    f_eff = torch.exp(logf + m - m_new)
    i_eff = torch.exp(ipre - m_new)
    C.mul_(f_eff[..., None, None]).addcmul_((i_eff[..., None] * v_value)[..., None],
                                            k[..., None, :])
    n.mul_(f_eff[..., None]).add_(i_eff[..., None] * k_key)
    m.copy_(m_new)
    return (C @ q[..., None])[..., 0], (n * q_key).sum(-1), m_new


def _mlstm_readout(num, qn, m_new, dtype):
    """(B, nh, P) numerators, (B, nh) n . q -> h (B, nh P) in `dtype`."""
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    return (num / denom[..., None]).reshape(num.shape[0], -1).to(dtype)


def mlstm_decode_step(
    p: MLSTM, x: torch.Tensor, state: dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, dict]:
    """One token (B, d); `state` is updated in place and returned."""
    q, k, v, ipre, fpre, z, up_raw, conv_out = _mlstm_proj(p, x[:, None, :], cfg,
                                                           state["conv"])
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # (B, nh, P)
    ipre, fpre = ipre[:, 0], fpre[:, 0]  # (B, nh)
    C, n, m = state["C"], state["n"], state["m"]
    if not isinstance(x, DTensor):
        h = _mlstm_readout(*_mlstm_cell(q, q, k, k, v, ipre, fpre, C, n, m), x.dtype)
    else:  # on the cache's layout: C by value dim, n by key dim, m by batch
        pl = sh.placements_of(C.shape, ("kv_batch", None, "inner", None))
        bd, cd = sh.dims_sharding(pl, 0), sh.dims_sharding(pl, 2)
        rows, cut = sh.placed({0: bd}), sh.placed({0: bd, 2: cd})
        summed = [Shard(0) if i in bd else Partial() if i in cd else Replicate()
                  for i in range(len(rows))]
        num, qn, m_new = sh.run_local(
            _mlstm_cell, (cut, summed, rows),
            (rows, cut, rows, cut, cut, rows, rows, cut, cut, rows),
            q, q, k, k, v, ipre, fpre, C, n, m, inplace=(7, 8, 9))
        # the readout on whole rows: C q gathered, n . q summed
        h = sh.run_local(lambda *a: _mlstm_readout(*a, x.dtype), rows, (rows,) * 3,
                         num, qn, m_new)
    out = _mlstm_out(p, h, conv_out[:, 0], z[:, 0], cfg)
    _push(state["conv"], up_raw)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_ffn_dim(cfg: ModelConfig) -> int:
    f = int(cfg.d_model * 4 / 3)
    return ((f + 127) // 128) * 128


class SLSTM(nn.Module):
    """w_gates (d, 4d), b_gates (4d,), block-diagonal r_gates (4, nh, dh, dh),
    norm (d,), the FFN's ffn_w1, ffn_w3 (d, f) and ffn_w2 (f, d)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dh, f = d // nh, slstm_ffn_dim(cfg)
        self.w_gates = param((d, 4 * d), ("p_embed", None), device, dtype)
        self.b_gates = param((4 * d,), (None,), device, dtype)
        self.r_gates = param((4, nh, dh, dh), (None, None, None, None), device, dtype)
        self.norm = param((d,), ("p_embed",), device, dtype)
        self.ffn_w1 = param((d, f), ("p_embed", "p_ffn"), device, dtype)
        self.ffn_w3 = param((d, f), ("p_embed", "p_ffn"), device, dtype)
        self.ffn_w2 = param((f, d), ("p_ffn", "p_embed"), device, dtype)


def init_slstm(p: SLSTM, gen: torch.Generator) -> SLSTM:
    dh = p.r_gates.shape[-1]
    for w in (p.w_gates, p.ffn_w1, p.ffn_w3, p.ffn_w2):
        init_normal_(w, gen)
    init_normal_(p.r_gates, gen, scale=1.0 / math.sqrt(dh))
    p.b_gates.zero_()
    p.norm.fill_(1.0)
    return p


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": torch.full_like(z, NEG_INF)}


def _recurrent_weights(r_gates: torch.Tensor) -> torch.Tensor:
    """r_gates (4, nh, dh, dh) -> (nh, dh, 4 dh) f32, one copy: each head's
    four gate matrices side by side, so that a step's recurrent product is
    one matmul batched over heads that reads the weights in place (a
    product broadcast over the batch would copy them B times a step, and
    autograd would keep every copy: 34 GB over xlstm-1.3b's 512-step
    sLSTM at batch 4)."""
    nh, dh = r_gates.shape[1], r_gates.shape[-1]
    return r_gates.permute(1, 2, 0, 3).to(torch.float32, memory_format=torch.contiguous_format
                                          ).reshape(nh, dh, 4 * dh)


def _slstm_cell(r: torch.Tensor, carry, g_x: torch.Tensor, cfg: ModelConfig):
    """One time step. carry: (h, c, n, m) each (B, d) f32; g_x: (B, 4d)
    input-side gate preactivations; r: `_recurrent_weights` of r_gates."""
    h, c, n, m = carry
    B, d, nh = h.shape[0], cfg.d_model, cfg.n_heads
    dh = d // nh
    rec = torch.bmm(h.view(B, nh, dh).transpose(0, 1), r)  # (nh, B, 4 dh)
    g = g_x.view(B, 4, d).float() + rec.view(nh, B, 4, dh).permute(1, 2, 0, 3).reshape(B, 4, d)
    ipre, fpre, zpre, opre = g.unbind(1)
    logf = F.logsigmoid(fpre)
    m_new = torch.maximum(logf + m, ipre)
    i_eff = torch.exp(ipre - m_new)
    f_eff = torch.exp(logf + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(zpre)
    n_new = f_eff * n + i_eff
    h_new = torch.sigmoid(opre) * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, c_new, n_new, m_new


def _slstm_out(p: SLSTM, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = rms_norm(y, p.norm, cfg.norm_eps)
    out = (_gelu(y @ p.ffn_w1) * (y @ p.ffn_w3)) @ p.ffn_w2  # gated FFN, 4/3 factor
    return constrain(out, ("batch", "seq", "embed"))


def _slstm_scan(r_gates, g_x, cfg: ModelConfig, dtype, *carry):
    """The time loop over g_x (B, S, 4d) from `carry` (h, c, n, m), a fresh
    state when empty -> (y (B, S, d) in `dtype`, h, c, n, m)."""
    B, S = g_x.shape[:2]
    if not carry:
        st = init_slstm_state(cfg, B, g_x.device)
        carry = (st["h"], st["c"], st["n"], st["m"])
    r = _recurrent_weights(r_gates)
    hs = []
    for t in range(S):
        carry = _slstm_cell(r, carry, g_x[:, t], cfg)
        hs.append(carry[0])
    return (torch.stack(hs, dim=1).to(dtype),) + tuple(carry)


def _slstm_rows(B: int, batch_axis: str):
    """(r_gates' placements, the batch rows') under a mesh."""
    rows = sh.placed({0: sh.dims_sharding(sh.placements_of((B,), (batch_axis,)), 0)})
    return [Replicate()] * len(rows), rows


def slstm_forward(
    p: SLSTM,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    state: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    g_x = x @ p.w_gates + p.b_gates
    carry = (state["h"], state["c"], state["n"], state["m"]) if state else ()
    if not isinstance(x, DTensor):
        y, h, c, n, m = _slstm_scan(p.r_gates, g_x, cfg, x.dtype, *carry)
    else:  # the whole loop on each rank's batch rows
        rep, rows = _slstm_rows(x.shape[0], "batch")
        y, h, c, n, m = sh.run_local(
            lambda r, g, *st: _slstm_scan(r, g, cfg, x.dtype, *st), (rows,) * 5,
            (rep, rows) + (rows,) * len(carry), p.r_gates, g_x, *carry)
    return _slstm_out(p, y, cfg), {"h": h, "c": c, "n": n, "m": m}


def _slstm_step(r_gates, g_x, cfg: ModelConfig, dtype, *carry):
    """One step from the state `carry` (h, c, n, m), updated in place -> h in `dtype`."""
    new = _slstm_cell(_recurrent_weights(r_gates), carry, g_x, cfg)
    for old, v in zip(carry, new):
        old.copy_(v)
    return new[0].to(dtype)


def slstm_decode_step(
    p: SLSTM, x: torch.Tensor, state: dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, dict]:
    """One token (B, d); `state` is updated in place and returned."""
    g_x = x @ p.w_gates + p.b_gates
    carry = (state["h"], state["c"], state["n"], state["m"])
    if not isinstance(x, DTensor):
        h = _slstm_step(p.r_gates, g_x, cfg, x.dtype, *carry)
    else:  # on each rank's batch rows, the state's
        rep, rows = _slstm_rows(x.shape[0], "kv_batch")
        h = sh.run_local(lambda r, g, *st: _slstm_step(r, g, cfg, x.dtype, *st), rows,
                         (rep, rows) + (rows,) * 4, p.r_gates, g_x, *carry,
                         inplace=(2, 3, 4, 5))
    return _slstm_out(p, h[:, None], cfg)[:, 0], state
