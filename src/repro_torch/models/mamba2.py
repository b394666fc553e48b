"""Mamba2 (SSD) mixer (counterpart of `repro/models/mamba2.py`): the chunked
parallel scan for prefill, the O(1)-state recurrence for decode.
[arXiv:2405.21060, as used by Zamba2's backbone]

Per head h with state size N and head dim P:

    h_t = a_t * h_{t-1} + B_t (dt_t x_t)^T        h: (P, N)
    y_t = h_t C_t + D * x_t                        a_t = exp(-exp(A_log) dt_t)

The chunked ("SSD") form splits the sequence into chunks of Q steps: inside
a chunk a masked quadratic form (decay L_ij = exp(cum_i - cum_j)), across
chunks a (P, N) f32 state carried by a Python loop over the chunks (the
reference's `lax.scan`). x, B and C pass through a short causal depthwise
conv whose rolling (cw - 1)-sample context is part of the decode state.

Plain PyTorch throughout, as the reference is plain jnp: no Pallas kernel
lies on this path, only the inner RMSNorm, which goes through the rmsnorm
kernel on the card. The dtype casts follow the reference's: u and the
intra-chunk weights are rounded to the input dtype before their einsum, the
carry and the inter-chunk term stay f32.

Decode updates the state in place (as the KV cache): at zamba2-7b's full
width a batch of 8 holds 1.2 GB of `h`, and a functional copy would move
that much again every step.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from .. import sharding as sh
from ..configs.base import ModelConfig
from ..sharding import constrain
from .common import init_normal_, param, rms_norm

__all__ = ["Mamba2", "init_mamba2", "mamba2_forward", "mamba2_decode_step",
           "init_mamba_state", "_causal_conv"]


class Mamba2(nn.Module):
    """The reference's leaves: projections w_x, w_z (d, di), w_B, w_C (d, N),
    w_dt (d, nh), w_out (di, d); per-head dt_bias, A_log, D (nh,); conv
    kernels conv_x (cw, di), conv_B, conv_C (cw, N); the inner norm (di,)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, cw = cfg.n_ssm_heads, cfg.ssm_conv
        self.w_x = param((d, di), ("p_embed", "p_inner"), device, dtype)
        self.w_z = param((d, di), ("p_embed", "p_inner"), device, dtype)
        self.w_B = param((d, N), ("p_embed", None), device, dtype)
        self.w_C = param((d, N), ("p_embed", None), device, dtype)
        self.w_dt = param((d, nh), ("p_embed", "p_inner"), device, dtype)
        self.dt_bias = param((nh,), ("p_inner",), device, dtype)
        self.A_log = param((nh,), ("p_inner",), device, dtype)
        self.D = param((nh,), ("p_inner",), device, dtype)
        self.conv_x = param((cw, di), (None, "p_inner"), device, dtype)
        self.conv_B = param((cw, N), (None, None), device, dtype)
        self.conv_C = param((cw, N), (None, None), device, dtype)
        self.norm = param((di,), ("p_inner",), device, dtype)
        self.w_out = param((di, d), ("p_inner", "p_embed"), device, dtype)


def init_mamba2(p: Mamba2, gen: torch.Generator) -> Mamba2:
    """The reference's scales: fan-in for the projections, 0.5 for the conv
    kernels, dt_bias and A_log zeros, D and the norm ones."""
    for w in (p.w_x, p.w_z, p.w_B, p.w_C, p.w_dt, p.w_out):
        init_normal_(w, gen)
    for w in (p.conv_x, p.conv_B, p.conv_C):
        init_normal_(w, gen, scale=0.5)
    p.dt_bias.zero_()
    p.A_log.zero_()
    p.D.fill_(1.0)
    p.norm.fill_(1.0)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv + SiLU. x: (B, S, D), w: (W, D); prior:
    (B, W-1, D) rolling context from previous tokens (zeros if None)."""
    W, S = w.shape[0], x.shape[1]
    if prior is None:
        prior = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([prior, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out)


def _gates(p, x: torch.Tensor):
    """Raw (pre-conv) projections: xi/z (..., di), B/C (..., N), dt (..., nh) f32."""
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias)
    return x @ p.w_x, x @ p.w_z, x @ p.w_B, x @ p.w_C, dt


# The leaves the core reads (all but the inner norm and w_out), and the dim of
# each that the heads shard under a mesh (None: replicated): xi's inner
# ("batch", "seq", "inner") is a whole number of heads
_CORE = ("w_x", "w_z", "w_B", "w_C", "w_dt", "dt_bias", "A_log", "D", "conv_x", "conv_B",
         "conv_C")
_CORE_HEAD_DIM = (1, 1, None, None, 1, 0, 0, 0, 1, None, None)
_STATE = ("h", "conv_x", "conv_B", "conv_C")
_STATE_HEAD_DIM = (1, 2, None, None)  # h (B, nh, P, N), conv_x (B, cw-1, di)
_Core = collections.namedtuple("_Core", _CORE)


def init_mamba_state(cfg: ModelConfig, batch: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Zeroed state: h (B, nh, P, N) f32 and the conv contexts (B, cw-1, ...)."""
    nh, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cw, di = cfg.ssm_conv, cfg.d_inner
    return {
        "h": torch.zeros((batch, nh, P, N), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cw - 1, di), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, cw - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, cw - 1, N), dtype=dtype, device=device),
    }


def _roll_ctx(raw: torch.Tensor, prev: Optional[torch.Tensor], cw: int) -> torch.Tensor:
    """The last cw - 1 raw inputs, the previous context in front."""
    if prev is None:
        prev = raw.new_zeros((raw.shape[0], cw - 1, raw.shape[-1]))
    return torch.cat([prev, raw], dim=1)[:, -(cw - 1):].contiguous()


def _ssd(p, x: torch.Tensor, cfg: ModelConfig, chunk: int, prior: dict):
    """The chunked scan over the heads `p` holds (nh = p.D's length): ->
    (y * silu(z) (B, S, nh P), final state). Runs whole off a mesh and on
    each rank's local heads and batch rows under one."""
    B, S, _ = x.shape
    nh, P, N = p.D.shape[0], cfg.ssm_head_dim, cfg.ssm_state
    cw = cfg.ssm_conv
    Q = min(chunk, S)
    pad = (-S) % Q

    xi_raw, z, B_raw, C_raw, dt = _gates(p, x)
    xi = _causal_conv(xi_raw, p.conv_x, prior.get("conv_x"))
    Bp = _causal_conv(B_raw, p.conv_B, prior.get("conv_B"))
    Cp = _causal_conv(C_raw, p.conv_C, prior.get("conv_C"))

    # padded steps: dt = 0, so a_log = 0 and the carried state does not decay
    xi_p, Bp, Cp, dt_p = (F.pad(t, (0, 0, 0, pad)) for t in (xi, Bp, Cp, dt))
    nc = (S + pad) // Q

    xh = xi_p.view(B, nc, Q, nh, P)
    u = (xh.float() * dt_p.view(B, nc, Q, nh, 1)).to(x.dtype)
    Bc = Bp.view(B, nc, Q, N)
    Cc = Cp.view(B, nc, Q, N)
    a_log = -torch.exp(p.A_log.float()) * dt_p  # (B, Sp, nh) <= 0
    cum = torch.cumsum(a_log.view(B, nc, Q, nh), dim=2)  # inclusive log-decay prefix

    # Intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) u_j. The
    # exponent is masked to -inf above the diagonal before exp: there it is a
    # positive sum of dt, which overflows past ~88, and an inf there would
    # make the product's gradient 0 * inf = NaN even with the product masked.
    sBC = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B, nc, Q, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, nh)
    decay = torch.exp(seg.masked_fill(~causal[..., None], -math.inf))
    G = sBC[..., None] * decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", G.to(x.dtype), u)

    # Cross-chunk carry: state (B, nh, P, N) f32.
    chunk_decay = torch.exp(cum[:, :, -1:, :] - cum)  # decay j -> chunk end
    state_in = torch.einsum("bcjn,bcjhp->bchpn", Bc.float(),
                            u.float() * chunk_decay[..., None])
    total_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, nh)
    h = prior.get("h")
    h = torch.zeros((B, nh, P, N), dtype=torch.float32, device=x.device) if h is None else h
    y_inter = torch.empty((B, nc, Q, nh, P), dtype=torch.float32, device=x.device)
    for c in range(nc):
        y_inter[:, c] = (torch.einsum("bin,bhpn->bihp", Cc[:, c].float(), h)
                         * torch.exp(cum[:, c])[..., None])
        h = h * total_decay[:, c, :, None, None] + state_in[:, c]

    y = (y_intra.float() + y_inter).reshape(B, nc * Q, nh, P)[:, :S]
    y = y + p.D.float()[:, None] * xi.view(B, S, nh, P).float()
    y = y.reshape(B, S, nh * P).to(x.dtype)
    new_state = {
        "h": h,
        "conv_x": _roll_ctx(xi_raw, prior.get("conv_x"), cw),
        "conv_B": _roll_ctx(B_raw, prior.get("conv_B"), cw),
        "conv_C": _roll_ctx(C_raw, prior.get("conv_C"), cw),
    }
    return y * F.silu(z), new_state


def _mesh_layout(B: int, nh: int, batch_axis: str):
    """The core's layout under a mesh: (the mesh dims of the batch rows, those
    of the heads), as (batch_axis, "inner") resolve on (B, nh) (the heads
    stay whole where "model" does not divide them)."""
    pl = sh.placements_of((B, nh), (batch_axis, "inner"))
    return sh.dims_sharding(pl, 0), sh.dims_sharding(pl, 1)


def _core_placements(bd, hd):
    """(the core leaves' placements, the state leaves') for batch mesh dims
    `bd` and head mesh dims `hd`."""
    leaves = [sh.placed({} if d is None else {d: hd}) for d in _CORE_HEAD_DIM]
    states = [sh.placed({0: bd} if d is None else {0: bd, d: hd}) for d in _STATE_HEAD_DIM]
    return leaves, states


def mamba2_forward(
    p: Mamba2,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    chunk: int = 128,
    state: Optional[dict] = None,  # continue from a previous state (or None = fresh)
) -> Tuple[torch.Tensor, dict]:
    """Full-sequence chunked forward. Returns (y (B, S, d), final state).

    Under a mesh the gates, the causal convs and the scan run in one
    `run_local` on each rank's batch rows and local heads (xi, dt and h
    sharded by heads over "inner", B and C replicated), so DTensor's host
    cost is paid once a mixer, not once an op; the gated norm takes the full
    inner row through `ops.rmsnorm`, and w_out's product is a partial sum
    until the output's constraint. Under a gradient each `_CORE` leaf's
    gradient is each rank's rows' (and, for a leaf the heads do not cut,
    its heads') part, a partial sum over those mesh dims, and sharded on the
    heads where the leaf is (`sharding.run_local`)."""
    prior = state or {}
    if not isinstance(x, DTensor):
        yz, new_state = _ssd(p, x, cfg, chunk, prior)
    else:
        bd, hd = _mesh_layout(x.shape[0], cfg.n_ssm_heads, "batch")
        leaves, states = _core_placements(bd, hd)
        names = [k for k in _STATE if k in prior]
        yz, *st = sh.run_local(
            lambda xl, *a: _ssd_local(xl, a[:len(_CORE)], names, a[len(_CORE):], cfg, chunk),
            (sh.placed({0: bd, 2: hd}),) + tuple(states),
            (sh.placed({0: bd}),) + tuple(leaves)
            + tuple(states[_STATE.index(k)] for k in names),
            x, *(getattr(p, n) for n in _CORE), *(prior[k] for k in names))
        new_state = dict(zip(_STATE, st))
    y = rms_norm(yz, p.norm, cfg.norm_eps)
    return constrain(y @ p.w_out, ("batch", "seq", "embed")), new_state


def _ssd_local(x, leaves, names, prior, cfg, chunk):
    yz, st = _ssd(_Core(*leaves), x, cfg, chunk, dict(zip(names, prior)))
    return (yz,) + tuple(st[k] for k in _STATE)


def _push(ctx: torch.Tensor, raw: torch.Tensor) -> None:
    """Shift the rolling conv context (B, cw-1, D) by one raw input (B, 1, D), in place."""
    ctx.copy_(torch.cat([ctx[:, 1:], raw], dim=1))


def _ssd_step(p, x: torch.Tensor, state: dict, cfg: ModelConfig) -> torch.Tensor:
    """One token through the heads `p` holds, the state updated in place:
    -> y * silu(z) (B, nh P)."""
    B = x.shape[0]
    nh, P = p.D.shape[0], cfg.ssm_head_dim
    xi_raw, z, B_raw, C_raw, dt = _gates(p, x[:, None, :])
    xi = _causal_conv(xi_raw, p.conv_x, state["conv_x"])[:, 0]
    Bc = _causal_conv(B_raw, p.conv_B, state["conv_B"])[:, 0]
    Cc = _causal_conv(C_raw, p.conv_C, state["conv_C"])[:, 0]
    dt1 = dt[:, 0]  # (B, nh)

    a = torch.exp(-torch.exp(p.A_log.float()) * dt1)  # (B, nh)
    xh = xi.view(B, nh, P).float()
    u = xh * dt1[..., None]
    h = state["h"]
    h.mul_(a[..., None, None]).addcmul_(u[..., None], Bc.float()[:, None, None, :])
    y = (h @ Cc.float()[:, None, :, None])[..., 0]  # (B, nh, P)
    y = y + p.D.float()[:, None] * xh
    y = y.reshape(B, nh * P).to(x.dtype)
    _push(state["conv_x"], xi_raw)
    _push(state["conv_B"], B_raw)
    _push(state["conv_C"], C_raw)
    return y * F.silu(z[:, 0])


def mamba2_decode_step(
    p: Mamba2,
    x: torch.Tensor,  # (B, d) one token
    state: dict,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, dict]:
    """Single-token recurrent step; `state` (as from `init_mamba_state`) is
    updated in place and returned. Under a mesh the step runs in one
    `run_local` on the layout the cache's axes give its state ("kv_batch",
    heads over "inner"), writing each leaf's local storage (a leaf laid out
    otherwise, conv_x where "model" divides the inner width but not the
    heads, is updated through a copy written back)."""
    if not isinstance(x, DTensor):
        yz = _ssd_step(p, x, state, cfg)
    else:
        bd, hd = _mesh_layout(x.shape[0], cfg.n_ssm_heads, "kv_batch")
        leaves, states = _core_placements(bd, hd)
        n = len(_CORE)
        yz = sh.run_local(
            lambda xl, *a: _ssd_step(_Core(*a[:n]), xl, dict(zip(_STATE, a[n:])), cfg),
            sh.placed({0: bd, 1: hd}), (sh.placed({0: bd}),) + tuple(leaves) + tuple(states),
            x, *(getattr(p, k) for k in _CORE), *(state[k] for k in _STATE),
            inplace=range(1 + n, 1 + n + len(_STATE)))
    y = rms_norm(yz, p.norm, cfg.norm_eps)
    return constrain(y @ p.w_out, ("batch", "embed")), state
