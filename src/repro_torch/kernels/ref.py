"""Plain PyTorch versions of the hand-written kernels.

Each computes what its CUDA kernel computes, in the kernel's own layout and
rounding: f32 scores and softmax, f32 accumulation, one rounding to the
input dtype at the end. Where `repro.kernels.ref` differs from the Pallas
kernels, these follow the kernels:

  * rows whose every KV slot is masked emit 0 (the online-softmax l = 0
    rule), not the mean of V;
  * rmsnorm returns x's dtype even when gamma is f32.

The CPU path of `ops` runs these; `chip_smoke.py` holds each kernel against
its plain version on the card. `decode_attention_split` is the decode
kernel's split-and-merge rule written out plainly, for the tests.
`decode_attention(..., return_lse=True)` also returns the log-sum-exp of
the valid scores, and `merge_decode_parts` merges such (output, lse) parts
of a cache cut by slots, as the sharded decode merges them across ranks.
`rmsnorm_bwd` is rmsnorm's gradient written out as a formula, the plain
version of the backward kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "decode_attention", "decode_attention_split",
           "merge_decode_parts", "merge_weights", "rmsnorm", "rmsnorm_bwd"]

NEG_INF = -1e30


def _masked_softmax_mix(s: torch.Tensor, ok: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(s where ok) @ v in f32; rows with no valid slot give 0.

    s: (..., Sq, Sk) f32 scores, ok: broadcastable bool, v: (..., Sk, dh) f32.
    """
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p @ v) / l


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dh)
    *,
    causal: bool = True,
    window: int = 0,
    kv_len: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Prefill attention over arange positions; GQA maps head h to h // G.
    Query row i sits at position `q_offset` + i (a block of rows of a longer
    sequence, as context parallelism cuts it), key j at j.

    Returns (B, Sq, H, dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, dh).permute(0, 2, 3, 1, 4)  # (B,K,G,Sq,dh)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]  # (B,K,1,Sk,dh)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))  # (B,K,G,Sq,Sk)
    qpos = torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = kpos < (Sk if kv_len is None else kv_len)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    out = _masked_softmax_mix(s, ok, vf)  # (B,K,G,Sq,dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Sc, K, dh) — the cache layout
    v: torch.Tensor,  # (B, Sc, K, dh)
    kv_pos: torch.Tensor,  # (B, Sc) absolute positions, -1 = empty slot
    pos: torch.Tensor,  # (B,) query positions
    *,
    window: int = 0,
    return_lse: bool = False,
):
    """One query token per sequence against its cache; returns (B, H, dh) in
    q's dtype, or with `return_lse` (the output (B, H, dh) f32, the
    log-sum-exp of each row's valid scores (B, H) f32, -inf where none is)."""
    B, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, dh)
    kf = k.float().permute(0, 2, 3, 1)  # (B,K,dh,Sc)
    vf = v.float().permute(0, 2, 1, 3)  # (B,K,Sc,dh)
    s = (qf @ kf) * (1.0 / math.sqrt(dh))  # (B,K,G,Sc)
    p = pos.to(kv_pos.dtype)[:, None]
    ok = (kv_pos >= 0) & (kv_pos <= p)
    if window > 0:
        ok = ok & (kv_pos > p - window)
    ok = ok[:, None, None, :]
    out = _masked_softmax_mix(s, ok, vf).reshape(B, H, dh)  # (B,K,G,dh) as (B,H,dh)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(s.masked_fill(~ok, -math.inf), dim=-1)
    return out, lse.reshape(B, H)


def merge_weights(lse: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Each part's weight exp(lse - M) for M the largest lse over the parts;
    0 where a part has no valid slot (lse = -inf), and so where no part has
    one (M = -inf), never NaN. A single part gets exactly 1."""
    live = lse > -math.inf
    return torch.where(live, torch.exp(lse - torch.where(live, M, lse.new_zeros(()))),
                       lse.new_zeros(()))


def merge_decode_parts(outs, lses) -> torch.Tensor:
    """The decode output over a whole cache from `decode_attention(...,
    return_lse=True)` over each part of it (slots cut into ranges): the parts'
    outputs weighted by `merge_weights`, summed, over the summed weights;
    f32, 0 where no part has a valid slot."""
    lse = torch.stack(list(lses))  # (P, B, H)
    w = merge_weights(lse, lse.amax(dim=0))
    num = (w[..., None] * torch.stack(list(outs))).sum(dim=0)
    den = w.sum(dim=0)[..., None]
    return num / torch.where(den > 0, den, torch.ones_like(den))


def decode_attention_split(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Sc, K, dh)
    v: torch.Tensor,  # (B, Sc, K, dh)
    kv_pos: torch.Tensor,  # (B, Sc)
    pos: torch.Tensor,  # (B,)
    *,
    window: int = 0,
    splits: int = 1,
    tile: int = 64,
) -> torch.Tensor:
    """`decode_attention` as the split-K kernel computes it: the cache cut
    into `splits` ranges of whole `tile`-slot tiles, each reduced to f32
    (m, l, acc) with m = -1e30 and l = 0 where it has no valid slot, then
    merged in split order with weights exp(m_s - M); a row with no valid
    slot in any split gives 0."""
    B, H, dh = q.shape
    Sc, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, dh)
    s = (qf @ k.float().permute(0, 2, 3, 1)) * (1.0 / math.sqrt(dh))  # (B,K,G,Sc)
    vf = v.float().permute(0, 2, 1, 3)  # (B,K,Sc,dh)
    p = pos.to(kv_pos.dtype)[:, None]
    ok = (kv_pos >= 0) & (kv_pos <= p)
    if window > 0:
        ok = ok & (kv_pos > p - window)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    n_tiles = -(-Sc // tile)
    per = -(-n_tiles // splits) * tile  # slots per split
    ms, ls, accs = [], [], []
    for lo in range(0, per * splits, per):
        ss, vs = s[..., lo:lo + per], vf[..., lo:lo + per, :]
        m = ss.amax(dim=-1, keepdim=True) if ss.shape[-1] else torch.full_like(s[..., :1], NEG_INF)
        e = torch.where(m <= NEG_INF / 2, torch.zeros_like(ss), torch.exp(ss - m))
        ms.append(m)
        ls.append(e.sum(dim=-1, keepdim=True))
        accs.append(e @ vs)
    M = torch.stack(ms).amax(dim=0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(M <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - M))
        L = L + w * l
        A = A + w * acc
    return (A / L.clamp_min(1e-30)).reshape(B, H, dh).to(q.dtype)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """f32, the kernels' arithmetic; f64 stays f64 (for gradcheck)."""
    return t if t.dtype == torch.float64 else t.float()


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm: f32 mean of squares, normalise, round to x's dtype,
    times gamma, round to x's dtype again."""
    xf = _wide(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return (_wide(y) * _wide(gamma)).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `rmsnorm` for the output's gradient dy: (dx in x's
    dtype, dgamma in gamma's dtype). In f32, with r = rsqrt(mean(x^2) + eps),
    xhat = x r and g = dy gamma:

        dx = r (g - xhat mean(g xhat)),   dgamma = sum over rows of dy xhat',

    where xhat' is xhat rounded to x's dtype, as the forward multiplies it.
    The roundings of the forward are passed through, as the reference's
    gradient of `.astype` passes them. As the kernel does, the sums are
    taken in f64 (mean(x^2) and mean(g x) per row, dgamma over rows) and r is
    the f64 rsqrt rounded once, so the two agree on every rounding of xhat'.
    """
    d = x.shape[-1]
    xf = _wide(x.reshape(-1, d))
    dyf = _wide(dy.reshape(-1, d))
    rd = torch.rsqrt((xf.double() ** 2).mean(dim=-1, keepdim=True) + eps)
    r = rd.to(xf.dtype)
    xhat = xf * r
    g = dyf * _wide(gamma)
    c = ((g.double() * xf.double()).sum(dim=-1, keepdim=True) * rd / d).to(xf.dtype)
    dx = r * (g - xhat * c)
    dgamma = (dyf.double() * xhat.to(x.dtype).double()).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dgamma.to(gamma.dtype)
