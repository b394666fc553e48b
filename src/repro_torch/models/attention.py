"""Grouped-query attention: prefill and decode (counterpart of
`repro/models/attention.py`).

  * naive   — materialises (B, K, G, Sq, Sk) scores; the CPU path up to
              `naive_below` keys.
  * chunked — double-chunked online softmax in plain PyTorch loops over
              query and KV chunks; the CPU path above `naive_below`, and
              wherever the caller asks for it.
  * pallas  — the flash kernel (`kernels/ops.flash_attention`); what "auto"
              takes on the card when no gradient is recorded. The name
              follows the reference's flag. The kernel has no backward, so
              training takes naive or chunked, as the reference does.

GQA is native: q is shaped (B, S, K, G, dh) against KV (B, S, K, dh).
Optional QKV biases are added after the projections and before RoPE;
`rope` tables of None mean NoPE (iRoPE layers).

Decode writes the fresh token's K/V into its cache slot first and then
attends over the cache (`ops.decode_attention`). That equals the
reference's two-part softmax (cache + fresh token) whenever the slot it
overwrites was already masked: an empty slot (pos < Sc), or pos - Sc outside
a window <= Sc. `InferenceEngine` sizes requests so that pos < Sc holds, and
the stack refuses a ring cache smaller than its window. Under a mesh whose
rules shard the cache's slots (`kv_seq` over "model" in every decode rule
set), the cache stays where it lies, as the reference keeps it: the token is
written on the rank that holds its slot, each rank attends over its own
slots and the ranks' parts are merged by their log-sum-exp (`kernels/ops.py`).

Cross attention (the enc-dec decoder): K/V come from `project_kv` over the
encoder output (no RoPE), q is projected and rotated as usual, and the mask
is full: no causal mask, no window. Prefill runs the flash kernel
non-causally over the encoder's arange positions (Sq != Sk). Decode runs
the decode kernel over the static cross cache (`cross_decode_attention`),
masked by `cross_pos >= 0` only, as the reference is: the kernel also drops
slots past the query position, so it is called with a position that no
frame exceeds and no window. The cross cache is never written in decode.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import ops
from .. import sharding as sh
from ..sharding import constrain
from .common import RuntimeFlags, init_normal_, param
from .rope import rotate

__all__ = [
    "Attention",
    "init_attention",
    "naive_attention",
    "chunked_attention",
    "attention_core",
    "attention_forward",
    "project_kv",
    "decode_attention",
    "cross_decode_attention",
]

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = param((d, H, dh), ("p_embed", "p_heads", None), device, dtype)
        self.wk = param((d, K, dh), ("p_embed", "p_kv_heads", None), device, dtype)
        self.wv = param((d, K, dh), ("p_embed", "p_kv_heads", None), device, dtype)
        self.wo = param((H, dh, d), ("p_heads", None, "p_embed"), device, dtype)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = param((H, dh), ("p_heads", None), device, dtype)
            self.bk = param((K, dh), ("p_kv_heads", None), device, dtype)
            self.bv = param((K, dh), ("p_kv_heads", None), device, dtype)


def init_attention(p: Attention, gen: torch.Generator) -> Attention:
    H, dh = p.wo.shape[:2]
    init_normal_(p.wq, gen)
    init_normal_(p.wk, gen)
    init_normal_(p.wv, gen)
    init_normal_(p.wo, gen, scale=1.0 / math.sqrt(H * dh))
    if p.bq is not None:  # the reference starts the biases at zeros
        for b in (p.bq, p.bk, p.bv):
            b.zero_()
    return p


# ---------------------------------------------------------------------------
# score/softmax/mix cores
# ---------------------------------------------------------------------------


def _mask_ok(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """(B, Sq, Sk) validity; k_pos < 0 marks padding slots."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok


def naive_attention(
    q: torch.Tensor,  # (B, Sq, K, G, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dh)
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    causal: bool,
    window: int,
) -> torch.Tensor:
    dh = q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() / math.sqrt(dh)
    ok = _mask_ok(q_pos, k_pos, causal, window)  # (B, Sq, Sk)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    # fully-masked rows emit 0 (the online-softmax l = 0 convention)
    p = p * ok.any(-1)[:, None, None, :, None].to(p.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, K, G, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dh)
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    causal: bool,
    window: int,
    q_chunk: int,
    kv_chunk: int,
) -> torch.Tensor:
    """Double-chunked attention with an online softmax: (m, l, acc) in f32
    per query chunk, carried over the KV chunks; p is cast to v's dtype
    before P.V. Peak memory O(qc * kc) scores."""
    B, Sq, K, G, dh = q.shape
    Sk = k.shape[1]
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    scale = 1.0 / math.sqrt(dh)
    # Pad to chunk multiples; padded KV slots get k_pos = -1 (masked).
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * qc - Sq))
    qposp = F.pad(q_pos, (0, nq * qc - Sq), value=0)
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, nk * kc - Sk)) for t in (k, v))
    kposp = F.pad(k_pos, (0, nk * kc - Sk), value=-1)

    out = torch.empty((B, nq * qc, K, G, dh), dtype=torch.float32, device=q.device)
    for i in range(0, nq * qc, qc):
        qb, qposb = qp[:, i:i + qc], qposp[:, i:i + qc]
        m = torch.full((B, K, G, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, G, qc, dh), dtype=torch.float32, device=q.device)
        for j in range(0, nk * kc, kc):
            kb, vb = kp[:, j:j + kc], vp[:, j:j + kc]
            ok = _mask_ok(qposb, kposp[:, j:j + kc], causal, window)  # (B, qc, kc)
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb).float() * scale
            s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            # rows masked so far: exp(NEG_INF - NEG_INF) would be 1
            p = torch.where(m_new[..., None] <= NEG_INF / 2, 0.0,
                            torch.exp(s - m_new[..., None]))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vb.dtype), vb).float()
            m = m_new
        out[:, i:i + qc] = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return out[:, :Sq].to(q.dtype)


def attention_core(
    q, k, v, q_pos, k_pos, causal: bool, window: int, rt: RuntimeFlags
) -> torch.Tensor:
    """On the card q_pos/k_pos are arange positions (see decoder_forward).
    While a gradient is recorded through q, k or v, "auto" takes the
    reference's differentiable rule (`RuntimeFlags.attn_impl_for`). Under a
    mesh naive and chunked attention run on local shards (`_local_core`);
    there q comes as (B, Sq, H, dh) and so does the result (a heads dim
    sharded over more ranks than K cannot be cut into (K, G) by DTensor).
    Under `rt.attn_seq_shard` every core, the kernel's too, runs on each
    rank's block of query rows (`ops.attention_layout`)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    impl = rt.attn_impl_for(k.shape[1], q.is_cuda, grad)
    if impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   seq_shard=rt.attn_seq_shard)
    if isinstance(q, DTensor):
        return _local_core(q, k, v, causal, window, impl, rt)
    if impl == "chunked":
        return chunked_attention(q, k, v, q_pos, k_pos, causal, window,
                                 rt.q_chunk, rt.kv_chunk)
    return naive_attention(q, k, v, q_pos, k_pos, causal, window)


def _local_core(q, k, v, causal: bool, window: int, impl: str, rt: RuntimeFlags):
    """Naive or chunked attention in one `run_local`, laid out as the flash
    kernel's wrapper lays it out (`ops.attention_layout`): batch over the
    data axes, heads over "model", each rank's KV heads those of its query
    heads (`ops._paired`); under `rt.attn_seq_shard` the query rows over
    "attn_q_seq" instead, K and V whole. The positions are arange, as every
    caller's are under a mesh, and are built on each rank (its query rows
    from its first row's global position), so no position tensor and no
    mask goes through DTensor; op by op, the scores, masks and online
    softmax would each pay DTensor's dispatch. Under autograd K's and V's
    gradients leave as partial sums over the row dims (`run_local`)."""
    q_pl, kv_pl, pair, rows = ops.attention_layout(q.shape, k.shape, rt.attn_seq_shard)
    mesh = sh.current_mesh()

    def core(ql, kl, vl):
        b, sq, hl, dh = ql.shape
        kh, sk = kl.shape[2], kl.shape[1]
        q0 = sh.shard_start(mesh, rows, sq)
        qp = torch.arange(q0, q0 + sq, dtype=torch.int32, device=ql.device).expand(b, sq)
        kp = torch.arange(sk, dtype=torch.int32, device=ql.device).expand(b, sk)
        qg = ql.view(b, sq, kh, hl // kh, dh)
        if impl == "chunked":
            out = chunked_attention(qg, kl, vl, qp, kp, causal, window, rt.q_chunk, rt.kv_chunk)
        else:
            out = naive_attention(qg, kl, vl, qp, kp, causal, window)
        return out.reshape(b, sq, hl, dh)

    return sh.run_local(functools.partial(ops._paired, core, pair), q_pl, (q_pl, kv_pl, kv_pl),
                        q, k, v)


# ---------------------------------------------------------------------------
# full layers
# ---------------------------------------------------------------------------


def _project(x: torch.Tensor, w: torch.Tensor, seq_shard: bool = False) -> torch.Tensor:
    """x (B, S, d) @ w (d, N, dh) -> (B, S, N, dh) as one matmul; under a
    mesh on local shards (`_project_local`)."""
    if isinstance(w, DTensor):
        return _project_local(x, w, seq_shard)
    d, n, dh = w.shape
    return (x @ w.view(d, n * dh)).view(*x.shape[:-1], n, dh)


def _project_local(x: DTensor, w: DTensor, seq_shard: bool = False) -> DTensor:
    """`_project` in one `run_local`, mesh dim by mesh dim (DTensor's own
    product may shard the flat (N dh) columns over a dim that does not
    divide N, 2 or 8 KV heads on a 16-way "model" axis, and those cannot be
    cut back into heads): one that shards w's heads takes x whole and
    shards the result by heads; one that shards both x's and w's
    contraction dim keeps them so, and the result is a partial sum; with
    `seq_shard` (context parallelism) one that "attn_q_seq" takes, where x
    is replicated, cuts x's rows there (locally: nothing moves) and the
    result keeps them, w whole; on any other w is whole (its FSDP shard
    gathered, as the reference's partitioner gathers it) and the result is
    placed as x, whose contraction dim and partial sums are made whole
    first."""
    dh = w.shape[2]
    heads, contract, last = Shard(1), Shard(0), Shard(x.dim() - 1)
    rows = (sh.dims_sharding(sh.placements_of(x.shape, ("batch", "attn_q_seq", None)), 1)
            if seq_shard and x.dim() == 3 else [])
    x_pl, w_pl, out_pl = [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if wp == heads:
            x_pl.append(Replicate()), w_pl.append(heads), out_pl.append(last)
        elif wp == contract and xp == last:
            x_pl.append(last), w_pl.append(contract), out_pl.append(Partial())
        elif i in rows and isinstance(xp, Replicate):
            x_pl.append(Shard(1)), w_pl.append(Replicate()), out_pl.append(Shard(1))
        else:
            whole = Replicate() if xp == last or isinstance(xp, Partial) else xp
            x_pl.append(whole), w_pl.append(Replicate()), out_pl.append(whole)
    return sh.run_local(
        lambda xl, wl: (xl @ wl.reshape(wl.shape[0], -1)).view(*xl.shape[:-1], -1, dh),
        out_pl, (x_pl, w_pl), x, w)


def _project_q(p: Attention, x: torch.Tensor,
               rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
               seq_shard: bool = False) -> torch.Tensor:
    q = _project(x, p.wq, seq_shard)
    if p.bq is not None:
        q = q + p.bq
    return q if rope is None else rotate(q, rope)


def project_kv(p: Attention, x: torch.Tensor,
               seq_shard: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V projections only, no RoPE (cross-attention memory).
    x: (B, S, d) -> k, v: (B, S, K, dh). With `seq_shard` each rank
    projects its query rows, and the constraint below gathers the
    sequence, which every rank's rows attend to."""
    k, v = _project(x, p.wk, seq_shard), _project(x, p.wv, seq_shard)
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return (constrain(k, ("batch", "seq", "kv_heads", None)),
            constrain(v, ("batch", "seq", "kv_heads", None)))


def _project_qkv(
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # rope tables, None = NoPE
    seq_shard: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    k, v = project_kv(p, x, seq_shard)
    if rope is not None:
        k = constrain(rotate(k, rope), ("batch", "seq", "kv_heads", None))
    # under context parallelism q keeps the query rows the core takes
    q_axes = ("batch", "attn_q_seq" if seq_shard else "seq", "heads", None)
    return constrain(_project_q(p, x, rope, seq_shard), q_axes), k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (..., H, dh) @ wo (H, dh, d) -> (..., d); under a mesh on local
    shards (`_out_proj_local`)."""
    if isinstance(wo, DTensor):
        return _out_proj_local(out, wo)
    H, dh, d = wo.shape
    return out.reshape(*out.shape[:-2], H * dh) @ wo.view(H * dh, d)


def _out_proj_local(out: DTensor, wo: DTensor) -> DTensor:
    """`_out_proj` in one `run_local`, mesh dim by mesh dim (DTensor's own
    would cut a (..., H dh) gradient over a dim that does not divide H, as
    in `_project`, and cannot flatten (B, S) with S sharded under context
    parallelism): one that shards out's rows (batch, or the query seq)
    keeps them so, with wo whole (its FSDP shard gathered); one that shards
    wo's heads cuts out by heads too, and the result is a partial sum; one
    that shards wo's output (embed) dim keeps it so, with out whole, and
    the result is sharded so too; on any other both are whole."""
    heads, embed, nd = Shard(0), Shard(2), out.dim()
    o_pl, w_pl, y_pl = [], [], []
    for op, wp in zip(out.placements, wo.placements):
        if isinstance(op, Shard) and op.dim < nd - 2:
            o_pl.append(op), w_pl.append(Replicate()), y_pl.append(op)
        elif wp == heads:
            o_pl.append(Shard(nd - 2)), w_pl.append(heads), y_pl.append(Partial())
        elif wp == embed:
            o_pl.append(Replicate()), w_pl.append(embed), y_pl.append(Shard(nd - 2))
        else:
            o_pl.append(Replicate()), w_pl.append(Replicate()), y_pl.append(Replicate())
    return sh.run_local(lambda ol, wl: ol.flatten(-2) @ wl.reshape(-1, wl.shape[-1]),
                        y_pl, (o_pl, w_pl), out, wo)


def attention_forward(
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    rt: RuntimeFlags,
    positions: torch.Tensor,  # (B, S)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # tables of positions; None = NoPE
    *,
    causal: bool = True,
    window: int = 0,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B, Sk, K, dh) each
    cross_pos: Optional[torch.Tensor] = None,  # (B, Sk)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out (B, S, d), (k, v) for cache collection). With `cross_kv`
    (enc-dec cross attention) only q is projected from x and the mask is
    full; on the card `cross_pos` must be the encoder's arange positions."""
    B, S, _ = x.shape
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cp = rt.attn_seq_shard
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, rope, cp)
        k_pos = positions
    else:
        q, (k, v), k_pos = _project_q(p, x, rope, cp), cross_kv, cross_pos
        causal, window = False, 0
    qg = q if isinstance(q, DTensor) else q.view(B, S, K, G, cfg.head_dim)
    # under context parallelism the core leaves its output's query rows on
    # "attn_q_seq", where the reference pins them
    out = attention_core(qg, k, v, positions, k_pos, causal, window, rt)
    y = _out_proj(out.reshape(B, S, cfg.n_heads, cfg.head_dim), p.wo)
    return constrain(y, ("batch", "seq_res", "embed")), (k, v)


def decode_attention(
    p: Attention,
    x: torch.Tensor,  # (B, d) — one new token per sequence
    pos: torch.Tensor,  # (B,) int32 current position
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # tables of pos[:, None]; None = NoPE
    flat_slot: Optional[torch.Tensor],  # (B,) int64: b * Sc + pos % Sc; None on a mesh
    cache_k: torch.Tensor,  # (B, Sc, K, dh) — this layer's cache, updated in place
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # (B, Sc) int32, pos already written at the slot
    *,
    window: int = 0,
) -> torch.Tensor:
    """One decode step: write the new K/V at its slot, attend over the cache.

    The cache tensors are updated in place (the reference rebuilds them
    functionally); at full width a per-step copy would double the KV
    traffic. Under a mesh (`flat_slot` None) each rank writes the slots it
    holds (`sharding.write_slots`) and attends over them, the ranks' parts
    merged across the slot dims; no cache byte moves. Returns out (B, d)."""
    q, k, v = _project_qkv(p, x[:, None, :], rope)
    if flat_slot is None:
        sh.write_slots(cache_k, k[:, 0], pos)
        sh.write_slots(cache_v, v[:, 0], pos)
    else:
        K, dh = cache_k.shape[2:]
        cache_k.view(-1, K, dh).index_copy_(0, flat_slot, k[:, 0])
        cache_v.view(-1, K, dh).index_copy_(0, flat_slot, v[:, 0])
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, cache_pos, pos, window=window)
    return constrain(_out_proj(out, p.wo), ("batch", "embed"))


def cross_decode_attention(
    p: Attention,
    x: torch.Tensor,  # (B, d)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # tables of pos[:, None]
    cache_k: torch.Tensor,  # (B, Se, K, dh) — static cross cache of this layer
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # (B, Se) int32 encoder positions, -1 = padding
    beyond: torch.Tensor,  # (B,) int32, larger than every encoder position
) -> torch.Tensor:
    """One decode step of cross attention: softmax over the valid encoder
    frames (cache_pos >= 0). The kernel also masks kv_pos > pos, so it gets
    `beyond` as the query position and window 0, which mask nothing else.
    Returns out (B, d); the cache is not written. Under a mesh the cross
    cache comes laid out by `cache_axes` (its slots over "model" under the
    decode rule sets, where "model" divides the frames) and stays so: each
    rank attends over its own frames and the parts are merged, as for the
    self cache."""
    q = _project_q(p, x[:, None, :], rope)
    out = ops.decode_attention(q[:, 0], cache_k, cache_v, cache_pos, beyond, window=0)
    return constrain(_out_proj(out, p.wo), ("batch", "embed"))
