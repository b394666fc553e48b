"""Dispatch over the hand-written kernels (counterpart of `repro/kernels/ops.py`).

A CUDA tensor goes to its kernel, which launches or raises; a CPU tensor
goes to the plain version in `ref`. Nothing falls back from the card to the
plain path. `LAUNCHES` counts kernel launches per kernel.

`rmsnorm` is differentiable: `RMSNormFn` runs the forward kernel and, for
the gradient, the backward kernel (the plain versions on the CPU, through
the same Function). The attention kernels have no backward, in this package
or the reference: their raw wrappers raise on inputs that require grad, and
training takes the naive or chunked attention (`RuntimeFlags.attn_impl_for`).

Under a mesh (`sharding.use_mesh`) the inputs are DTensors, which the
kernels cannot take (they launch on raw pointers): each wrapper runs its
kernel, or on the CPU its plain version, on the local shards through
`local_map`, with declared placements resolved by the active rules, and
redistributes inputs whose placements differ first:

  * flash: batch over the data axes, heads over "model"; with `seq_shard`
    (context parallelism, `RuntimeFlags.attn_seq_shard`) q's query rows
    over the mesh dims "attn_q_seq" resolves to (before heads claim them),
    as the reference pins its attention output: each rank runs the kernel
    on its contiguous block of rows at its own `q_offset`, against K and V
    whole along the sequence (gathered over those dims if they come cut),
    so that the causal and window masks read the rows' global positions;
  * decode over a cache whose slots are sharded (`kv_seq`: "model" under
    every decode rule set, on a mesh dim of size 1 too): the cache stays
    where it is. Each rank runs the kernel in its lse mode over its own
    slots, for the cache's rows (q's rows cut to the cache's `kv_batch`
    rows locally) and every head (q's heads gathered: B x H x dh); the
    ranks' (output, lse) parts are merged across the slot dims by two
    all-reduces (the max of lse, then the sum of the weighted outputs and
    the weights, `ref.merge_weights`), and the merged f32 output is
    rounded once and leaves with q's placements (its heads cut locally).
    The fresh token needs no third part: decode writes it into its slot
    first (`sharding.write_slots`), on the rank that holds the slot. This
    is the reference's decode, whose score, softmax and mix chain GSPMD
    shards along the cache's slots, moving only the softmax's reductions;
  * decode over a cache whose slots are not sharded: batch and heads as
    flash's;
  * rmsnorm: rows (the batch dim) sharded, the last dim and gamma
    replicated; a row whose last dim is sharded (Mamba2's and the mLSTM's
    norms over "inner") is gathered for the call and cut again after it.
    `RMSNormFn` runs inside `local_map` as it is, its backward kernel on
    each rank's rows: gamma's gradient there is a partial sum over the
    rows' mesh dims (`sharding.run_local`), which the backward of gamma's
    gather reduces to gamma's own placement (its FSDP shard over "data").

Flash takes any Sq and Sk and either mask (the enc-dec encoder is
non-causal, its cross prefill Sq != Sk); decode takes any cache, the
enc-dec cross cache too, whose slots and positions `cache_axes` lays out.

Where "model" divides the query heads but not the KV heads (GQA), the KV
heads are replicated and each rank takes the ones its query heads read.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import sharding as sh
from . import ref
from ._build import LAUNCHES
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .rmsnorm import rmsnorm_bwd as _rmsnorm_bwd_kernel

__all__ = ["LAUNCHES", "reset_launches", "flash_attention", "decode_attention", "rmsnorm",
           "RMSNormFn"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(
    q: torch.Tensor,  # (B, Sq, K, G, dh) — model-layer layout; a DTensor (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    seq_shard: bool = False,
) -> torch.Tensor:
    """Attention over arange positions (the kernel's only position layout),
    shaped as q; under a mesh with `seq_shard`, q's rows cut over
    "attn_q_seq" (module docstring)."""
    if isinstance(q, DTensor):  # (B, Sq, H, dh): DTensor cannot cut sharded heads into (K, G)
        q_pl, kv_pl, pair, rows = attention_layout(q.shape, k.shape, seq_shard)
        mesh = sh.current_mesh()

        def local(ql, kl, vl):
            return _flash_local(ql, kl, vl, causal=causal, window=window,
                                q_offset=sh.shard_start(mesh, rows, ql.shape[1]))

        return sh.run_local(functools.partial(_paired, local, pair), q_pl, (q_pl, kv_pl, kv_pl),
                            q, k, v)
    B, Sq, K, G, dh = q.shape
    out = _flash_local(q.view(B, Sq, K * G, dh), k, v, causal=causal, window=window)
    return out.view(B, Sq, K, G, dh)  # views: raise, not copy


def _flash_local(qh, k, v, *, causal, window, q_offset=0):
    if qh.is_cuda:
        return _flash_kernel(qh, k, v, causal=causal, window=window, q_offset=q_offset)
    return ref.flash_attention(qh, k, v, causal=causal, window=window, q_offset=q_offset)


def attention_layout(q_shape, k_shape, seq_shard: bool):
    """(q's placements, k and v's, the KV-head pairing, the mesh dims that
    cut q's query rows) of an attention core on (B, Sq, H, dh) q and (B,
    Sk, K, dh) k and v under the active rules: batch over the data axes;
    with `seq_shard` the query rows over "attn_q_seq" (which resolves
    before "heads", so a mesh dim it takes shards no heads), K and V whole
    along the sequence; heads over what is left of "model"
    (`_head_placements`)."""
    q_pl, kv_pl, pair = _head_placements(
        q_shape, k_shape, ("batch", "attn_q_seq" if seq_shard else None, "heads", None),
        ("batch", None, "kv_heads", None))
    return q_pl, kv_pl, pair, sh.dims_sharding(q_pl, 1)


def _head_placements(q_shape, k_shape, q_axes, k_axes):
    """(q's placements, k and v's, the KV-head pairing) of an attention
    kernel under the active rules: batch over the data axes, heads over
    "model". K shares q's head sharding where it resolves to the same mesh
    dims; elsewhere it is replicated and `pair` holds (the mesh, the heads'
    mesh dims, G) for `_paired`."""
    q_pl = sh.placements_of(q_shape, q_axes)
    k_raw = sh.placements_of(k_shape, k_axes)
    hq, hk = q_axes.index("heads"), k_axes.index("kv_heads")
    heads = sh.dims_sharding(q_pl, hq)
    kv_pl = [Shard(0) if q_pl[i] == Shard(0) else
             Shard(hk) if i in heads and k_raw[i] == Shard(hk) else Replicate()
             for i in range(len(q_pl))]
    pair = None
    if heads and sh.dims_sharding(kv_pl, hk) != heads:
        pair = (sh.current_mesh(), heads, q_shape[hq] // k_shape[hk])
    return q_pl, kv_pl, pair


def _paired(fn, pair, q, k, v, *rest):
    """`fn` on local shards, with k and v (all KV heads) cut to the KV heads
    of this rank's query heads: the block [r H', (r + 1) H') of the H
    global heads reads KV heads [r H' / G, ...), G query heads each."""
    if pair is not None:
        mesh, dims, G = pair
        Hl = q.shape[-2]
        h0 = sh.shard_index(mesh, dims) * Hl
        if Hl % G and G % Hl:
            raise ValueError(f"{Hl} query heads a rank cannot pair with KV heads of {G}")
        kv = slice(h0 // G, h0 // G + max(1, Hl // G))
        k, v = k[..., kv, :], v[..., kv, :]
    return fn(q, k, v, *rest)


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Sc, K, dh)
    v: torch.Tensor,
    kv_pos: torch.Tensor,  # (B, Sc) int32
    pos: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
) -> torch.Tensor:
    fn = functools.partial(_decode_local, window=window)
    if isinstance(q, DTensor):
        if sh.dims_sharding(k.placements, 1):
            return _decode_over_slots(q, k, v, kv_pos, pos, window)
        q_pl, kv_pl, pair = _head_placements(q.shape, k.shape, ("batch", "heads", None),
                                             ("batch", None, "kv_heads", None))
        pos_pl = [p if p == Shard(0) else Replicate() for p in q_pl]
        return sh.run_local(functools.partial(_paired, fn, pair), q_pl,
                            (q_pl, kv_pl, kv_pl, pos_pl, pos_pl), q, k, v, kv_pos, pos)
    return fn(q, k, v, kv_pos, pos)


def _decode_local(q, k, v, kv_pos, pos, *, window, return_lse=False):
    if q.is_cuda:
        return _decode_kernel(q, k, v, kv_pos, pos, window=window, return_lse=return_lse)
    return ref.decode_attention(q, k, v, kv_pos, pos, window=window, return_lse=return_lse)


def _decode_over_slots(q, k, v, kv_pos, pos, window):
    """Decode over a cache whose slots are sharded, the cache left in place
    (module docstring): k, v and kv_pos keep their rows and slots as they
    lie (any other sharding of theirs, none under the rule sets, is made
    whole), q and pos take the cache's rows, and each rank's (output, lse)
    over its slots is merged across the slot dims in the same `run_local`.
    The result leaves in the placements q's axes give it."""
    mesh = sh.current_mesh()
    cache_pl = [p if p in (Shard(0), Shard(1)) else Replicate() for p in k.placements]
    rows = [p if p == Shard(0) else Replicate() for p in cache_pl]
    slot_dims = [i for i in sh.dims_sharding(cache_pl, 1) if mesh.size(i) > 1]

    def local(ql, kl, vl, kpl, pl):
        o, lse = _decode_local(ql, kl, vl, kpl, pl, window=window, return_lse=True)
        return _merge_over(mesh, slot_dims, o, lse).to(ql.dtype)

    out = sh.run_local(local, rows, (rows, cache_pl, cache_pl, cache_pl, rows),
                       q, k, v, kv_pos, pos)
    return sh.redistribute(out, sh.placements_of(q.shape, ("batch", "heads", None)))


def _merge_over(mesh, dims, o, lse):
    """The (output (B, H, dh), lse (B, H)) parts of the ranks along mesh
    `dims` merged (`ref.merge_weights`): M = the max of lse, one all-reduce;
    the weighted outputs and their weights, summed in one more; f32. With
    no dims (one rank holds every slot) the weights are exactly 1."""
    M = lse
    for i in dims:
        M = funcol.all_reduce(M, "max", mesh.get_group(i))
    w = ref.merge_weights(lse, M)[..., None]
    parts = torch.cat([w * o, w], dim=-1)
    for i in dims:
        parts = funcol.all_reduce(parts, "sum", mesh.get_group(i))
    num, den = parts[..., :-1], parts[..., -1:]
    return num / torch.where(den > 0, den, torch.ones_like(den))


class RMSNormFn(torch.autograd.Function):
    """rmsnorm with its gradient: the forward and backward kernels on the
    card, `ref.rmsnorm` and `ref.rmsnorm_bwd` on the CPU. Saves x and gamma
    only; the backward recomputes the row scale."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if x.is_cuda:
            return _rmsnorm_kernel(x, gamma, eps)
        return ref.rmsnorm(x, gamma, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, gamma = ctx.saved_tensors
        bwd = _rmsnorm_bwd_kernel if x.is_cuda else ref.rmsnorm_bwd
        dx, dgamma = bwd(x, gamma, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dgamma if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if isinstance(x, DTensor):  # rows sharded, the last dim and gamma replicated
        x_pl = sh.placements_of(x.shape, ("batch",) + (None,) * (x.dim() - 1))
        y = sh.run_local(lambda xl, g: RMSNormFn.apply(xl, g, eps), x_pl,
                         (x_pl, [Replicate()] * len(x_pl)), x, gamma)
        # a row sharded on its last dim ("inner": Mamba2's gated norm, the
        # mLSTM's) was gathered for the kernel; the result goes back in the
        # caller's placement, a local cut
        last = Shard(x.dim() - 1)
        return sh.redistribute(y, [p if p == last else q for p, q in zip(x.placements, x_pl)])
    return RMSNormFn.apply(x, gamma, eps)
