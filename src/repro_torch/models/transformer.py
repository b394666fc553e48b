"""Decoder-only stacks for every decoder-only family (counterpart of
`repro/models/transformer.py`); enc-dec lives in `encdec.py`.

Parameters: a `Decoder` module. The reference keeps a leading layer axis
(two for grouped families) on each leaf; the port holds `nn.ModuleList`s of
per-layer blocks instead (`convert.py` splits the axes):

  * dense / vlm / moe: `layers`, one `Block` (attention + MLP, or `moe`,
    routed experts, `moe.py`) per layer; iRoPE's per-layer RoPE flag is a
    Python `if` per layer, and `decoder_forward` returns the moe router aux
    losses summed over layers.
  * hybrid (zamba2): `mamba_groups` (ng groups of gs `MambaBlock`s), each
    group followed by ONE weight-shared attention + MLP block (`shared`),
    then `mamba_rest` (the rem = L - ng gs remaining Mamba2 blocks).
  * ssm (xlstm): `mlstm_groups` (ng groups of slstm_every - 1 `MLSTMBlock`s),
    each followed by its `slstm_blocks` entry. The sLSTM block's `ffn_norm`
    is a leaf of the reference's tree that its stack never reads; the port
    keeps it, unread, so that conversion stays strict both ways (its
    gradient is zero).

`decoder_forward` is differentiable for every family. Under
`RuntimeFlags.remat` it checkpoints what the reference's `jax.checkpoint`
wraps: each dense/vlm/moe block, each zamba2 group (its Mamba2 layers and
the shared block; not the remainder layers) and each xlstm group.

The stacks are Python loops over the blocks. Inputs are tokens (B, S) or
frontend embeddings (B, S, d) (vlm); decode embeds the generated tokens.
Tied embeddings have no `lm_head`: the logits use a view of `embed.T`.

Caches, in the reference's layout, updated in place by decode:

  * attention: {"k", "v": (L, B, Sc, K, dh), "pos": (B, Sc) int32}.
    Sliding-window serving (`window_override`) uses the same buffers as a
    ring (slot = pos % Sc).
  * hybrid: the shared block's {"k", "v": (ng, B, Sc, K, dh), "pos"}, one
    entry per group application, plus the Mamba2 states {"mamba": leaves
    (ng, gs, B, ...), "rest": leaves (rem, B, ...)} (`mamba2.py`).
  * ssm: {"mlstm": leaves (ng, gs - 1, B, ...), "slstm": leaves (ng, B, ...)}
    (`xlstm.py`).

`CACHE_BATCH_AXIS` gives the batch axis of every cache leaf by its
top-level key, as the reference's "kv_batch" logical axis does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import Attention, attention_forward, decode_attention, init_attention
from .common import DTYPES, RuntimeFlags, init_normal_, param, rms_norm
from .mamba2 import Mamba2, init_mamba2, init_mamba_state, mamba2_decode_step, mamba2_forward
from .mlp import MLP, init_mlp, mlp_forward
from .moe import MoE, init_moe, moe_forward
from .rope import mrope_tables, rope_tables, text_mrope_positions
from .xlstm import (
    MLSTM,
    SLSTM,
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
    mlstm_decode_step,
    mlstm_forward,
    slstm_decode_step,
    slstm_forward,
)

__all__ = [
    "Block",
    "MambaBlock",
    "MLSTMBlock",
    "SLSTMBlock",
    "Decoder",
    "CACHE_BATCH_AXIS",
    "group_shape",
    "init_decoder_params",
    "decoder_forward",
    "decoder_prefill",
    "decoder_decode",
    "init_decode_cache",
    "logits_from_hidden",
    "embed_inputs",
]


UNIFORM = ("dense", "vlm", "moe")
# The batch axis of every cache leaf, by its top-level key (nested dicts
# share their key's axis); enc-dec's cross-attention leaves included.
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "pos": 0, "mamba": 2, "rest": 1, "mlstm": 2,
                    "slstm": 1, "cross_k": 1, "cross_v": 1, "cross_pos": 0}


def group_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, remainder) for grouped families."""
    if cfg.family == "hybrid":
        g = cfg.shared_attn_every
    elif cfg.family == "ssm":
        g = cfg.slstm_every
    else:
        return (0, 0, cfg.n_layers)
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


class Block(nn.Module):
    """Pre-norm attention + MLP residual block; `moe` in place of `mlp` when
    the config has experts (the reference's tree keys)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.attn_norm = param((cfg.d_model,), device, dtype)
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.mlp_norm = param((cfg.d_model,), device, dtype)
        if cfg.n_experts:
            self.moe = MoE(cfg, device=device, dtype=dtype)
        else:
            self.mlp = MLP(cfg, device=device, dtype=dtype)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 residual block (hybrid family)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.norm = param((cfg.d_model,), device, dtype)
        self.mamba = Mamba2(cfg, device=device, dtype=dtype)


class MLSTMBlock(nn.Module):
    """Pre-norm mLSTM residual block (ssm family)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.norm = param((cfg.d_model,), device, dtype)
        self.mlstm = MLSTM(cfg, device=device, dtype=dtype)


class SLSTMBlock(nn.Module):
    """Pre-norm sLSTM residual block (ssm family); `ffn_norm` is kept and never read."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.norm = param((cfg.d_model,), device, dtype)
        self.ffn_norm = param((cfg.d_model,), device, dtype)
        self.slstm = SLSTM(cfg, device=device, dtype=dtype)


def _blocks(cls, n: int, cfg, device, dtype) -> nn.ModuleList:
    return nn.ModuleList(cls(cfg, device=device, dtype=dtype) for _ in range(n))


class Decoder(nn.Module):
    """All parameters of a decoder-only model; `init_decoder_params` fills
    them. `lm_head` is None under tied embeddings."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.n_encoder_layers or cfg.family not in UNIFORM + ("hybrid", "ssm"):
            raise ValueError(f"family {cfg.family!r}: enc-dec models are `encdec.EncDec`")
        dtype = dtype or DTYPES[cfg.dtype]
        self.embed = param((cfg.padded_vocab, cfg.d_model), device, dtype)
        self.final_norm = param((cfg.d_model,), device, dtype)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((cfg.d_model, cfg.padded_vocab), device, dtype))
        ng, gs, rem = group_shape(cfg)
        if cfg.family in UNIFORM:
            self.layers = _blocks(Block, cfg.n_layers, cfg, device, dtype)
        elif cfg.family == "hybrid":
            self.mamba_groups = nn.ModuleList(
                _blocks(MambaBlock, gs, cfg, device, dtype) for _ in range(ng))
            self.mamba_rest = _blocks(MambaBlock, rem, cfg, device, dtype)
            self.shared = Block(cfg, device=device, dtype=dtype)
        else:
            if rem:
                raise ValueError("xlstm stack must divide into (mLSTM*, sLSTM) groups")
            self.mlstm_groups = nn.ModuleList(
                _blocks(MLSTMBlock, gs - 1, cfg, device, dtype) for _ in range(ng))
            self.slstm_blocks = _blocks(SLSTMBlock, ng, cfg, device, dtype)


def init_block(blk: Block, cfg: ModelConfig, gen: torch.Generator) -> None:
    blk.attn_norm.fill_(1.0)
    blk.mlp_norm.fill_(1.0)
    init_attention(blk.attn, gen)
    if cfg.n_experts:
        init_moe(blk.moe, gen)
    else:
        init_mlp(blk.mlp, gen)


@torch.no_grad()
def init_decoder_params(
    cfg: ModelConfig, gen: torch.Generator, device, dtype=None
) -> Decoder:
    """Random weights with the reference's shapes and scales: embed 0.02,
    wo 1/sqrt(H*dh), the leading dim otherwise (fan-in; E for the expert
    weights), the recurrent blocks' own (`init_mamba2`, `init_mlstm`,
    `init_slstm`), norms ones. Drawn on `device` from `gen` (a generator of
    that device)."""
    p = Decoder(cfg, device=device, dtype=dtype)
    init_normal_(p.embed, gen, scale=0.02)
    p.final_norm.fill_(1.0)
    if p.lm_head is not None:
        init_normal_(p.lm_head, gen)
    if cfg.family in UNIFORM:
        for blk in p.layers:
            init_block(blk, cfg, gen)
    elif cfg.family == "hybrid":
        for blk in [b for grp in p.mamba_groups for b in grp] + list(p.mamba_rest):
            blk.norm.fill_(1.0)
            init_mamba2(blk.mamba, gen)
        init_block(p.shared, cfg, gen)
    else:
        for blk in [b for grp in p.mlstm_groups for b in grp]:
            blk.norm.fill_(1.0)
            init_mlstm(blk.mlstm, gen)
        for blk in p.slstm_blocks:
            blk.norm.fill_(1.0)
            blk.ffn_norm.fill_(1.0)
            init_slstm(blk.slstm, gen)
    return p


# ---------------------------------------------------------------------------
# shared forward pieces
# ---------------------------------------------------------------------------


def embed_inputs(params: Decoder, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d); (B, S, d) frontend embeds pass through."""
    if inputs.dim() == 3:
        return inputs
    return params.embed[inputs.long()]


def logits_from_hidden(params: Decoder, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w = params.embed.T if params.lm_head is None else params.lm_head  # tied: a view
    return h @ w


def _uses_rope(cfg: ModelConfig, i: int) -> bool:
    """iRoPE: layer i skips RoPE when (i + 1) % nope_interval == 0."""
    return not cfg.nope_interval or (i + 1) % cfg.nope_interval != 0


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor,
                 mrope_positions: Optional[torch.Tensor] = None):
    """Angle tables for positions (B, S), shared by every RoPE layer; M-RoPE
    archs take the (3, B, S) streams, text positions when none are given."""
    if cfg.mrope_sections:
        m = text_mrope_positions(positions) if mrope_positions is None else mrope_positions
        return mrope_tables(m, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _attn_block_apply(lp: Block, x, cfg, rt, positions, rope, window: int):
    """-> (x, (k, v), aux losses of this block)."""
    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    a, kv = attention_forward(lp.attn, h, cfg, rt, positions, rope, causal=True,
                              window=window)
    x = x + a
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.n_experts:
        m, aux = moe_forward(lp.moe, h, cfg, rt.moe_dispatch)
    else:
        m, aux = mlp_forward(lp.mlp, h, cfg), {}
    return x + m, kv, aux


def _attn_block_decode(lp: Block, x, cfg, rt, pos, rope, flat_slot, ck, cv, cache_pos,
                       window: int):
    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    x = x + decode_attention(lp.attn, h, pos, rope, flat_slot, ck, cv, cache_pos,
                             window=window)
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.n_experts:  # each row is its own group of one token (C = 8)
        return x + moe_forward(lp.moe, h[:, None], cfg, rt.moe_dispatch, aux=False)[0][:, 0]
    return x + mlp_forward(lp.mlp, h, cfg)


def remat_on(rt: RuntimeFlags, blocks: nn.Module, collect_cache: bool) -> bool:
    """Whether a stack checkpoints its blocks (or groups): under
    `rt.remat`, while autograd records through them (grad mode on,
    parameters that require grad) and no cache is collected."""
    return (rt.remat and not collect_cache and torch.is_grad_enabled()
            and any(p.requires_grad for p in blocks.parameters()))


# ---------------------------------------------------------------------------
# uniform (dense / vlm / moe) stack
# ---------------------------------------------------------------------------


def _uniform_stack(params: Decoder, cfg, rt, x, positions, mrope_positions,
                   collect_cache: bool):
    """-> (x, per-layer (k, v) if collect_cache, aux losses summed over
    layers: zeros-started for moe configs, {} otherwise). Under remat
    (`remat_on`) each block keeps only its input and runs again in the
    backward, as the reference's `jax.checkpoint` around its scanned
    block."""
    window = rt.window_for(cfg.window)
    rope = _rope_tables(cfg, positions, mrope_positions)
    aux = (dict.fromkeys(("moe_lb_loss", "moe_z_loss"),
                         torch.zeros((), dtype=torch.float32, device=x.device))
           if cfg.n_experts else {})
    remat = remat_on(rt, params.layers, collect_cache)
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i, lp in enumerate(params.layers):
        args = (lp, x, cfg, rt, positions, rope if _uses_rope(cfg, i) else None, window)
        x, kv, a = (checkpoint(_attn_block_apply, *args, use_reentrant=False) if remat
                    else _attn_block_apply(*args))
        for name, v in a.items():
            aux[name] = aux[name] + v
        if collect_cache:
            kvs.append(kv)
    return x, kvs, aux


def write_positions(cache: dict, pos: torch.Tensor, window: int) -> torch.Tensor:
    """Write-then-attend decode, step one: the new position goes into
    cache["pos"] before the first layer, so every layer's kernel sees the
    fresh slot. Returns the new token's flat row b * Sc + pos % Sc of each
    layer's (B * Sc, K, dh) cache.

    Writing first equals the reference's two-part softmax whenever the slot
    a step overwrites is one the reference does not attend to: an empty slot
    (pos < Sc), or, in a ring (slot = pos % Sc) that holds the whole window,
    the slot of pos - Sc, outside the window. A step at pos >= Sc into a
    cache smaller than the window would overwrite a slot still inside it,
    so it raises.

    The check reads the positions only where they already are on the host
    (CPU tensors): on the card it would cost a device-to-host sync every
    step. There `InferenceEngine.submit` keeps every position below Sc
    (prompt + new tokens <= max_seq), checked on the host at admission."""
    Sc = cache["pos"].shape[1]
    if window and Sc < window and pos.device.type == "cpu" and int(pos.max()) >= Sc:
        raise ValueError(f"position {int(pos.max())} would wrap a cache of {Sc} slots, "
                         f"smaller than the window {window}")
    slot = (pos % Sc).long()  # ring-buffer slot (full cache: pos < Sc)
    flat_slot = torch.arange(pos.shape[0], device=pos.device) * Sc + slot
    cache["pos"].view(-1).index_copy_(0, flat_slot, pos)
    return flat_slot


def _uniform_decode(params: Decoder, cfg, rt, x, pos, cache: dict):
    window = rt.window_for(cfg.window)
    flat_slot = write_positions(cache, pos, window)
    rope = _rope_tables(cfg, pos[:, None])
    for i, lp in enumerate(params.layers):
        x = _attn_block_decode(
            lp, x, cfg, rt, pos, rope if _uses_rope(cfg, i) else None, flat_slot,
            cache["k"][i], cache["v"][i], cache["pos"], window,
        )
    return x, cache


# ---------------------------------------------------------------------------
# hybrid (zamba2) stack
# ---------------------------------------------------------------------------


def _index_state(states: dict, *idx) -> dict:
    """One layer's state: views into the stacked leaves, so that decode's
    in-place updates land in the cache."""
    return {k: v[idx] for k, v in states.items()}


def _stack_states(states: List[dict]) -> dict:
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _mamba_layer(blk: MambaBlock, x, cfg, rt):
    y, st = mamba2_forward(blk.mamba, rms_norm(x, blk.norm, cfg.norm_eps), cfg,
                           chunk=rt.mamba_chunk)
    return x + y, st


def _mamba_layer_decode(blk: MambaBlock, x, cfg, state):
    return x + mamba2_decode_step(blk.mamba, rms_norm(x, blk.norm, cfg.norm_eps), state,
                                  cfg)[0]


def _hybrid_group(grp: nn.ModuleList, shared: Block, x, cfg, rt, positions, rope, window):
    """One group: its gs Mamba2 layers, then the shared block. -> (x, the
    layers' states, the shared block's (k, v))."""
    sts = []
    for blk in grp:
        x, st = _mamba_layer(blk, x, cfg, rt)
        sts.append(st)
    x, kv, _ = _attn_block_apply(shared, x, cfg, rt, positions, rope, window)
    return x, sts, kv


def _hybrid_stack(params: Decoder, cfg, rt, x, positions, collect_cache: bool):
    """-> (x, (mamba states (ng, gs, B, ...), rest states (rem, B, ...) or
    None, the shared block's per-group (k, v)) if collect_cache, {}). Under
    remat (`remat_on`) each group, its Mamba2 layers and the shared block,
    runs again in the backward, as the reference's `jax.checkpoint` around
    its group; the remainder layers are not checkpointed, as there."""
    window = rt.window_for(cfg.window)
    rope = _rope_tables(cfg, positions)
    remat = remat_on(rt, params, collect_cache)
    groups, kvs = [], []
    for grp in params.mamba_groups:
        args = (grp, params.shared, x, cfg, rt, positions, rope, window)
        if remat:
            x = checkpoint(_hybrid_group, *args, use_reentrant=False)[0]
            continue
        x, sts, kv = _hybrid_group(*args)
        groups.append(sts)
        kvs.append(kv)
    rest = []
    for blk in params.mamba_rest:
        x, st = _mamba_layer(blk, x, cfg, rt)
        rest.append(st)
    if not collect_cache:
        return x, None, {}
    mamba = _stack_states([_stack_states(sts) for sts in groups])
    return x, (mamba, _stack_states(rest) if rest else None, kvs), {}


def _hybrid_decode(params: Decoder, cfg, rt, x, pos, cache: dict):
    window = rt.window_for(cfg.window)
    flat_slot = write_positions(cache, pos, window)
    rope = _rope_tables(cfg, pos[:, None])
    for g, grp in enumerate(params.mamba_groups):
        for i, blk in enumerate(grp):
            x = _mamba_layer_decode(blk, x, cfg, _index_state(cache["mamba"], g, i))
        x = _attn_block_decode(params.shared, x, cfg, rt, pos, rope, flat_slot,
                               cache["k"][g], cache["v"][g], cache["pos"], window)
    for i, blk in enumerate(params.mamba_rest):
        x = _mamba_layer_decode(blk, x, cfg, _index_state(cache["rest"], i))
    return x, cache


# ---------------------------------------------------------------------------
# ssm (xlstm) stack
# ---------------------------------------------------------------------------


def _ssm_group(grp: nn.ModuleList, sblk: SLSTMBlock, x, cfg, rt):
    """One group: its mLSTM layers, then the sLSTM block. -> (x, the mLSTM
    states, the sLSTM state)."""
    sts = []
    for blk in grp:
        y, st = mlstm_forward(blk.mlstm, rms_norm(x, blk.norm, cfg.norm_eps), cfg,
                              chunk=rt.mlstm_chunk)
        x = x + y
        sts.append(st)
    # the sLSTM block: cell + its own gated FFN, inside slstm_forward
    y, sst = slstm_forward(sblk.slstm, rms_norm(x, sblk.norm, cfg.norm_eps), cfg)
    return x + y, sts, sst


def _ssm_stack(params: Decoder, cfg, rt, x, collect_cache: bool):
    """-> (x, (mLSTM states (ng, gs - 1, B, ...), sLSTM states (ng, B, ...))
    if collect_cache, {}). Under remat (`remat_on`) each group runs again in
    the backward, as the reference's `jax.checkpoint` around its group."""
    remat = remat_on(rt, params, collect_cache)
    mstates, sstates = [], []
    for grp, sblk in zip(params.mlstm_groups, params.slstm_blocks):
        if remat:
            x = checkpoint(_ssm_group, grp, sblk, x, cfg, rt, use_reentrant=False)[0]
            continue
        x, sts, sst = _ssm_group(grp, sblk, x, cfg, rt)
        mstates.append(sts)
        sstates.append(sst)
    if not collect_cache:
        return x, None, {}
    return x, (_stack_states([_stack_states(sts) for sts in mstates]),
               _stack_states(sstates)), {}


def _ssm_decode(params: Decoder, cfg, rt, x, cache: dict):
    for g, (grp, sblk) in enumerate(zip(params.mlstm_groups, params.slstm_blocks)):
        for i, blk in enumerate(grp):
            x = x + mlstm_decode_step(blk.mlstm, rms_norm(x, blk.norm, cfg.norm_eps),
                                      _index_state(cache["mlstm"], g, i), cfg)[0]
        x = x + slstm_decode_step(sblk.slstm, rms_norm(x, sblk.norm, cfg.norm_eps),
                                  _index_state(cache["slstm"], g), cfg)[0]
    return x, cache


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _arange_positions(inputs: torch.Tensor, positions: Optional[torch.Tensor]):
    """Prefill positions. The flash kernel assumes arange positions, so a
    call on the card with any other positions raises."""
    B, S = inputs.shape[:2]
    if positions is not None:
        if inputs.is_cuda:
            raise ValueError("explicit positions: the flash kernel takes arange only")
        return positions
    return torch.arange(S, dtype=torch.int32, device=inputs.device).expand(B, S)


def _stack(params: Decoder, cfg, rt, x, positions, mrope_positions, collect_cache: bool):
    """The family's stack -> (x, its cache pieces or None, aux)."""
    if cfg.family in UNIFORM:
        return _uniform_stack(params, cfg, rt, x, positions, mrope_positions, collect_cache)
    if cfg.family == "hybrid":
        return _hybrid_stack(params, cfg, rt, x, positions, collect_cache)
    return _ssm_stack(params, cfg, rt, x, collect_cache)


def decoder_forward(
    params: Decoder,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    inputs: torch.Tensor,  # (B, S) tokens or (B, S, d) embeds
    positions: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
) -> Tuple[torch.Tensor, dict]:
    """Full forward to logits. Returns (logits (B, S, V), aux): the moe
    router losses summed over layers, {} for the other families.

    Differentiable for every decoder-only family (the training path,
    `Model.loss`); prefill and decode run under `torch.no_grad()`, and only
    decode updates recurrent states in place."""
    positions = _arange_positions(inputs, positions)
    x = embed_inputs(params, cfg, inputs)
    x, _, aux = _stack(params, cfg, rt, x, positions, mrope_positions, collect_cache=False)
    return logits_from_hidden(params, cfg, x), aux


def _stacked_zeros(shape_prefix, state: dict) -> dict:
    """One zeroed state per layer: each leaf repeated over `shape_prefix`."""
    return {k: v.new_empty((*shape_prefix, *v.shape)).copy_(v) for k, v in state.items()}


def init_decode_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device, dtype=None
) -> dict:
    """Zeroed decode cache, every attention slot empty (pos -1), every
    recurrent state at its start (`init_mamba_state`, `init_mlstm_state`,
    `init_slstm_state`).

    cache_len: KV capacity (== seq_len, or window size for ring caches)."""
    dtype = dtype or DTYPES[cfg.dtype]
    ng, gs, rem = group_shape(cfg)

    def attn_cache(n_layers):
        shape = (n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
        }

    if cfg.family in UNIFORM:
        return attn_cache(cfg.n_layers)
    if cfg.family == "hybrid":
        cache = attn_cache(ng)
        st1 = init_mamba_state(cfg, batch, device, dtype)
        cache["mamba"] = _stacked_zeros((ng, gs), st1)
        if rem:
            cache["rest"] = _stacked_zeros((rem,), st1)
        return cache
    if cfg.family == "ssm":
        return {"mlstm": _stacked_zeros((ng, gs - 1), init_mlstm_state(cfg, batch, device, dtype)),
                "slstm": _stacked_zeros((ng,), init_slstm_state(cfg, batch, device))}
    raise ValueError(f"family {cfg.family!r}: enc-dec caches are `encdec.init_encdec_cache`")


@torch.no_grad()
def decoder_prefill(
    params: Decoder,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    inputs: torch.Tensor,  # (B, S) tokens or (B, S, d) embeds
    positions: Optional[torch.Tensor] = None,
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
) -> Tuple[torch.Tensor, dict]:
    """Process the prompt; returns (last-position logits (B, V), cache)."""
    positions = _arange_positions(inputs, positions)
    x = embed_inputs(params, cfg, inputs)
    x, pieces, _ = _stack(params, cfg, rt, x, positions, mrope_positions, collect_cache=True)
    if cfg.family == "ssm":
        cache = {"mlstm": pieces[0], "slstm": pieces[1]}
    else:
        kvs = pieces if cfg.family in UNIFORM else pieces[2]
        cache = {
            "k": torch.stack([k for k, _ in kvs]),  # (L or ng, B, S, K, dh)
            "v": torch.stack([v for _, v in kvs]),
            "pos": positions.to(torch.int32).contiguous(),
        }
        if cfg.family == "hybrid":
            cache["mamba"] = pieces[0]
            if pieces[1] is not None:
                cache["rest"] = pieces[1]
    return logits_from_hidden(params, cfg, x[:, -1]), cache


@torch.no_grad()
def decoder_decode(
    params: Decoder,
    cfg: ModelConfig,
    rt: RuntimeFlags,
    cache: dict,
    token: torch.Tensor,  # (B,) int tokens or (B, d) embeds (vlm)
    pos: torch.Tensor,  # (B,) int32
) -> Tuple[torch.Tensor, dict]:
    """One decode step: returns (logits (B, V), the cache updated in place)."""
    if cfg.embeds_input and token.dim() == 2:
        x = token
    else:
        x = params.embed[token.long()]
    pos = pos.to(torch.int32)
    if cfg.family in UNIFORM:
        x, cache = _uniform_decode(params, cfg, rt, x, pos, cache)
    elif cfg.family == "hybrid":
        x, cache = _hybrid_decode(params, cfg, rt, x, pos, cache)
    else:
        x, cache = _ssm_decode(params, cfg, rt, x, cache)
    return logits_from_hidden(params, cfg, x), cache
