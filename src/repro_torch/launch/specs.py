"""Assigned input shapes -> a step and its arguments on the meta device
(the port's copy of `repro/launch/specs.py`).

The four assigned shapes:

    train_4k     seq   4,096  global_batch 256  (training)
    prefill_32k  seq  32,768  global_batch  32  (inference prefill)
    decode_32k   seq  32,768  global_batch 128  (decode, KV cache = seq)
    long_500k    seq 524,288  global_batch   1  (long-context decode)

`build_case(arch, shape)` resolves applicability (the single documented
skip), the runtime flags (chunked attention for 32k+; the sliding-window
serving variant for full-attention archs at 500k) and returns the step
callable with its arguments as meta tensors: shapes and dtypes, no values,
no memory. The reference's sharding (rule sets, logical axes) has no
counterpart on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..configs import ModelConfig, get_config
from ..models import Model, RuntimeFlags, build_model
from ..models.common import DTYPES
from ..training import AdamWConfig, adamw_init, make_train_step

__all__ = [
    "LONG_WINDOW",
    "SHAPES",
    "ShapeSpec",
    "Case",
    "build_case",
    "applicable",
    "skip_reason",
    "input_specs",
]

META = torch.device("meta")

# sliding window used by the long_500k serving variant of full-attention archs
LONG_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """The single documented skip."""
    if shape.name == "long_500k" and cfg.n_encoder_layers:
        return (
            "long_500k x enc-dec (seamless): 500k source frames through a "
            "full-attention encoder has no sub-quadratic variant in this "
            "family; documented skip."
        )
    return None


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    return skip_reason(cfg, shape) is None


def _runtime_for(cfg: ModelConfig, shape: ShapeSpec) -> RuntimeFlags:
    window_override = 0
    if shape.name == "long_500k" and cfg.family in ("dense", "vlm", "moe"):
        # full-attention families run the sliding-window serving variant;
        # mixtral's native SWA (4096) already bounds the cache.
        if not cfg.window:
            window_override = LONG_WINDOW
    impl = "chunked" if shape.seq > 8192 else "auto"
    return RuntimeFlags(
        attention_impl=impl,
        window_override=window_override,
        remat=(shape.kind == "train"),
    )


def _cache_len(cfg: ModelConfig, shape: ShapeSpec, rt: RuntimeFlags) -> int:
    win = rt.window_override or cfg.window
    if win:
        return min(shape.seq, win)
    return shape.seq


@dataclasses.dataclass
class Case:
    """One (arch x shape) case on the meta device: `step(*args)` is the
    step a driver runs. train: (params, AdamW state, batch); prefill:
    (params, prompt); decode: (params, cache, token, pos). The reference's
    `donate` has no counterpart: the port's optimizer and decode update
    their state in place."""

    arch: str
    cfg: ModelConfig
    shape: ShapeSpec
    model: Model
    step: Callable
    args: tuple


def _batch_inputs(cfg: ModelConfig, shape: ShapeSpec, with_labels: bool) -> Dict[str, Any]:
    """Meta train/prefill inputs for one architecture."""
    B, S = shape.batch, shape.seq
    tok = torch.empty((B, S), dtype=torch.int32, device=META)
    emb = torch.empty((B, S, cfg.d_model), dtype=DTYPES[cfg.dtype], device=META)
    if cfg.n_encoder_layers:
        batch = {"enc_embeds": emb, "dec_tokens": tok}
    elif cfg.embeds_input:
        batch = {"embeds": emb}
    else:
        batch = {"tokens": tok}
    if with_labels:
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    return batch


def input_specs(arch: str, shape_name: str) -> tuple:
    """Meta stand-ins for every input of the (arch x shape) step: for a
    training step (params, opt_state, {tokens, labels}); for decode
    (params, cache, token, pos)."""
    return build_case(arch, shape_name).args


def build_case(
    arch: str,
    shape: Union[str, ShapeSpec],
    opt_cfg: Optional[AdamWConfig] = None,
    rt_override: Optional[RuntimeFlags] = None,
    rt_kwargs: Optional[dict] = None,
    microbatches: int = 1,
    cfg_kwargs: Optional[dict] = None,
) -> Case:
    """`shape`: a name of SHAPES or a ShapeSpec of its own; `cfg_kwargs`
    replaces fields of the arch's config (a depth cut)."""
    cfg = get_config(arch)
    if cfg_kwargs:
        cfg = dataclasses.replace(cfg, **cfg_kwargs)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"skipped: {reason}")
    rt = rt_override or _runtime_for(cfg, shape)
    if rt_kwargs:
        rt = dataclasses.replace(rt, **rt_kwargs)
    model = build_model(cfg, rt)
    params = model.init(device=META)

    if shape.kind == "train":
        params.requires_grad_(True)
        step = make_train_step(model, opt_cfg or AdamWConfig(), microbatches=microbatches)
        batch = _batch_inputs(cfg, shape, with_labels=True)
        return Case(arch, cfg, shape, model, step, (params, adamw_init(params), batch))

    if shape.kind == "prefill":
        batch = _batch_inputs(cfg, shape, with_labels=False)
        prompt = batch if cfg.n_encoder_layers else next(iter(batch.values()))
        return Case(arch, cfg, shape, model, model.prefill, (params, prompt))

    # decode
    B = shape.batch
    clen = _cache_len(cfg, shape, rt)
    enc_len = shape.seq if cfg.n_encoder_layers else 0
    cache = model.init_cache(B, clen, device=META, enc_len=enc_len)
    tok = torch.empty((B,), dtype=torch.int32, device=META)
    pos = torch.empty((B,), dtype=torch.int32, device=META)
    return Case(arch, cfg, shape, model, model.decode, (params, cache, tok, pos))
