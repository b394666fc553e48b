"""Shared building blocks for the port's models (counterpart of
`repro/models/common.py`).

Parameters live in `nn.Module`s that mirror the reference's nested dicts
leaf for leaf; the compute is plain functions on tensors. Every parameter is
created with `requires_grad=False`, so serving builds no autograd graph;
training turns gradients on (`training.train_loop`), and every family's
forward is differentiable (`Model.loss`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..sharding import Axes

__all__ = [
    "DTYPES",
    "RuntimeFlags",
    "resolve_device",
    "param",
    "init_normal_",
    "rms_norm",
    "activation_fn",
]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """Per-invocation execution knobs (orthogonal to the architecture).

    The same fields as the reference's. The port runs `attention_impl` in
    {auto, naive, chunked, pallas} ("pallas" names the flash kernel, as in
    the reference), `window_override` (ring caches), `moe_dispatch`
    (scatter or einsum, `models/moe.py`), the chunk lengths of the chunked
    scans, `mamba_chunk` (`models/mamba2.py`) and `mlstm_chunk`
    (`models/xlstm.py`), and `remat`: while a gradient is recorded, each
    block (dense/vlm/moe, each encoder and decoder layer) or group (zamba2,
    xlstm) is recomputed in the backward (`torch.utils.checkpoint`), as the
    reference's `jax.checkpoint`. `attn_seq_shard` (context-parallel
    attention under the rule sets that map "attn_q_seq") cuts the query
    rows under a mesh: each rank's attention core, Q/K/V projections and
    dense MLP run on its own contiguous block of rows, K and V gathered
    over the sequence (`attention.attention_forward`, `mlp.mlp_forward`),
    where the reference pins its attention output's query-seq dim and
    GSPMD carries the cut."""

    attention_impl: str = "auto"  # auto | naive | chunked | pallas
    q_chunk: int = 1024
    kv_chunk: int = 1024
    mamba_chunk: int = 256
    mlstm_chunk: int = 256
    window_override: int = 0  # force sliding-window serving (long_500k dense)
    remat: bool = True  # activation checkpointing around each layer (train)
    naive_below: int = 2048  # "auto" uses naive attention below this seq len
    moe_dispatch: str = "scatter"  # scatter | einsum (Mesh-TF baseline)
    attn_seq_shard: bool = False  # context parallelism over the model axis

    def attn_impl_for(self, seq: int, on_cuda: bool, grad: bool = False) -> str:
        """"auto" takes the flash kernel on the card and, on the CPU or while
        a gradient is recorded (`grad`), the reference's rule: naive up to
        `naive_below` keys, chunked above. The flash kernel has no backward
        (nor has the reference's), so "pallas" under a gradient raises."""
        impl = self.attention_impl
        if impl == "auto":
            if on_cuda and not grad:
                return "pallas"
            return "naive" if seq <= self.naive_below else "chunked"
        if impl not in ("naive", "chunked", "pallas"):
            raise ValueError(f"unknown attention_impl {impl!r}")
        if impl == "pallas" and grad:
            raise ValueError("attention_impl='pallas': the flash kernel has no backward; "
                             "train with 'auto', 'naive' or 'chunked'")
        return impl

    def window_for(self, cfg_window: int) -> int:
        return self.window_override or cfg_window


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def param(shape: Sequence[int], axes: Sequence[Optional[str]], device, dtype) -> nn.Parameter:
    """An uninitialised parameter, created without gradients (serving
    records none; `training.train_loop` turns them on). `axes` are its
    logical axes in the reference's vocabulary ("p_embed", "p_heads", ...),
    kept as `p.axes` (`Model.param_axes` reads them; `sharding` resolves
    them to a layout on a mesh)."""
    assert len(shape) == len(axes), (shape, axes)
    p = nn.Parameter(torch.empty(tuple(shape), device=device, dtype=dtype), requires_grad=False)
    p.axes = Axes(axes)
    return p


@torch.no_grad()
def init_normal_(p: torch.Tensor, gen: Optional[torch.Generator],
                 scale: Optional[float] = None) -> None:
    """N(0, scale^2) drawn in f32 on p's device, then cast: the reference's
    `Initializer.param` (fan-in scale on the leading dim by default). A meta
    tensor holds no values, so nothing is drawn for it (`gen` is None)."""
    if p.device.type == "meta":
        return
    if scale is None:
        scale = 1.0 / math.sqrt(p.shape[0])
    z = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
    p.copy_(z.mul_(scale))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm through the kernel on the card, its plain version on the CPU."""
    return ops.rmsnorm(x, gamma, eps)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")
