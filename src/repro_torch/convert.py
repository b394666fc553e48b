"""Weights and caches from the JAX package, as numpy, into the port.

The reference keeps its parameters as a nested dict whose per-layer leaves
carry a leading layer axis (`repro.models.model.Model.init`); the port
splits that axis into `Decoder.layers[i]` (an `nn.ModuleList`):

    {"layers": {"attn": {"wq": (L, d, H, dh)}}}  ->  "layers.{i}.attn.wq"

Optional leaves follow the config on both sides: QKV biases (`bq`, `bk`,
`bv`), `w3` only for gated MLPs, `lm_head` only without tied embeddings.
A moe block's leaves keep their expert axis behind the layer axis:

    {"layers": {"moe": {"w1": (L, E, d, f)}}}  ->  "layers.{i}.moe.w1" (E, d, f)

The decode cache keeps the reference's layout as it is:
{"k", "v": (L, B, Sc, K, dh), "pos": (B, Sc) int32}.

Callers hand over numpy arrays (`jax.tree.map(np.asarray, params)`), so this
module needs no JAX. bf16 crosses as its raw bits through a uint16 view.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.common import resolve_device
from .models.transformer import Decoder

__all__ = ["to_tensor", "convert_params", "convert_cache"]


def to_tensor(a: Any, device) -> torch.Tensor:
    """One numpy array (or anything `np.asarray` takes) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@torch.no_grad()
def convert_params(params: Mapping[str, Any], cfg: ModelConfig, device="cuda") -> Decoder:
    """JAX decoder params (numpy leaves) -> the port's `Decoder`, in the
    arrays' own dtype. Every leaf must map onto a parameter and back."""
    dev = resolve_device(device)
    flat = _flatten(params)
    state: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        if name.startswith("layers."):
            leaf = name[len("layers."):]
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{leaf}"] = to_tensor(np.asarray(arr)[i], dev)
        else:
            state[name] = to_tensor(arr, dev)
    dec = Decoder(cfg, device=dev, dtype=state["embed"].dtype)
    dec.load_state_dict(state, strict=True)
    return dec


def convert_cache(cache: Mapping[str, Any], device="cuda") -> dict:
    """JAX decode cache {"k", "v", "pos"} (numpy leaves) -> tensors."""
    dev = resolve_device(device)
    return {
        "k": to_tensor(cache["k"], dev),
        "v": to_tensor(cache["v"], dev),
        "pos": to_tensor(cache["pos"], dev).to(torch.int32),
    }
