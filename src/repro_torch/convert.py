"""Weights and caches from the JAX package, as numpy, into the port.

The reference keeps its parameters as a nested dict whose per-layer leaves
carry leading layer axes (`repro.models.model.Model.init`); the port splits
them into `nn.ModuleList`s of blocks, one index per axis (`STACKED`):

    {"layers": {"attn": {"wq": (L, d, H, dh)}}}          ->  "layers.{i}.attn.wq"
    {"mamba_groups": {"mamba": {"w_x": (ng, gs, d, di)}}} ->  "mamba_groups.{g}.{i}.mamba.w_x"
    {"mamba_rest": ...: (rem, ...)}, {"slstm_blocks": ...: (ng, ...)},
    {"mlstm_groups": ...: (ng, gs - 1, ...)}, {"enc_layers": ...: (Le, ...)},
    {"dec_layers": ...: (L, ...)}

Unstacked subtrees (`shared`, zamba2's one shared attention block; the
embeddings and norms) keep their paths. Optional leaves follow the config on
both sides: QKV biases (`bq`, `bk`, `bv`), `w3` only for gated MLPs,
`lm_head` only without tied embeddings. A moe block's leaves keep their
expert axis behind the layer axis:

    {"layers": {"moe": {"w1": (L, E, d, f)}}}  ->  "layers.{i}.moe.w1" (E, d, f)

Every leaf must map onto a parameter and back (`load_state_dict(strict=True)`).

Decode caches keep the reference's layout as it is, nested dicts included:
{"k", "v", "pos"}, plus the hybrid family's Mamba2 states {"mamba",
"rest"}, the ssm family's {"mlstm", "slstm"}, and enc-dec's
{"cross_k", "cross_v", "cross_pos"}.

Callers hand over numpy arrays (`jax.tree.map(np.asarray, params)`), so this
module needs no JAX. bf16 crosses as its raw bits through a uint16 view.

The way back: `restack` joins per-layer tensors keyed by the port's names
(parameters, or the optimizer's moments, which share their keys) along the
`STACKED` axes into the reference's nested layout, and `export_params` gives
that tree as numpy (bf16 as its raw bits, uint16), the inverse of
`convert_params`. `reference_key` maps one port name to its reference leaf
and index, and `reference_rank` gives that leaf's rank (the optimizer's
decay rule reads it). `training/checkpoint.py` writes the reference's
checkpoint format through these.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .configs.base import ModelConfig
from .models.common import resolve_device
from .models.encdec import EncDec
from .models.transformer import Decoder

__all__ = ["to_tensor", "to_numpy", "convert_params", "convert_cache", "STACKED",
           "reference_key", "reference_rank", "restack", "export_params"]

# Subtrees whose leaves carry leading layer axes, and how many.
STACKED = {"layers": 1, "mamba_groups": 2, "mamba_rest": 1, "mlstm_groups": 2,
           "slstm_blocks": 1, "enc_layers": 1, "dec_layers": 1}


def to_tensor(a: Any, device) -> torch.Tensor:
    """One numpy array (or anything `np.asarray` takes) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same values; bf16 as its raw bits
    (a uint16 array: numpy has no bf16 without ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def reference_key(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A port parameter name -> (the reference leaf's path, the index along
    its stacked axes): "layers.3.attn.wq" -> (("layers", "attn", "wq"), (3,)),
    "final_norm" -> (("final_norm",), ())."""
    top, *rest = name.split(".")
    n_axes = STACKED.get(top, 0) if rest else 0
    return (top, *rest[n_axes:]), tuple(int(i) for i in rest[:n_axes])


def reference_rank(name: str, t: torch.Tensor) -> int:
    """The rank of the reference leaf that `t` (named `name`) is a slice of."""
    return t.dim() + len(reference_key(name)[1])


def restack(named: Mapping[str, torch.Tensor], device="cpu") -> Dict[str, Any]:
    """Tensors keyed by the port's names -> the reference's nested dict, the
    per-layer tensors stacked along their leading layer axes, on `device`."""
    groups: Dict[Tuple[str, ...], Dict[Tuple[int, ...], torch.Tensor]] = {}
    for name, t in named.items():
        path, idx = reference_key(name)
        groups.setdefault(path, {})[idx] = t
    tree: Dict[str, Any] = {}
    for path, pieces in groups.items():
        if list(pieces) == [()]:
            leaf = pieces[()].detach().to(device)
        else:
            lead = tuple(max(i[a] for i in pieces) + 1 for a in range(len(next(iter(pieces)))))
            if sorted(pieces) != list(np.ndindex(*lead)):
                raise ValueError(f"{'/'.join(path)}: layer indices {sorted(pieces)} are not "
                                 f"a full {lead} grid")
            flat = torch.stack([pieces[i].detach().to(device) for i in np.ndindex(*lead)])
            leaf = flat.reshape(*lead, *flat.shape[1:])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _map_leaves(fn, tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _map_leaves(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def export_params(module: torch.nn.Module) -> Dict[str, Any]:
    """The port's parameters -> the reference's nested params dict as numpy
    (bf16 as uint16 raw bits): the inverse of `convert_params`."""
    return _map_leaves(to_numpy, restack(dict(module.named_parameters())))


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@torch.no_grad()
def convert_params(params: Mapping[str, Any], cfg: ModelConfig, device="cuda"):
    """JAX params (numpy leaves) -> the port's `Decoder`, or `EncDec` for an
    enc-dec config, in the arrays' own dtype."""
    dev = resolve_device(device)
    state: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(params).items():
        top, _, leaf = name.partition(".")
        n_axes = STACKED.get(top, 0) if leaf else 0
        arr = np.asarray(arr)
        if not n_axes:
            state[name] = to_tensor(arr, dev)
            continue
        for idx in np.ndindex(*arr.shape[:n_axes]):
            state[".".join([top, *map(str, idx), leaf])] = to_tensor(arr[idx], dev)
    cls = EncDec if cfg.n_encoder_layers else Decoder
    model = cls(cfg, device=dev, dtype=state["embed"].dtype)
    model.load_state_dict(state, strict=True)
    return model


def convert_cache(cache: Mapping[str, Any], device="cuda") -> dict:
    """A JAX decode cache (numpy leaves, nested dicts for recurrent states)
    -> the same tree of tensors; positions as int32."""
    dev = resolve_device(device)

    def conv(name, a):
        if isinstance(a, Mapping):
            return {k: conv(k, v) for k, v in a.items()}
        t = to_tensor(a, dev)
        return t.to(torch.int32) if name.endswith("pos") else t

    return {k: conv(k, v) for k, v in cache.items()}
