"""Checkpoints in the reference's flat-npz format (counterpart of
`repro/training/checkpoint.py`), so that either package restores the other's.

One .npz per step, `ckpt_<step:08d>.npz`, committed by an atomic rename. The
tree is train_loop's (params, adamw state); its leaves are stored under the
reference's paths and layout: "0/<param path>", "1/mu/<param path>",
"1/nu/<param path>" and "1/step", with the per-layer tensors restacked
along the reference's layer axes (`convert.restack`) and the keys in the
order the reference's `jax.tree_util` flattening gives them. A bf16 leaf is
stored as its bytes, a uint8 array shaped (..., 2), beside a
"<key>.__dtype__" entry holding "bfloat16"; this module reads and writes
that without `ml_dtypes`, which the card machine lacks.

Entries are written one leaf at a time and each subtree is restacked on the
host only while it is written, so saving never holds the whole state twice.
"""

from __future__ import annotations

import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import reference_key, restack

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "/"
_BF16 = "bfloat16"


def _subtrees(tree: Tuple[Any, ...]) -> Iterator[Tuple[str, Any]]:
    """(key prefix, port-named tensors or one tensor) for (params, adamw
    state), in the reference's order."""
    for i, part in enumerate(tree):
        if isinstance(part, nn.Module):
            yield str(i), dict(part.named_parameters())
        elif isinstance(part, Mapping) and set(part) == {"mu", "nu", "step"}:
            yield f"{i}{_SEP}mu", part["mu"]
            yield f"{i}{_SEP}nu", part["nu"]
            yield f"{i}{_SEP}step", part["step"]
        else:
            raise TypeError(f"checkpoint tree item {i}: a model module or an adamw state, "
                            f"not {type(part).__name__}")


def _flat(prefix: str, node: Any) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(node, Mapping):
        for k in sorted(node):  # jax.tree_util flattens dicts in sorted key order
            yield from _flat(f"{prefix}{_SEP}{k}", node[k])
    else:
        yield prefix, node


def _write(zf: zipfile.ZipFile, key: str, t: torch.Tensor) -> None:
    """One leaf as np.savez writes it; bf16 as a uint8 byte view (..., 2)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        _write_array(zf, key + ".__dtype__", np.asarray(_BF16))
        arr = t.view(torch.uint8).numpy().reshape(tuple(t.shape) + (2,))
    else:
        arr = t.numpy()
    _write_array(zf, key, arr)


def _write_array(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        np.lib.format.write_array(fid, np.asanyarray(arr), allow_pickle=False)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tuple[Any, ...]) -> str:
    """Write `tree` = (params module, adamw state) as step `step`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f, \
                zipfile.ZipFile(f, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
            for prefix, sub in _subtrees(tree):
                nested = restack(sub) if isinstance(sub, Mapping) else sub
                for key, t in _flat(prefix, nested):
                    _write(zf, key, t)
                del nested
        os.replace(tmp, final)  # atomic commit
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f))
    ]
    return max(steps) if steps else None


def _read(data, key: str, path: str) -> torch.Tensor:
    """One stored leaf as a CPU tensor; a bf16 byte view back to bf16."""
    if key not in data:
        raise KeyError(f"checkpoint {path} missing {key}")
    arr = data[key]
    tag = key + ".__dtype__"
    if tag in data:
        name = str(data[tag])
        if name != _BF16:
            raise ValueError(f"{key}: stored dtype {name!r}; only bfloat16 is read back here")
        return torch.from_numpy(np.require(arr, requirements="C").view(np.uint16)[..., 0]).view(
            torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))  # keeps 0-d arrays 0-d


@torch.no_grad()
def restore_checkpoint(
    ckpt_dir: str, template: Tuple[Any, ...], step: Optional[int] = None
) -> Tuple[Tuple[Any, ...], int]:
    """Restore into `template` = (params module, adamw state), in place, on
    its devices and in its dtypes; returns (template, step). Every leaf the
    template holds must be in the file with the reference's shape."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        for prefix, sub in _subtrees(template):
            named = sub if isinstance(sub, Mapping) else {"": sub}
            groups: Dict[str, List[Tuple[Tuple[int, ...], torch.Tensor]]] = {}
            for name, t in named.items():
                ref_path, idx = reference_key(name) if name else ((), ())
                groups.setdefault(_SEP.join((prefix,) + ref_path), []).append((idx, t))
            for key, pieces in groups.items():
                src = _read(data, key, path)
                lead = tuple(max(i[a] for i, _ in pieces) + 1 for a in range(len(pieces[0][0])))
                want = lead + tuple(pieces[0][1].shape)
                if tuple(src.shape) != want:
                    raise ValueError(f"{key}: ckpt {tuple(src.shape)} != template {want}")
                for idx, t in pieces:
                    t.copy_(src[idx])
    return template, step
