"""Training step and loop: loss -> grad -> clip -> AdamW (counterpart of
`repro/training/loop.py`).

`make_train_step(model, opt_cfg)` returns the step that `train_loop`,
`launch/train.py` and `examples/train_small_torch.py` run. PyTorch runs
eagerly, so there is no jit; parameters, moments and gradients are updated
in place. Everything runs on the device the parameters live on; `Model.init`
puts them on the card unless asked for the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from .. import sharding as sh
from ..models.model import Model
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import DataConfig, SyntheticLM
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "train_loop", "model_batch"]


def model_batch(model: Model, batch: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The stream's {"tokens", "labels"} as `model.loss` takes them, as the
    reference's loop builds them: frontend-stub archs (`embeds_input`) get
    the tokens hashed into one-hot embeddings of d_model (in `dtype`, the
    parameters': torch does not promote f32 @ bf16), which enc-dec archs
    take as encoder frames, with the labels as decoder tokens."""
    if not (model.cfg.embeds_input and "tokens" in batch):
        return batch
    batch = dict(batch)
    emb = F.one_hot((batch.pop("tokens") % model.cfg.d_model).long(),
                    model.cfg.d_model).to(dtype)
    if model.is_encdec:
        batch["enc_embeds"] = emb
        batch["dec_tokens"] = batch["labels"]
    else:
        batch["embeds"] = emb
    return batch


def make_train_step(
    model: Model, opt_cfg: AdamWConfig, microbatches: int = 1
) -> Callable[[nn.Module, dict, Dict[str, torch.Tensor]],
              Tuple[nn.Module, dict, Dict[str, torch.Tensor]]]:
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics).

    Every parameter must require grad. microbatches > 1: gradient
    accumulation over equal slices of the batch's leading axis, each slice's
    gradient taken by `torch.autograd.grad` and summed in f32, then divided
    by the count, as the reference's scan (PyTorch's own `.grad`
    accumulation would add in the parameter's dtype); the optimizer then
    sees f32 gradients, as the reference's does. Metrics are device
    tensors: "loss", "grad_norm", "lr" and the moe aux losses.

    Under a mesh (`sharding.use_mesh`, parameters from
    `Model.distribute_params` of parameters that require grad), `Model.loss` puts
    each slice of the batch on the mesh by its axes, so each slice is
    sharded over the batch's data axes; every gradient, a DTensor, is
    placed like its parameter (a partial sum reduced, FSDP's reduce to
    the parameter's shard), the slices' f32 sums are DTensors too, and the
    metrics are plain scalars, the same on every rank."""

    def grads_of(params, names, leaves, batch):
        loss, aux = model.loss(params, batch)
        g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        g = [sh.redistribute(gi, p.placements) if isinstance(gi, DTensor) else gi
             for gi, p in zip(g, leaves)]
        return (sh.whole(loss.detach()), {k: sh.whole(v.detach()) for k, v in aux.items()},
                dict(zip(names, g)))

    def step(params, opt_state, batch):
        names, leaves = zip(*params.named_parameters())
        if microbatches == 1:
            loss, aux, grads = grads_of(params, names, leaves, batch)
        else:
            losses, auxes, gsum = [], [], None
            for b in zip(*(v.chunk(microbatches) for v in batch.values())):
                loss_i, aux_i, g = grads_of(params, names, leaves, dict(zip(batch, b)))
                losses.append(loss_i)
                auxes.append(aux_i)
                if gsum is None:
                    gsum = {n: gi.float() for n, gi in g.items()}
                else:
                    for n, gi in g.items():
                        gsum[n].add_(gi.float())
            grads = {n: s.div_(microbatches) for n, s in gsum.items()}
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om, **aux}

    return step


def train_loop(
    model: Model,
    data_cfg: DataConfig,
    opt_cfg: AdamWConfig,
    n_steps: int,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    params: Optional[nn.Module] = None,
) -> Tuple[nn.Module, list]:
    """The reference's loop. Returns (params, metric history). `params`
    defaults to `model.init(seed)`, on the card; pass parameters of your own
    (for example on the CPU, or converted from the reference) to train them
    where they live. With `ckpt_dir`, the latest checkpoint there (either
    package's) is restored into params and optimizer state first.

    Under a mesh, given distributed parameters (`Model.distribute_params`),
    the loop trains them as DTensors (`make_train_step`); the stream's
    batches, the same on every rank, go on the mesh in `Model.loss`.
    Checkpoints of distributed parameters are not written or read: with
    `ckpt_dir` that raises."""
    if params is None:
        params = model.init(seed)
    if ckpt_dir and isinstance(params.embed, DTensor):
        raise ValueError("train_loop: checkpoints of distributed parameters are not supported "
                         "(a checkpoint holds whole tensors; gather them first)")
    params.requires_grad_(True)
    device = next(params.parameters()).device
    opt_state = adamw_init(params)
    start = 0
    if ckpt_dir:
        try:
            (params, opt_state), start = restore_checkpoint(ckpt_dir, (params, opt_state))
            log_fn(f"restored step {start} from {ckpt_dir}")
        except FileNotFoundError:
            pass
    step_fn = make_train_step(model, opt_cfg)
    data = SyntheticLM(data_cfg)
    hist = []
    t0 = time.perf_counter()
    for s in range(start, n_steps):
        batch = model_batch(model, {k: torch.from_numpy(v).to(device)
                                    for k, v in data.batch(s).items()}, params.embed.dtype)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if s % log_every == 0 or s == n_steps - 1:
            m = {k: float(v) for k, v in m.items()}
            m["step"] = s
            m["wall_s"] = round(time.perf_counter() - t0, 2)
            hist.append(m)
            log_fn(
                f"step {s:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                f"lr {m['lr']:.2e} ({m['wall_s']}s)"
            )
        if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, s + 1, (params, opt_state))
    return params, hist
