"""AdamW with decoupled weight decay and f32 moments (counterpart of
`repro/training/optimizer.py`, the same arithmetic).

Moments are f32 whatever the parameter's dtype; the update is computed in
f32 and cast back to it. The reference returns new trees; here the
parameters, the moments and the gradients are updated in place (at full
width every copy is gigabytes), and the functions return them.

State is keyed by the module's parameter names:
{"mu": {name: f32}, "nu": {name: f32}, "step": int32 scalar}. Under a mesh
(parameters that are DTensors, `Model.distribute_params`) the moments are
DTensors placed like their parameters, so the update runs on local shards
with no collective; the clip's norm is reduced over every leaf's shards.

Decay follows the reference's rule, matrices only (`ndim >= 2`), read on
the REFERENCE leaf: the reference stacks per-layer leaves along layer axes,
so a block's norm gamma is (L, d) there and decays, while `final_norm` (d,)
does not. The port holds one (d,) gamma per block, so the rank is the
tensor's own plus the stacked axes of its subtree (`convert.reference_rank`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..convert import reference_rank
from ..sharding import replicated_like, whole

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup + cosine decay to min_lr_frac * lr (f32)."""
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(self.warmup_steps, 1), max=1.0)
        t = torch.clamp(
            (s - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0
        )
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        frac = self.min_lr_frac + (1.0 - self.min_lr_frac) * cos
        return self.lr * warm * frac


def adamw_init(params: nn.Module) -> dict:
    """Zero f32 moments beside every parameter, each placed like it (a
    DTensor parameter's moments are DTensors of its placements, the
    reference's rule), and step 0."""
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    return {
        "mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()},
        "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor],
                        max_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global norm), in f32 and
    rounded to the gradient's dtype, in place. Returns (grads, norm). A
    DTensor leaf's sum of squares is reduced over its shards, so the norm
    (a plain scalar, the same on every rank) is the whole gradient's."""
    gnorm = torch.sqrt(sum(whole(torch.sum(torch.square(g.float()))) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.float().mul_(replicated_like(g, scale)))  # one rounding to g's dtype
    return grads, gnorm


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: nn.Module, grads: Dict[str, torch.Tensor], state: dict
) -> Tuple[nn.Module, dict, dict]:
    """One step over every parameter, with `grads` keyed by parameter name
    and placed like their parameters. -> (params, state, metrics
    {"grad_norm", "lr"}), all updated in place. The step, lr and bias
    corrections are scalars on the parameters' device, replicated on their
    mesh where they are DTensors; the metrics are plain scalars."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)
    first = next(iter(params.parameters()))
    lr_p, bc1, bc2 = (replicated_like(first, t) for t in (lr, bc1, bc2))
    for name, p in params.named_parameters():
        g32 = grads[name].float()
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(b1).add_(g32, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        delta = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        if reference_rank(name, p) >= 2:  # decay matrices only (norms/biases exempt)
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(delta.mul_(lr_p)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
