"""Roofline terms of one step on one NVIDIA H100 (the port's copy of
`repro/launch/roofline.py`).

Per (arch x shape), from the dry run's cost record (`launch.cost_analysis`,
counted on the meta device):

    compute term    = dot FLOPs / peak FLOP/s
    memory term     = dot traffic / HBM bandwidth
    collective term = collective bytes / link bandwidth   (0 on one card)

all per device. On the production meshes (`launch.dryrun --mesh`) the dry
run counts one device's step under DTensor: its dot FLOPs and traffic on
its local shards and its collective bytes, weighted by class, summed
(`StepCost.total_collective_bytes`, the reference's
`total_collective_bytes`) over one `link_bw`, as the reference divides by
its one ICI rate: nothing models links that cross nodes.

`model_flops` is the paper-standard accounting, equal to the reference's:
6 N_active T to train, 2 N_active T to prefill, 2 N_active B to decode.
The ratio model_flops / (chips x counted FLOPs) exposes remat and other
work the model's accounting does not count.

Hardware: `H100`, the SXM part's data sheet (dense rates, no sparsity, at
its 700 W power limit); `chip_smoke.py` takes its kernel bounds from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..configs.base import ModelConfig
from .specs import ShapeSpec

__all__ = ["H100", "HwSpec", "RooflineTerms", "derive_roofline", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HwSpec:
    flops: float  # dense bf16 FLOP/s
    flops_f32: float  # float32 FLOP/s outside the tensor cores
    hbm_bw: float  # B/s
    link_bw: float  # B/s a direction between two cards
    hbm_bytes: float  # device memory


# 989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s, NVLink 450 GB/s a direction;
# hbm_bytes is the memory CUDA reports on an H100 80GB HBM3 (torch's
# `total_memory`; chip_smoke.py phase 8 holds the two within 1%)
H100 = HwSpec(flops=989e12, flops_f32=67e12, hbm_bw=3.35e12, link_bw=450e9,
              hbm_bytes=85_017_493_504)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Paper-standard useful FLOPs per step (6ND train / 2ND inference)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.batch


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    counted_flops_device: float
    dot_bytes_device: float
    collective_bytes_device: float
    chips: int
    useful_ratio: float  # model_flops / (chips * counted_flops_device)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap upper bound on step time."""
        return self.compute_s + self.memory_s + self.collective_s

    def as_dict(self) -> Dict:
        return {
            **dataclasses.asdict(self),
            "dominant": self.dominant,
            "step_s": self.step_s,
        }


def derive_roofline(
    cost,
    cfg: ModelConfig,
    shape: ShapeSpec,
    chips: int = 1,
    hw: HwSpec = H100,
) -> RooflineTerms:
    """`cost`: a `cost_analysis.StepCost` (or anything with `flops`,
    `dot_bytes` and `total_collective_bytes`) of one device's step."""
    mf = model_flops(cfg, shape)
    total = cost.flops * chips
    return RooflineTerms(
        compute_s=cost.flops / hw.flops,
        memory_s=cost.dot_bytes / hw.hbm_bw,
        collective_s=cost.total_collective_bytes / hw.link_bw,
        model_flops=mf,
        counted_flops_device=cost.flops,
        dot_bytes_device=cost.dot_bytes,
        collective_bytes_device=cost.total_collective_bytes,
        chips=chips,
        useful_ratio=mf / total if total else 0.0,
    )
