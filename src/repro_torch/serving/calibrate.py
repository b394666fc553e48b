"""Measured-latency calibration (counterpart of `repro/serving/calibrate.py`).

Times the real engine (prefill + N decode steps at batch 1, the device
synchronised before every clock read) and returns a service-time table plus
a `MeasuredService` for the port's slot simulator
(`core.simulator.simulate(service_time=...)`): the ICC-vs-MEC comparison
then runs on measured compute instead of the analytic Eq. 7/8 model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..core.scheduler import Job
from ..models.model import Model, Params
from .engine import GenRequest, InferenceEngine

__all__ = ["MeasuredService", "measure_service_time", "measured_service_fn"]


def measure_service_time(
    model: Model,
    params: Params,
    n_input: int,
    n_output: int,
    max_seq: int = 256,
    repeats: int = 3,
    seed: int = 0,
) -> Dict[str, float]:
    """Time prefill + n_output decode steps at batch 1 on the params'
    device. Returns seconds (the minimum over `repeats`)."""
    device = params.embed.device
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, model.cfg.vocab_size, (n_input,), generator=gen)
    eng = InferenceEngine(model, params, max_batch=1, max_seq=max_seq, device=device)
    eng.generate([GenRequest(uid=-1, prompt=prompt, max_new_tokens=n_output)])
    prefill_s, decode_s = [], []
    for r in range(repeats):
        eng.reset()
        res = eng.generate(
            [GenRequest(uid=r, prompt=prompt, max_new_tokens=n_output)]
        )[r]
        prefill_s.append(res.prefill_s)
        decode_s.append(res.decode_s)
    return {
        "prefill_s": min(prefill_s),
        "decode_s": min(decode_s),
        "total_s": min(p + d for p, d in zip(prefill_s, decode_s)),
    }


@dataclasses.dataclass(frozen=True)
class MeasuredService:
    """Job-level service time from one measured (n_input, n_output)
    calibration: prefill scales with the prompt, decode with the output.
    A frozen dataclass (as `core.latency_model.ModelService`), so that
    `core.capacity.sweep(..., workers=N)` can pickle it."""

    prefill_s: float
    decode_s: float
    n_input: int
    n_output: int

    def __call__(self, job: Job) -> float:
        per_in = self.prefill_s / max(self.n_input, 1)
        per_out = self.decode_s / max(self.n_output, 1)
        return per_in * job.n_input + per_out * job.n_output


def measured_service_fn(
    model: Model, params: Params, n_input: int, n_output: int, **kw
) -> Tuple[MeasuredService, Dict[str, float]]:
    """-> (service_time(job) for core.simulator, the measured table)."""
    t = measure_service_time(model, params, n_input, n_output, **kw)
    return MeasuredService(t["prefill_s"], t["decode_s"], n_input, n_output), t
