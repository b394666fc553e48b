"""Measured-latency calibration (counterpart of `repro/serving/calibrate.py`).

Times the real engine (prefill + N decode steps at batch 1, the device
synchronised before every clock read) and returns a service-time table plus
a callable for a slot simulator. The callable reads `job.n_input` and
`job.n_output` by duck typing; the port does not import the reference's
`core.scheduler.Job`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..models.model import Model
from ..models.transformer import Decoder
from .engine import GenRequest, InferenceEngine

__all__ = ["measure_service_time", "measured_service_fn"]


def measure_service_time(
    model: Model,
    params: Decoder,
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


def measured_service_fn(
    model: Model, params: Decoder, n_input: int, n_output: int, **kw
) -> Tuple[Callable[[Any], float], Dict[str, float]]:
    """-> (service_time(job) for a slot simulator, the measured table)."""
    t = measure_service_time(model, params, n_input, n_output, **kw)
    per_in = t["prefill_s"] / max(n_input, 1)
    per_out = t["decode_s"] / max(n_output, 1)

    def service_time(job: Any) -> float:
        return per_in * job.n_input + per_out * job.n_output

    return service_time, t
