"""Serving entry point: ICC-scheduled continuous batching over a real model
(counterpart of `repro/launch/serve.py`, plus `--device`).

Generates a Poisson request trace (the paper's Table-I workload shape:
short prompts, short outputs), runs it through the engine twice — ICC
priority admission vs FIFO — and prints satisfaction/latency stats. The
model is the arch's smoke config in float32, as in the reference script;
`--arch` takes every config of the JAX package: dense, vlm, moe, hybrid
(zamba2-7b) and ssm (xlstm-1.3b) calibrate and serve token prompts;
enc-dec (seamless-m4t-large-v2) is refused, as the reference's calibration
builds its engines without `enc_len`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --rate 20
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config, list_configs
from ..models import RuntimeFlags, build_model
from ..models.common import resolve_device
from ..serving import GenRequest, ICCRequest, ICCServer, InferenceEngine
from ..serving.calibrate import measure_service_time


def build_trace(cfg, rate: float, duration: float, n_input: int,
                n_output: int, b_total: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    reqs, t, uid = [], 0.0, 0
    while t < duration:
        t += rng.exponential(1.0 / rate)
        gen = torch.Generator().manual_seed(uid)
        prompt = torch.randint(0, cfg.vocab_size, (n_input,), generator=gen)
        reqs.append(
            ICCRequest(
                GenRequest(uid=uid, prompt=prompt, max_new_tokens=n_output),
                t_gen=t,
                t_comm=float(rng.uniform(0.008, 0.03)),  # SLS-like comm spread
                b_total=b_total,
            )
        )
        uid += 1
    return reqs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=sorted(list_configs()),
                    help="any config but an enc-dec one (seamless-m4t-large-v2)")
    ap.add_argument("--rate", type=float, default=10.0, help="req/s")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--n-input", type=int, default=15)
    ap.add_argument("--n-output", type=int, default=15)
    ap.add_argument("--budget", type=float, default=2.0, help="b_total (s)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args()

    cfg = dataclasses.replace(get_config(args.arch, smoke=True), dtype="float32")
    if cfg.n_encoder_layers:
        ap.error(f"{args.arch} is enc-dec: measure_service_time builds its engines "
                 "without enc_len, as the reference's does")
    device = resolve_device(args.device)
    model = build_model(cfg, RuntimeFlags(remat=False))
    params = model.init(seed=0, device=device)
    cal = measure_service_time(model, params, args.n_input, args.n_output)
    print(f"[serve] {device.type}: calibrated prefill {cal['prefill_s']*1e3:.1f}ms "
          f"decode {cal['decode_s']*1e3:.1f}ms")

    for policy in ("priority", "fifo"):
        trace = build_trace(cfg, args.rate, args.duration, args.n_input,
                            args.n_output, args.budget)
        eng = InferenceEngine(model, params, max_batch=args.max_batch,
                              max_seq=args.n_input + args.n_output + 8,
                              device=device)
        eng.warmup(trace[0].req.prompt)
        srv = ICCServer(eng, policy=policy, est_latency=cal["total_s"])
        stats = srv.run(trace)
        e2e = np.array(stats.e2e) if stats.e2e else np.array([np.nan])
        print(
            f"[serve] {policy:8s}: {stats.n_total} reqs, "
            f"sat={stats.satisfaction:.3f} drop={stats.n_dropped} "
            f"p50={np.nanpercentile(e2e,50)*1e3:.0f}ms "
            f"p95={np.nanpercentile(e2e,95)*1e3:.0f}ms"
        )


if __name__ == "__main__":
    main()
