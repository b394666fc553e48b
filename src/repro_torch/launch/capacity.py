"""Service capacity of ICC against 5G MEC (paper Fig. 6, Def. 2) on the
port's slot simulator, with the compute node's service time from the paper's
analytic model or measured on the card (counterpart of
`benchmarks/fig6_capacity.py`, and the simulator half of
`examples/serve_icc.py`).

UEs send 1 prompt/s each (Table I), 15-in/15-out tokens; the sweep raises
the number of UEs and reads off, per scheme, the largest arrival rate at
which 95% of jobs meet their budget.

  --service paper     ModelService(GH200_NVL2.scaled(2), LLAMA2_7B), Fig. 6
  --service h100      ModelService(H100, LLAMA2_7B)
  --service measured  `measured_service_fn` on --arch at full width and
                      depth, bf16, weights from seed 0, on --device (cuda;
                      cpu takes the smoke config in f32)
  --budget paper      b_total 80 ms, each scheme's b_comm 24 ms, b_comp 56 ms
  --budget scaled     all three times k = service time of a 15/15 job over
                      the paper's (11.43 ms): the paper's ratio of budget to
                      compute

  PYTHONPATH=src python -m repro_torch.launch.capacity --service paper
  PYTHONPATH=src python -m repro_torch.launch.capacity --service measured --budget scaled
  PYTHONPATH=src python -m repro_torch.launch.capacity --service measured --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.capacity import _sim_point, capacity_from_sweep, mean_over_seeds, run_grid
from ..core.latency_model import GH200_NVL2, H100, LLAMA2_7B, ModelService
from ..core.scheduler import Job
from ..core.simulator import SCHEMES, SchemeConfig, SimConfig

__all__ = ["PAPER_SERVICE", "budgeted", "card_line", "default_rates", "main", "measured_service",
           "run"]

PAPER_SERVICE = ModelService(GH200_NVL2.scaled(2), LLAMA2_7B)  # paper: 2x GH200
SERVICES = ("paper", "h100", "measured")
BUDGETS = ("paper", "scaled")


def default_rates(service_s: float) -> list:
    """Ten whole-UE rates (1 prompt/s/UE) up to 1.25 / service, past the
    node's batch-1 saturation at 1 / service."""
    top = max(2, math.ceil(1.25 / service_s))
    return sorted({max(1, int(round(top * i / 10))) for i in range(1, 11)})


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them; raises
    RuntimeError where nvidia-smi fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi unavailable ({e})") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def measured_service(arch: str, device: str, n_input: int, n_output: int):
    """(MeasuredService, calibration table) for `arch` on `device`: full
    width and depth in bf16 on the card, the smoke config in f32 on the CPU.
    A CUDA device without a card raises (`resolve_device`)."""
    import torch

    from ..configs import get_config
    from ..models import build_model
    from ..models.common import resolve_device
    from ..serving.calibrate import measured_service_fn

    dev = resolve_device(device)
    cfg = get_config(arch, smoke=dev.type == "cpu")
    if dev.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    svc, table = measured_service_fn(model, params, n_input, n_output)
    del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return svc, table


def budgeted(
    service_time: Callable[[Job], float], budget: str = "paper", sim_time: float = 30.0,
) -> Tuple[float, float, Dict[str, SchemeConfig], SimConfig]:
    """(service of a 15/15 job in s, k, the schemes, the base SimConfig) at
    `budget`: "scaled" multiplies b_total, b_comm and b_comp by k = service
    / the paper's, and lengthens sim_time by 2 (k - 1) b_total so that the
    scored span stays what it is at the paper's budget."""
    if budget not in BUDGETS:
        raise ValueError(f"budget {budget!r} not in {BUDGETS}")
    base = SimConfig(sim_time=sim_time)
    job = Job(-1, -1, 0.0, base.n_input, base.n_output, base.b_total)
    service_s = service_time(job)
    k = service_s / PAPER_SERVICE(job) if budget == "scaled" else 1.0
    schemes = {name: dataclasses.replace(s, b_comm=s.b_comm * k, b_comp=s.b_comp * k)
               for name, s in SCHEMES.items()}
    base = dataclasses.replace(base, b_total=base.b_total * k,
                               sim_time=sim_time + 2 * (k - 1) * base.b_total)
    return service_s, k, schemes, base


def run(
    service_time: Callable[[Job], float],
    rates: Optional[Sequence[float]] = None,
    budget: str = "paper",
    sim_time: float = 30.0,
    n_seeds: int = 3,
    log: Callable[[str], None] = print,
) -> dict:
    """Fig. 6 on `service_time`: per scheme the satisfaction curve (its mean
    over seeds and the standard deviation across them, and the jobs scored
    at each rate over all seeds), the mean comm and comp latency and the
    capacity (Def. 2, alpha = 0.95). Rates are whole UEs of 1 prompt/s
    each, so a capacity is interpolated across one UE. The sweeps run
    serially: a process pool forked from a process that holds a CUDA
    context is a hazard.

    `sim_time` is the simulated time at the paper's budget. Jobs are scored
    from the warmup to sim_time - 2 b_total (`score_jobs`), so the scaled
    budget lengthens sim_time by 2 (k - 1) x 80 ms: the scored span stays
    what it is at the paper's budget."""
    service_s, k, schemes, base = budgeted(service_time, budget, sim_time)
    rates = list(rates or default_rates(service_s))
    out = {"service_ms": service_s * 1e3, "budget": budget, "k": k,
           "b_total_ms": base.b_total * 1e3, "sim_time": base.sim_time, "n_seeds": n_seeds,
           "rates": rates, "schemes": {}}
    log(f"[capacity] service {service_s * 1e3:.3f} ms per 15/15 job, budget {budget} "
        f"(k={k:.4f}): b_total {base.b_total * 1e3:.2f} ms, sim_time {base.sim_time:.3f} s, "
        f"rates {rates}")
    for name, scheme in schemes.items():
        groups = run_grid(rates, functools.partial(_sim_point, scheme, base, service_time),
                          n_seeds=n_seeds, workers=0)
        results = [mean_over_seeds(g, scheme.name) for g in groups]
        cap = capacity_from_sweep(rates, results, alpha=0.95)
        row = out["schemes"][name] = {
            "b_comm_ms": scheme.b_comm * 1e3,
            "b_comp_ms": scheme.b_comp * 1e3,
            "n_jobs": [r.n_jobs for r in results],
            "satisfaction": [r.satisfaction for r in results],
            "satisfaction_sd": [float(np.std([r.satisfaction for r in g])) for g in groups],
            "avg_comm_ms": [r.avg_comm * 1e3 for r in results],
            "avg_comp_ms": [r.avg_comp * 1e3 for r in results],
            "capacity": cap,
        }
        log(f"[capacity] {name:13s} capacity={cap:.3f} prompts/s  "
            f"sat={['%.3f' % x for x in row['satisfaction']]} "
            f"sd={['%.3f' % x for x in row['satisfaction_sd']]} jobs={row['n_jobs']}")
    icc = out["schemes"]["icc"]["capacity"]
    mec = out["schemes"]["disjoint_mec"]["capacity"]
    ran = out["schemes"]["disjoint_ran"]["capacity"]

    def gain(a, b):  # None where neither scheme has any capacity
        return a / b - 1.0 if b else (math.inf if a else None)

    out["gain_icc_vs_mec"] = gain(icc, mec)
    out["gain_wireline_only"] = gain(ran, mec)
    g = out["gain_icc_vs_mec"]
    log(f"[capacity] ICC {icc:.2f}/s vs 5G-MEC {mec:.2f}/s: gain "
        f"{'n/a (both 0)' if g is None else f'{g:+.1%}'} (paper, 2x GH200: +60%)")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--service", default="paper", choices=SERVICES)
    ap.add_argument("--budget", default="paper", choices=BUDGETS)
    ap.add_argument("--arch", default="llama2-7b", help="model timed by --service measured")
    ap.add_argument("--device", default="cuda", help="cuda | cpu (--service measured)")
    ap.add_argument("--rates", type=float, nargs="+", default=None,
                    help="aggregate prompts/s (default: up to 1.25 / service)")
    ap.add_argument("--sim-time", type=float, default=30.0,
                    help="simulated seconds at the paper's budget (Fig. 6: 30); --budget "
                         "scaled adds 2 (k - 1) x 80 ms so that the scored span, from the "
                         "2 s warmup to sim_time - 2 b_total, stays the same")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="JSON path (default benchmarks/results/"
                         "torch_capacity_<service>_<budget>.json)")
    args = ap.parse_args(argv)

    table = card = None
    if args.service == "paper":
        svc = PAPER_SERVICE
    elif args.service == "h100":
        svc = ModelService(H100, LLAMA2_7B)
    else:
        base = SimConfig()
        svc, table = measured_service(args.arch, args.device, base.n_input, base.n_output)
        if args.device != "cpu":
            card = card_line()
            print(f"[capacity] card: {card}")
        print(f"[capacity] {args.arch} on {args.device}: prefill "
              f"{table['prefill_s'] * 1e3:.3f} ms, decode {table['decode_s'] * 1e3:.3f} ms, "
              f"total {table['total_s'] * 1e3:.3f} ms (15/15, batch 1)")
    out = run(svc, args.rates, args.budget, args.sim_time, args.seeds)
    out.update(service=args.service, arch=args.arch if table else None,
               calibration=table, card=card)
    path = args.out or os.path.join(
        "benchmarks", "results", f"torch_capacity_{args.service}_{args.budget}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[capacity] wrote {path}")
    return out


if __name__ == "__main__":
    main()
