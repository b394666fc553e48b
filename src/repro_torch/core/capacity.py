"""Service-capacity estimation from the system-level simulator (Def. 2).

The paper's Fig. 6 sweeps the aggregate prompt arrival rate by scaling the
number of UEs (1 prompt/s/UE, Table I) and reads off the largest rate where
the job-satisfaction curve stays above alpha = 95 %. We do the same:
`sweep()` produces the curve, `capacity_from_sweep()` interpolates lambda*.

All sweeps share one (rate x seed) grid runner, `run_grid`, which can fan
the points out over a process pool (`workers=`, opt-in): every point is an
independent simulation with its own derived seed, so parallel and serial
runs aggregate the exact same numbers in the exact same order.

Copy of `repro/core/capacity.py` without `network_point` and
`network_sweep`: they need the multi-cell `network` and `experiments`
packages, which the port does not have yet. `sweep`/`sweep_generic` take
any service-time callable (`ModelService` for the analytic case, the
port's `serving.calibrate.MeasuredService` for measured compute).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from .parallel import parallel_map
from .scheduler import Job
from .simulator import SchemeConfig, SimConfig, SimResult, simulate

__all__ = [
    "mean_over_seeds",
    "run_grid",
    "sweep",
    "sweep_generic",
    "capacity_from_sweep",
]

# optional SimResult fields: None when no job in the scoring window produced
# them (TTFT/TBT need token-granular nodes; tails need >= 1 completion)
_OPTIONAL_FIELDS = (
    "p95_e2e", "p99_e2e", "avg_ttft", "p95_ttft",
    "p99_ttft", "avg_tbt", "p95_tbt", "p99_tbt",
)


def mean_over_seeds(results: Sequence[SimResult], name: Optional[str] = None) -> SimResult:
    """Seed-average a group of `SimResult`s into one row.

    The single shared aggregator for every sweep: plain fields are
    nan-averaged (a seed with no completions contributes NaN, not a crash),
    Optional fields (tails, TTFT/TBT) average over the seeds that produced
    them and stay None when none did.
    """
    def opt_mean(field: str):
        vals = [v for r in results if (v := getattr(r, field)) is not None]
        return float(np.mean(vals)) if vals else None

    def win_mean():
        # windowed metrics pool elementwise when every seed produced the
        # same window grid (same config => same edges); mixed/absent
        # windows collapse to None rather than a misaligned average.
        # Pooling weights by job count, so an empty-window seed (None
        # satisfaction) simply contributes no jobs.
        wins = [r.windows for r in results]
        if any(w is None for w in wins) or len({len(w) for w in wins}) != 1:
            return None
        out = []
        for cols in zip(*wins):
            n = sum(c["n"] for c in cols)
            def pooled(key):
                if n == 0:
                    return None
                return sum(c[key] * c["n"] for c in cols if c["n"]) / n
            out.append({
                "t0": cols[0]["t0"],
                "t1": cols[0]["t1"],
                "n": n,
                "satisfaction": pooled("satisfaction"),
                "drop_rate": pooled("drop_rate"),
            })
        return out

    def reason_sum():
        # loss counts sum across seeds (consistent with n_jobs); None
        # when no seed lost anything
        merged: dict = {}
        for r in results:
            for reason, k in (r.drop_reasons or {}).items():
                merged[reason] = merged.get(reason, 0) + k
        return dict(sorted(merged.items())) if merged else None

    return SimResult(
        scheme=name if name is not None else results[0].scheme,
        n_jobs=sum(r.n_jobs for r in results),
        satisfaction=float(np.mean([r.satisfaction for r in results])),
        drop_rate=float(np.mean([r.drop_rate for r in results])),
        avg_comm=float(np.nanmean([r.avg_comm for r in results])),
        avg_comp=float(np.nanmean([r.avg_comp for r in results])),
        avg_e2e=float(np.nanmean([r.avg_e2e for r in results])),
        avg_tokens_per_s=float(
            np.nanmean([r.avg_tokens_per_s for r in results])
        ),
        windows=win_mean(),
        drop_reasons=reason_sum(),
        **{f: opt_mean(f) for f in _OPTIONAL_FIELDS},
    )


def run_grid(
    arrival_rates: Sequence[float],
    run_one: Callable[[float, int], object],
    n_seeds: int = 3,
    workers: Union[int, str, None] = 0,
    chunk: Union[int, str, None] = None,
) -> List[list]:
    """Run `run_one(rate, seed_index)` over the full rate x seed grid.

    Returns one list of per-seed results per rate (in rate order). With
    `workers` > 1 the points run in a process pool — `run_one` must then be
    picklable (module-level function / functools.partial / callable class).
    `chunk` batches points per worker dispatch (default auto-sized);
    results are identical to serial at any chunking.
    """
    tasks = [(lam, s) for lam in arrival_rates for s in range(n_seeds)]
    flat = parallel_map(run_one, tasks, workers=workers, chunk=chunk)
    return [
        flat[i * n_seeds:(i + 1) * n_seeds] for i in range(len(arrival_rates))
    ]


def _sim_point(
    scheme: SchemeConfig,
    base: SimConfig,
    service_time: Callable[[Job], float],
    lam: float,
    seed_idx: int,
) -> SimResult:
    """One (rate, seed) grid point of `sweep` (module-level: picklable)."""
    n_ues = max(1, int(round(lam / base.lam_per_ue)))
    cfg = dataclasses.replace(base, n_ues=n_ues, seed=base.seed + 1000 * seed_idx)
    return simulate(scheme, cfg, service_time)


def sweep(
    scheme: SchemeConfig,
    base: SimConfig,
    arrival_rates: Sequence[float],
    service_time: Callable[[Job], float],
    n_seeds: int = 3,
    workers: Union[int, str, None] = 0,
    chunk: Union[int, str, None] = None,
) -> List[SimResult]:
    """Run the simulator across aggregate arrival rates (jobs/s).

    The number of UEs is scaled (paper: each UE emits 1 prompt/s), averaging
    satisfaction across seeds. `workers` > 1 requires a picklable
    `service_time` (e.g. `repro_torch.core.latency_model.ModelService`).
    """
    run_one = functools.partial(_sim_point, scheme, base, service_time)
    groups = run_grid(arrival_rates, run_one, n_seeds=n_seeds,
                      workers=workers, chunk=chunk)
    return [mean_over_seeds(g, scheme.name) for g in groups]


def sweep_generic(
    arrival_rates: Sequence[float],
    run_one: Callable[[float, int], object],
    n_seeds: int = 3,
    workers: Union[int, str, None] = 0,
    chunk: Union[int, str, None] = None,
) -> List[float]:
    """Seed-averaged satisfaction curve for any simulator.

    `run_one(rate, seed_index)` returns anything with a `.satisfaction`
    attribute (SimResult, NetResult, ...). This is the load-sweep skeleton
    shared by the single-cell and network simulators.
    """
    groups = run_grid(arrival_rates, run_one, n_seeds=n_seeds,
                      workers=workers, chunk=chunk)
    return [float(np.mean([r.satisfaction for r in g])) for g in groups]


def capacity_from_sweep(
    arrival_rates: Sequence[float],
    results: Sequence[SimResult],
    alpha: float = 0.95,
) -> float:
    """lambda* = largest arrival rate whose satisfaction >= alpha.

    Linear interpolation on the first crossing below alpha (the curves are
    monotone-decreasing up to simulation noise). `results` entries may be
    SimResult-like objects or bare satisfaction floats.
    """
    sats = [
        r.satisfaction if hasattr(r, "satisfaction") else float(r)
        for r in results
    ]
    lam_prev, sat_prev = 0.0, None
    cap = 0.0
    for lam, sat in zip(arrival_rates, sats):
        if sat >= alpha:
            cap = lam
            lam_prev, sat_prev = lam, sat
        else:
            # interpolate only from a measured satisfied point; if even the
            # first rate misses alpha we conservatively report 0.
            if sat_prev is not None and sat_prev > alpha:
                frac = (sat_prev - alpha) / max(sat_prev - sat, 1e-12)
                cap = lam_prev + frac * (lam - lam_prev)
            break
    return cap
