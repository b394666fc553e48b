"""The ``bench_doc`` formatters of the tracked capacity baselines.

Each function renders an `ExperimentResult` of one tracked study into its
``BENCH_*.json`` wrapper (``{schema_version, experiment, headline,
result}``). They are the port's copies of the reference's
``benchmarks/{network_capacity,batching_capacity,control_capacity,
resilience}.py:bench_doc`` with the helpers they call, and nothing of
those scripts' CLIs: the reference's formatters import `repro`, so the
port's suites (`suites.py`) name these instead. Same derivations, same
rounding, so a document written through the port equals the reference's
key for key (the timing keys ``wall_clock_s`` / ``sweep_wall_clock_s``
aside).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..batching import KVCache
from ..core.latency_model import LLAMA2_7B
from ..core.scheduler import Job
from ..network.fleet import GPU_SPECS
from ..network.scenarios import SCENARIOS
from .registry import (
    CONTROL_ARMS,
    CONTROL_STATIC_ARMS,
    RESILIENCE_ARMS,
    RESILIENCE_FAULT_CASES,
)
from .spec import SCHEMA_VERSION

__all__ = [
    "batching_capacity",
    "control_capacity",
    "network_capacity",
    "resilience",
]


def _wrap(result, headline: dict) -> dict:
    return {
        "schema_version": SCHEMA_VERSION,
        "experiment": result.experiment,
        "headline": headline,
        "result": result.to_dict(points="none"),
    }


# ------------------------------------------------------ network_capacity


def network_capacity(result) -> dict:
    """BENCH_network.json: capacity and saturation per routing policy."""
    spec = result.spec
    policies = {
        arm.name: {"capacity": arm.curve.capacity,
                   "saturated": arm.curve.saturated}
        for arm in result.arms
    }
    headline = {
        "capacity_per_policy": {
            p: policies[p]["capacity"] for p in policies
        },
        "saturated": {p: policies[p]["saturated"] for p in policies},
        "sweep_wall_clock_s": result.wall_clock_s,
        "rates": [float(r) for r in spec.sweep.rates],
        "sim_time": spec.sweep.sim_time,
        "n_seeds": spec.sweep.n_seeds,
    }
    return _wrap(result, headline)


# ----------------------------------------------------- batching_capacity


def _ms(v: Optional[float]) -> Optional[float]:
    return round(v * 1e3, 1) if v is not None else None


def _arm_report(arm, mb: int, alpha: float) -> dict:
    """One (GPU, max_batch) arm: curve numbers plus the probe (highest
    still-satisfied operating point) and stress (top swept rate) rows.
    Probe metrics come from each point's last seed."""
    probes = []
    for point in arm.points:
        last = point.seeds[-1]
        probes.append({
            "satisfaction": round(point.mean.satisfaction, 4),
            "avg_ttft_ms": _ms(last.result.avg_ttft),
            "p99_ttft_ms": _ms(last.result.p99_ttft),
            "avg_tbt_ms": _ms(last.result.avg_tbt),
            "p99_e2e_ms": _ms(last.result.p99_e2e),
            **last.extras,
            "rate": point.rate,
        })
    probe = max(
        (p for p in probes if p["satisfaction"] >= alpha),
        key=lambda p: p["rate"], default=probes[0],
    )
    stress = probes[-1]
    kv_bound = (
        stress["kv_blocked_iterations"] > 0
        and stress["peak_batch"] < mb
    )
    return {
        "rates": arm.curve.rates,
        "satisfaction": [round(s, 4) for s in arm.curve.satisfaction],
        "capacity": arm.curve.capacity,
        "saturated": arm.curve.saturated,
        "kv_bound": kv_bound,
        "probe": probe,
        "stress": stress,
    }


def _grid_order(result):
    """(gpus, batches) in arm order: arms are named ``<gpu>/mb<batch>``
    and registered GPU-major."""
    gpus, batches = [], []
    for arm in result.arms:
        gpu, _, mb = arm.name.partition("/mb")
        if gpu not in gpus:
            gpus.append(gpu)
        if int(mb) not in batches:
            batches.append(int(mb))
    return gpus, batches


def batching_capacity(result) -> dict:
    """BENCH_batching.json: the (GPU x max_batch) capacity matrix, KV
    bounds and cache job caps. Needs the per-seed points."""
    spec = result.spec
    sc = (SCENARIOS[spec.workload.scenario]
          if isinstance(spec.workload.scenario, str)
          else spec.workload.scenario)
    alpha = spec.sweep.alpha
    gpus, batches = _grid_order(result)
    probe_job = Job(uid=-1, ue=0, t_gen=0.0, n_input=sc.n_input,
                    n_output=sc.n_output, b_total=sc.b_total)
    per_gpu: Dict[str, dict] = {}
    for gpu in gpus:
        per = {
            mb: _arm_report(result.arm(f"{gpu}/mb{mb}"), mb, alpha)
            for mb in batches
        }
        best = max(per, key=lambda m: per[m]["capacity"])
        mb1_cap = per[min(batches)]["capacity"]
        per_gpu[gpu] = {
            "cache_job_cap": KVCache(
                GPU_SPECS[gpu], LLAMA2_7B
            ).jobs_capacity(probe_job),
            "per_batch": per,
            "best_mb": best,
            "gain_best_vs_mb1": (
                per[best]["capacity"] / mb1_cap - 1.0
                if mb1_cap > 0 else None
            ),
        }
    headline = {
        "scenario": sc.name,
        "capacity": {
            gpu: {str(mb): d["per_batch"][mb]["capacity"] for mb in batches}
            for gpu, d in per_gpu.items()
        },
        "gain_best_vs_mb1": {
            gpu: (round(g, 3) if (g := d["gain_best_vs_mb1"]) is not None
                  else None)
            for gpu, d in per_gpu.items()
        },
        "kv_bound": {
            gpu: {str(mb): d["per_batch"][mb]["kv_bound"] for mb in batches}
            for gpu, d in per_gpu.items()
        },
        "cache_job_cap": {
            gpu: d["cache_job_cap"] for gpu, d in per_gpu.items()
        },
        "sim_time": spec.sweep.sim_time,
        "n_seeds": spec.sweep.n_seeds,
        "wall_clock_s": result.wall_clock_s,
    }
    return _wrap(result, headline)


# ------------------------------------------------------ control_capacity


def _window_stats(windows, spike):
    t0, t1 = spike
    sp = [w["satisfaction"] for w in windows
          if t0 <= w["t0"] < t1 and w["satisfaction"] is not None]
    post = [w["satisfaction"] for w in windows
            if w["t0"] >= t1 and w["satisfaction"] is not None]
    return {
        "spike_sat": float(np.mean(sp)) if sp else None,
        "spike_min_sat": float(min(sp)) if sp else None,
        "recovery_sat": float(np.mean(post)) if post else None,
    }


def _control_sections(result):
    """The flash-crowd arms, diurnal and mobility sections and the joint
    vs best-static headline (needs per-seed points for the counters)."""
    sc = SCENARIOS["flash_crowd"]
    spike = (sc.arrival.t_start, sc.arrival.t_end)

    arms = {}
    for name in CONTROL_ARMS:
        point = result.arm(name).points[0]
        total = point.mean
        stats = _window_stats(total.windows, spike)
        arms[name] = {
            "satisfaction": round(total.satisfaction, 4),
            "drop_rate": round(total.drop_rate, 4),
            **{k: round(v, 4) for k, v in stats.items()},
            "rejected": int(np.mean(
                [s.extras["n_rejected"] for s in point.seeds]
            )),
            "windows": [
                {k: round(v, 4) if isinstance(v, float) else v
                 for k, v in w.items()}
                for w in total.windows
            ],
        }

    diurnal = {}
    for name in ("slack_aware", "slack_aware_joint"):
        point = result.arm(f"diurnal/{name}").points[0]
        diurnal[name] = {
            "satisfaction": round(float(np.mean(
                [s.result.satisfaction for s in point.seeds]
            )), 4),
            "rejected": int(np.mean(
                [s.extras["n_rejected"] for s in point.seeds]
            )),
        }

    mobility = {}
    for name in ("slack_aware", "slack_aware_joint"):
        point = result.arm(f"mobility/{name}").points[0]
        mobility[name] = {
            "satisfaction": round(float(np.mean(
                [s.result.satisfaction for s in point.seeds]
            )), 4),
            "handovers": int(np.mean(
                [s.extras["n_handovers"] for s in point.seeds]
            )),
            "rehomed": int(np.mean(
                [s.extras["n_rehomed"] for s in point.seeds]
            )),
        }

    best_static = max(CONTROL_STATIC_ARMS, key=lambda a: arms[a]["spike_sat"])
    joint, ref = arms["slack_aware_joint"], arms[best_static]
    headline = {
        "joint_vs_best_static_spike": round(
            joint["spike_sat"] / max(ref["spike_sat"], 1e-9), 3),
        "joint_vs_best_static_overall": round(
            joint["satisfaction"] / max(ref["satisfaction"], 1e-9), 3),
        "joint_recovery_sat": joint["recovery_sat"],
        "best_static_recovery_sat": ref["recovery_sat"],
    }
    return arms, diurnal, mobility, headline


def control_capacity(result) -> dict:
    """BENCH_control.json: windowed flash-crowd satisfaction per arm,
    the diurnal and mobility passes and the joint-controller headline."""
    spec = result.spec
    arms, diurnal, mobility, head = _control_sections(result)
    headline = {
        "spike_sat": {a: arms[a]["spike_sat"] for a in arms},
        "spike_min_sat": {a: arms[a]["spike_min_sat"] for a in arms},
        "recovery_sat": {a: arms[a]["recovery_sat"] for a in arms},
        "satisfaction": {a: arms[a]["satisfaction"] for a in arms},
        "diurnal": diurnal,
        "mobility": mobility,
        "headline": head,
        "load_jobs_per_s": float(spec.sweep.rates[0]),
        "sim_time": spec.sweep.sim_time,
        "n_seeds": spec.sweep.n_seeds,
        "wall_clock_s": result.wall_clock_s,
    }
    return _wrap(result, headline)


# ------------------------------------------------------------ resilience


def _outage_min_sat(windows, t_fail: float, t_recover: float):
    """Minimum windowed satisfaction over windows overlapping the outage
    (None when no outage window scored any jobs)."""
    if not windows:
        return None
    vals = [
        w["satisfaction"] for w in windows
        if w["t1"] > t_fail and w["t0"] < t_recover
        and w.get("satisfaction") is not None
    ]
    return min(vals) if vals else None


def _fault_window(spec):
    """(t_fail, t_recover) of the first outage in the spec's arms."""
    for arm in spec.resolve_arms():
        f = arm.faults
        if f is None:
            continue
        for o in tuple(f.node_outages) + tuple(f.link_outages):
            return float(o.t_fail), float(o.t_recover)
    raise ValueError(
        f"spec {spec.name!r} injects no outages; not a resilience grid"
    )


def resilience(result, ref_rate: float = 70.0) -> dict:
    """BENCH_resilience.json: capacity per arm, satisfaction and the
    outage-window minimum at the grid rate nearest `ref_rate`, and the
    satisfaction each stance retains under each fault."""
    spec = result.spec
    grid = [float(r) for r in spec.sweep.rates]
    ref = min(grid, key=lambda r: abs(r - ref_rate))
    t_fail, t_recover = _fault_window(spec)

    arms: Dict[str, dict] = {}
    sat_at_ref: Dict[str, float] = {}
    min_win: Dict[str, Optional[float]] = {}
    for arm in result.arms:
        arms[arm.name] = {
            "capacity": arm.curve.capacity,
            "saturated": arm.curve.saturated,
        }
        point = next(p for p in arm.points if p.rate == ref)
        sat_at_ref[arm.name] = point.mean.satisfaction
        min_win[arm.name] = _outage_min_sat(
            point.mean.windows, t_fail, t_recover
        )

    retained: Dict[str, Dict[str, float]] = {}
    for stance in RESILIENCE_ARMS:
        base = max(sat_at_ref[f"{stance}/baseline"], 1e-9)
        retained[stance] = {
            case: round(sat_at_ref[f"{stance}/{case}"] / base, 4)
            for case in RESILIENCE_FAULT_CASES if case != "baseline"
        }
    headline = {
        "capacity_per_arm": {a: arms[a]["capacity"] for a in arms},
        "saturated": {a: arms[a]["saturated"] for a in arms},
        "sat_at_ref": {k: round(v, 4) for k, v in sat_at_ref.items()},
        "retained_at_ref": retained,
        "outage_min_window_sat": {
            k: (round(v, 4) if v is not None else None)
            for k, v in min_win.items()
        },
        "icc_vs_mec_worst_retained": round(
            min(retained["icc"].values()) - min(retained["mec"].values()), 4
        ),
        "ref_rate": ref,
        "outage": [t_fail, t_recover],
        "rates": grid,
        "sim_time": spec.sweep.sim_time,
        "n_seeds": spec.sweep.n_seeds,
        "sweep_wall_clock_s": result.wall_clock_s,
    }
    return _wrap(result, headline)
