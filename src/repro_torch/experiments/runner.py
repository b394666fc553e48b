"""The one experiment runner: spec in, `ExperimentResult` out.

The port's copy of `repro/experiments/runner.py` (imports and docstrings
rewritten only).

`run(spec)` resolves the spec's arms, flattens every (arm, rate, seed)
point into one task list, fans it over `repro_torch.core.parallel.parallel_map`
(results identical to serial at any worker/chunk setting — each point
derives its own seed), and regroups into per-arm capacity curves. Each
point dispatches to the engine its `SystemSpec` names:

  multi_cell  -> `repro_torch.network.simulate_network` via `config_for_load`
                 (the exact construction `benchmarks` historically used,
                 so spec-driven reruns of the tracked grids are
                 bit-identical)
  single_cell -> `repro_torch.core.simulate` with either the analytic
                 `ModelService` (classic nodes) or a configured
                 `repro_torch.batching.BatchedComputeNode` factory (batched)

The controller/arrivals/window asymmetry between the two engines is
normalized here: `ControlSpec.controller`, `WorkloadSpec.arrival` /
`.mobility`, and `SweepSpec.window_s` map onto ``simulate(controller=)`` +
``SimConfig.arrivals/window_s`` for single-cell runs and onto the
corresponding `NetSimConfig` fields for multi-cell runs — a spec never
cares which engine serves it (mobility is multi-cell only: single-cell
runs reject it eagerly). Fault scenarios (`repro_torch.faults.FaultSpec`, on the
root spec or per variant) thread the same way: ``simulate(faults=)`` for
single-cell arms, ``NetSimConfig.faults`` for multi-cell ones.

Resilient sweeps: `SweepSpec.task_timeout_s` runs the pool in
`parallel_map`'s resilient mode — a grid point that keeps timing out or
raising yields a `PointRun` carrying a structured ``error`` record (its
seed-mean skips it) instead of hanging or aborting the whole experiment.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Union

from ..core.capacity import capacity_from_sweep, mean_over_seeds
from ..core.channel import ChannelConfig
from ..core.latency_model import LatencyModel, ModelService
from ..core.parallel import TaskError, parallel_map, peak_rss_mb
from ..core.simulator import SimConfig, simulate
from ..telemetry.profile import merge_profiles
from .result import (
    ArmResult,
    CapacityCurve,
    ExperimentResult,
    PointResult,
    PointRun,
)
from .spec import (
    ExperimentSpec,
    ResolvedArm,
    resolve_gpu,
    resolve_model,
    resolve_scenario,
    resolve_scheme,
    resolve_topology,
)

__all__ = ["run", "run_point", "assemble_result"]


def _single_cell_point(
    arm: ResolvedArm, lam: float, seed_idx: int, recorder=None,
    profiler=None,
) -> PointRun:
    sc = resolve_scenario(arm.workload.scenario)
    scheme = resolve_scheme(arm.system.scheme)
    hw = resolve_gpu(arm.system.gpu)
    if arm.system.gpu_count > 1:
        hw = hw.scaled(arm.system.gpu_count)
    profile = resolve_model(arm.system.model)
    sw = arm.sweep
    # same fallback as the multi-cell engine: an explicit workload-level
    # arrival overrides, else the scenario's own process applies
    arrival = (
        arm.workload.arrival if arm.workload.arrival is not None
        else sc.arrival
    )
    cfg = SimConfig(
        n_ues=max(1, int(round(lam / sc.lam_per_ue))),
        lam_per_ue=sc.lam_per_ue,
        n_input=sc.n_input,
        n_output=sc.n_output,
        b_total=sc.b_total,
        sim_time=sw.sim_time,
        warmup=sw.warmup,
        seed=sw.base_seed + 1000 * seed_idx,
        channel=ChannelConfig(bytes_per_token=sc.bytes_per_token),
        arrivals=arrival,
        window_s=sw.window_s,
    )
    if arm.system.node_kind == "batched":
        from ..batching import BatchedComputeNode

        lm = LatencyModel(hw, profile,
                          fidelity=arm.system.fidelity or "extended")
        holder: Dict[str, BatchedComputeNode] = {}

        def factory() -> BatchedComputeNode:
            holder["node"] = BatchedComputeNode(
                lm,
                max_batch=arm.system.max_batch,
                policy=scheme.compute_policy,
                drop_infeasible=scheme.drop_infeasible,
            )
            return holder["node"]

        res = simulate(scheme, cfg, node_factory=factory, fast=sw.fast,
                       controller=arm.control.controller, recorder=recorder,
                       faults=arm.faults, profiler=profiler)
        node = holder["node"]
        extras = {
            "avg_batch": round(node.stats.avg_batch(), 2),
            "peak_batch": node.stats.peak_batch,
            "kv_blocked_iterations": node.stats.kv_blocked_iterations,
            "kv_peak_frac": round(
                node.stats.peak_kv_bytes / node.kv.capacity_bytes, 3
            ),
            "preempted": node.stats.preempted,
        }
    else:
        svc = ModelService(hw, profile,
                           fidelity=arm.system.fidelity or "paper")
        res = simulate(scheme, cfg, svc, fast=sw.fast,
                       controller=arm.control.controller, recorder=recorder,
                       faults=arm.faults, profiler=profiler)
        extras = {}
    return PointRun(result=res, extras=extras)


def _multi_cell_point(
    arm: ResolvedArm, lam: float, seed_idx: int, recorder=None,
    profiler=None,
) -> PointRun:
    from ..network.simulator import config_for_load, simulate_network

    sw = arm.sweep
    cfg = config_for_load(
        resolve_topology(arm.system.topology),
        resolve_scenario(arm.workload.scenario),
        lam,
        sim_time=sw.sim_time,
        warmup=sw.warmup,
        seed=sw.base_seed + 1000 * seed_idx,
        model=resolve_model(arm.system.model),
        node_kind=arm.system.node_kind,
        max_batch=arm.system.max_batch,
        arrival=arm.workload.arrival,
        mobility=arm.workload.mobility,
        controller=arm.control.controller,
        window_s=sw.window_s,
        faults=arm.faults,
    )
    net = simulate_network(cfg, arm.system.policy, fast=sw.fast,
                           recorder=recorder, profiler=profiler)
    extras = {
        "route_share": dict(net.route_share),
        "n_rejected": net.n_rejected,
        "n_handovers": net.n_handovers,
        "n_rehomed": net.n_rehomed,
        "n_epochs": net.n_epochs,
        "per_cell_satisfaction": {
            cell: r.satisfaction for cell, r in net.per_cell.items()
        },
    }
    return PointRun(result=net.total, extras=extras)


def run_point(
    arm: ResolvedArm,
    lam: float,
    seed_idx: int,
    trace: bool = False,
    sample_every_s: Optional[float] = None,
    profile: bool = False,
) -> PointRun:
    """One (arm, rate, seed) grid point (module-level: picklable).

    ``trace=True`` runs the point under a fresh
    `repro_torch.telemetry.EventRecorder`; the columnar telemetry dict rides back
    on ``PointRun.result.telemetry`` (plain data — it crosses the process
    pool as a pickle like every other field). Results are otherwise
    bit-identical to an untraced run. ``sample_every_s`` overrides the
    recorder's probe-sampling interval (None keeps the recorder default);
    it throttles the time-series only — job timelines never move.

    ``profile=True`` runs the point under a fresh
    `repro_torch.telemetry.profile.PhaseProfiler`; the engine-phase wall-clock
    attribution rides back on ``PointRun.result.profile`` — like tracing,
    bit-identical results aside from the attachment. Every point also
    stamps its peak worker RSS and monotonic start/end (the runner turns
    those into per-arm elapsed wall-clock)."""
    recorder = None
    if trace:
        from ..telemetry import EventRecorder

        recorder = (
            EventRecorder() if sample_every_s is None
            else EventRecorder(sample_every_s=sample_every_s)
        )
    profiler = None
    if profile:
        from ..telemetry.profile import PhaseProfiler

        profiler = PhaseProfiler()
    t_start = time.monotonic()
    t0 = time.perf_counter()
    if arm.system.kind == "multi_cell":
        pr = _multi_cell_point(arm, lam, seed_idx, recorder=recorder,
                               profiler=profiler)
    else:
        if arm.workload.mobility is not None:
            raise ValueError("mobility requires a multi_cell system")
        pr = _single_cell_point(arm, lam, seed_idx, recorder=recorder,
                                profiler=profiler)
    pr.duration_s = round(time.perf_counter() - t0, 4)
    pr.peak_rss_mb = peak_rss_mb()
    pr.t_start_mono = t_start
    pr.t_end_mono = time.monotonic()
    return pr


def run(
    spec: ExperimentSpec,
    workers: Union[int, str, None] = None,
    chunk: Union[int, str, None] = None,
    trace: bool = False,
    sample_every_s: Optional[float] = None,
    profile: bool = False,
    progress: Union[bool, object, None] = None,
    on_event=None,
    runlog: Union[str, object, None] = None,
    heartbeat_s: Optional[float] = None,
) -> ExperimentResult:
    """Run every arm of `spec` and return the unified result.

    `workers`/`chunk` override the spec's `SweepSpec.workers` pool sizing
    (execution knobs, not part of the experiment's identity); results are
    identical at any setting. The whole experiment — all arms — flattens
    through a single pool so small arms don't serialize behind big ones.

    `trace` runs every point under a `repro_torch.telemetry.EventRecorder` and
    attaches the columnar telemetry to each seed `SimResult` — a runtime
    knob, deliberately *not* a spec field (tracing never changes what the
    experiment measures, and the spec schema stays at its pinned version).
    Intended for quick/reduced grids; a full sweep holds every point's
    event stream in memory at once. `sample_every_s` tunes the traced
    probe cadence (None = the recorder's default interval).

    Run-health knobs (all runtime-only, like `trace`; none change what
    the experiment measures):

      profile       run every point under a `PhaseProfiler`: engine-phase
                    wall-clock attribution on each seed result, merged
                    per arm onto ``ArmResult.profile``
      progress      True -> live single-line status on stderr (TTY-aware,
                    silent when piped); or pass a `SweepProgress`-like
                    object with handle()/finish()
      on_event      extra callback receiving every enriched monitor event
      runlog        path (or open `RunLog`) appending one JSON line per
                    lifecycle event — see `repro_torch.experiments.runlog`
      heartbeat_s   worker heartbeat period (default 5s whenever any
                    monitoring is active); with `SweepSpec.task_timeout_s`
                    this makes the timeout heartbeat-aware: actively
                    beating points are never killed as wedged
    """
    spec.validate()
    arms = spec.resolve_arms()
    if workers is None:
        workers = spec.sweep.workers
    tasks = [
        (arm, float(lam), s, trace, sample_every_s, profile)
        for arm in arms
        for lam in arm.sweep.rates
        for s in range(arm.sweep.n_seeds)
    ]
    # (arm, rate, seed) labels in task order: monitor events carry only a
    # task index, the enrichment below makes them human-readable
    labels = [
        {"arm": t[0].name, "rate": t[1], "seed": t[2]} for t in tasks
    ]

    rl = None
    own_runlog = False
    if runlog is not None:
        from .runlog import RunLog

        if isinstance(runlog, (str, bytes, os.PathLike)):
            rl = RunLog(os.fspath(runlog))
            own_runlog = True  # we opened it, we close it
        else:
            rl = runlog
    prog = None
    if progress is not None and progress is not False:
        if progress is True:
            from .progress import SweepProgress

            prog = SweepProgress(total=len(tasks))
        else:
            prog = progress

    monitor = None
    if rl is not None or prog is not None or on_event is not None:
        def monitor(ev: dict) -> None:
            i = ev.get("task")
            if isinstance(i, int) and 0 <= i < len(labels):
                ev = {**ev, **labels[i]}
            if prog is not None:
                prog.handle(ev)
            if rl is not None:
                rl.task_event(ev)
            if on_event is not None:
                on_event(ev)
    if monitor is not None and heartbeat_s is None:
        heartbeat_s = 5.0

    if rl is not None:
        rl.write("run_start", experiment=spec.name,
                 arms=[a.name for a in arms], n_tasks=len(tasks),
                 profile=bool(profile) or None, trace=bool(trace) or None)

    t0 = time.perf_counter()
    flat = parallel_map(run_point, tasks, workers=workers, chunk=chunk,
                        task_timeout_s=spec.sweep.task_timeout_s,
                        monitor=monitor, heartbeat_s=heartbeat_s)
    wall = time.perf_counter() - t0
    if prog is not None:
        prog.finish()
    result = assemble_result(spec, arms, flat, round(wall, 2))
    if rl is not None:
        _log_run_summary(rl, result)
        if own_runlog:
            rl.close()
    return result


def assemble_result(
    spec: ExperimentSpec,
    arms: List[ResolvedArm],
    flat: List,
    wall_clock_s: float,
) -> ExperimentResult:
    """Regroup a flat, task-ordered list of per-point outcomes into the
    unified `ExperimentResult`: the one aggregation path both `run` and
    the sharded dispatcher (`repro_torch.experiments.dispatch.run_sharded`) go
    through, so a merged sharded result is structurally identical to a
    single-process one by construction.

    `flat` holds one entry per (arm, rate, seed) task in the exact order
    `run` flattens them (arm-major, then rate, then seed): `PointRun`s,
    or raw `core.parallel.TaskError`s — a point that timed out or kept
    raising (resilient sweeps) becomes a structured ``error`` on its
    `PointRun` so the sweep reports every point it *could* compute
    instead of aborting the grid.
    """
    flat = [
        PointRun(result=None, error={
            "error": p.error, "message": p.message, "attempts": p.attempts,
        }) if isinstance(p, TaskError) else p
        for p in flat
    ]

    out: List[ArmResult] = []
    cursor = 0
    for arm in arms:
        rates = [float(r) for r in arm.sweep.rates]
        n_seeds = arm.sweep.n_seeds
        points: List[PointResult] = []
        for lam in rates:
            seeds = flat[cursor:cursor + n_seeds]
            cursor += n_seeds
            good = [p.result for p in seeds if p.result is not None]
            mean = mean_over_seeds(good, arm.name) if good else None
            points.append(PointResult(rate=lam, mean=mean, seeds=seeds))
        sats = [
            p.mean.satisfaction if p.mean is not None else float("nan")
            for p in points
        ]
        alpha = arm.sweep.alpha
        curve = CapacityCurve(
            rates=rates,
            satisfaction=sats,
            capacity=capacity_from_sweep(rates, sats, alpha=alpha),
            saturated=all(s >= alpha for s in sats),
            alpha=alpha,
        )
        seeds_flat = [s for p in points for s in p.seeds]
        stamped = [s for s in seeds_flat if s.t_end_mono > 0.0]
        profiles = [
            s.result.profile for s in seeds_flat
            if s.result is not None and s.result.profile
        ]
        out.append(ArmResult(
            name=arm.name,
            curve=curve,
            points=points,
            # summed task-seconds (attributable compute across workers)…
            wall_clock_s=round(
                sum(s.duration_s for s in seeds_flat), 2
            ),
            # …vs true elapsed wall for the arm (first start -> last end)
            elapsed_s=round(
                max(s.t_end_mono for s in stamped)
                - min(s.t_start_mono for s in stamped), 2
            ) if stamped else 0.0,
            profile=merge_profiles(profiles),
        ))
    assert cursor == len(flat)
    return ExperimentResult(
        experiment=spec.name,
        spec=spec,
        arms=out,
        wall_clock_s=wall_clock_s,
    )


def _log_run_summary(rl, result: ExperimentResult) -> None:
    """Append the post-sweep summary events: one ``point`` record per
    (arm, rate, seed) with duration/RSS/profile summary, one ``arm_end``
    per arm, and a final ``run_end`` — the records `summarize_runlog`
    and the report's "where time goes" miner consume."""
    n_errors = 0
    for a in result.arms:
        for p in a.points:
            for k, srun in enumerate(p.seeds):
                prof = (
                    srun.result.profile if srun.result is not None else None
                )
                if srun.error is not None:
                    n_errors += 1
                rl.write(
                    "point", arm=a.name, rate=p.rate, seed=k,
                    duration_s=srun.duration_s,
                    peak_rss_mb=srun.peak_rss_mb,
                    cached=srun.cached or None,
                    error=(srun.error or {}).get("error"),
                    profile=(
                        {
                            "total_s": prof.get("total_s"),
                            "coverage": prof.get("coverage"),
                            "phases": prof.get("phases"),
                        } if prof else None
                    ),
                )
        rl.write(
            "arm_end", arm=a.name, capacity=a.curve.capacity,
            saturated=a.curve.saturated, task_seconds=a.wall_clock_s,
            elapsed_s=a.elapsed_s or None,
        )
    rl.write(
        "run_end", experiment=result.experiment,
        wall_clock_s=result.wall_clock_s,
        n_points=sum(len(p.seeds) for a in result.arms for p in a.points),
        n_errors=n_errors,
    )
