"""Sharded dispatch: split a spec's grid into shards, execute anywhere,
merge back bit-identically.

The port's copy of `repro/experiments/dispatch.py` (imports and docstrings
rewritten only).

Every (arm, rate, seed) grid point is an independent simulation (the
repo's seed-derivation convention), so an experiment can be partitioned
arbitrarily: `run_sharded` flattens the grid in the exact task order
`runner.run` uses, consults the `ResultCache` for already-computed
points, packs the remainder into cost-balanced `Shard`s, executes the
shards through a pluggable `Executor`, and reassembles the flat point
list through the same `runner.assemble_result` aggregation — so the
merged result carries the same physics bytes as a single-process run
(`ExperimentResult.to_canonical_json` compares them exactly; wall-clock
fields are facts of the run, not the spec, and differ by definition).

The executor surface is multi-host-shaped from the start: an executor
receives the spec as canonical JSON plus per-shard point coordinates
(names and numbers only — nothing that must share memory with the
scheduler), and returns per-shard `PointRun` lists. `LocalExecutor` is
the in-tree implementation, running each shard as one dispatch unit of
the heartbeat-aware resilient `core.parallel.parallel_map` pool; a
fleet executor would ship the same payload over a wire.

Shards are balanced by *predicted* cost: `CostModel.from_runlog` mines
per-point durations out of a prior structured runlog
(`repro_torch.experiments.runlog`) and predicts each point's cost by exact
(arm, rate) history, then arm history, then the global mean; LPT
(longest-processing-time-first) greedy packing keeps the makespan near
the optimum. With no history every point costs 1.0 and packing
degenerates to balanced round-robin — still correct, just less even.

Monotonic start/end stamps are cleared on every point (they are
meaningless across processes/hosts) and the result's wall-clock becomes
the summed per-point task-seconds — deterministic under cache replay,
which is what makes a warm rerun's result files byte-identical to the
cold run's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, Union

from ..core.parallel import TaskError, parallel_map, resolve_workers
from .cache import ResultCache
from .result import ExperimentResult, PointRun
from .runner import _log_run_summary, assemble_result, run_point
from .spec import ExperimentSpec

__all__ = [
    "CostModel",
    "Executor",
    "LocalExecutor",
    "Shard",
    "plan_shards",
    "run_sharded",
]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One dispatch unit: a subset of a spec's grid points.

    ``points`` are plain (arm_name, rate, seed_idx) coordinates —
    JSON-able on purpose, so a shard can cross a process or host
    boundary next to the spec's canonical JSON. ``task_ids`` are the
    points' positions in the flat task order (the merge key).
    """

    index: int
    points: Tuple[Tuple[str, float, int], ...]
    task_ids: Tuple[int, ...]
    est_cost_s: float


class CostModel:
    """Per-point cost prediction mined from prior runlog durations.

    Tiered lookup: exact (arm, rate) mean -> arm mean -> global mean ->
    `default_s`. Seeds of one (arm, rate) point are drawn from the same
    physics and cost the same; rates change load and therefore cost,
    which is exactly what the tiering captures.
    """

    def __init__(self, default_s: float = 1.0):
        self.default_s = float(default_s)
        self._by_point: Dict[Tuple[str, float], List[float]] = {}
        self._by_arm: Dict[str, List[float]] = {}
        self._all: List[float] = []

    def observe(self, arm: str, rate: float, duration_s: float) -> None:
        if not duration_s or duration_s <= 0.0:
            return
        self._by_point.setdefault((arm, float(rate)), []).append(duration_s)
        self._by_arm.setdefault(arm, []).append(duration_s)
        self._all.append(duration_s)

    @classmethod
    def from_runlog(cls, path: str, default_s: float = 1.0) -> "CostModel":
        """Mine every ``point`` record out of a runlog JSONL (missing or
        unreadable files yield an empty model — cost prediction is an
        optimization, never a failure mode)."""
        from .runlog import read_runlog

        model = cls(default_s=default_s)
        try:
            events = read_runlog(path)
        except (OSError, ValueError):
            return model
        for e in events:
            if e.get("event") != "point" or e.get("error"):
                continue
            arm, rate = e.get("arm"), e.get("rate")
            if arm is None or rate is None:
                continue
            model.observe(str(arm), float(rate), e.get("duration_s") or 0.0)
        return model

    def predict(self, arm: str, rate: float) -> float:
        durs = self._by_point.get((arm, float(rate)))
        if not durs:
            durs = self._by_arm.get(arm)
        if not durs:
            durs = self._all
        if not durs:
            return self.default_s
        return sum(durs) / len(durs)


def plan_shards(
    points: Sequence[Tuple[int, str, float, int]],
    n_shards: int,
    cost: Optional[CostModel] = None,
) -> List[Shard]:
    """Pack (task_id, arm, rate, seed) points into `n_shards` shards by
    LPT greedy: sort by predicted cost (descending, task order breaking
    ties — fully deterministic), assign each to the least-loaded shard.
    Within a shard, points keep task order; empty shards are dropped."""
    cost = cost or CostModel()
    n_shards = max(1, min(int(n_shards), len(points)))
    priced = [
        (cost.predict(arm, rate), tid, arm, rate, seed)
        for (tid, arm, rate, seed) in points
    ]
    priced.sort(key=lambda p: (-p[0], p[1]))
    bins: List[List[Tuple[float, int, str, float, int]]] = [
        [] for _ in range(n_shards)
    ]
    loads = [0.0] * n_shards
    for item in priced:
        k = min(range(n_shards), key=lambda i: (loads[i], i))
        bins[k].append(item)
        loads[k] += item[0]
    shards = []
    for k, items in enumerate(bins):
        if not items:
            continue
        items.sort(key=lambda p: p[1])  # task order within the shard
        shards.append(Shard(
            index=len(shards),
            points=tuple((arm, rate, seed) for _, _, arm, rate, seed in items),
            task_ids=tuple(tid for _, tid, _, _, _ in items),
            est_cost_s=round(loads[k], 3),
        ))
    return shards


def execute_shard(
    spec_json: str, points: Tuple[Tuple[str, float, int], ...]
) -> List[PointRun]:
    """Run one shard's points, in order (module-level: picklable, and
    deliberately fed only JSON-able payloads — the exact entry point a
    remote worker host would expose)."""
    spec = ExperimentSpec.from_json(spec_json)
    arms = {a.name: a for a in spec.resolve_arms()}
    return [
        run_point(arms[name], float(rate), int(seed))
        for (name, rate, seed) in points
    ]


class Executor(Protocol):
    """Worker-fleet API: execute shards of an experiment.

    Implementations receive the spec as canonical JSON plus per-shard
    point coordinates and return one result list per shard, in shard
    order; a slot may be a `core.parallel.TaskError` when the whole
    shard failed (the scheduler expands it to per-point errors).
    `monitor` receives `parallel_map`-shaped lifecycle events whose
    ``task`` index is the *shard* index.
    """

    def run(
        self,
        spec_json: str,
        shards: Sequence[Shard],
        monitor=None,
        heartbeat_s: Optional[float] = None,
        task_timeout_s: Optional[float] = None,
    ) -> List:
        ...


class LocalExecutor:
    """Multi-process executor over `core.parallel.parallel_map`: each
    shard is one dispatch unit (``chunk=1``), so the monitoring
    stack — heartbeats, resilient timeouts, retry accounting — applies
    per shard."""

    def __init__(self, workers: Union[int, str, None] = None):
        self.workers = workers

    def run(
        self,
        spec_json: str,
        shards: Sequence[Shard],
        monitor=None,
        heartbeat_s: Optional[float] = None,
        task_timeout_s: Optional[float] = None,
    ) -> List:
        return parallel_map(
            execute_shard,
            [(spec_json, shard.points) for shard in shards],
            workers=self.workers,
            chunk=1,
            task_timeout_s=task_timeout_s,
            monitor=monitor,
            heartbeat_s=heartbeat_s,
        )


def run_sharded(
    spec: ExperimentSpec,
    shards: Optional[int] = None,
    cache: Union[str, ResultCache, None] = None,
    workers: Union[int, str, None] = None,
    executor: Optional[Executor] = None,
    cost_log: Optional[str] = None,
    runlog: Union[str, object, None] = None,
    progress: Union[bool, object, None] = None,
    heartbeat_s: Optional[float] = None,
) -> ExperimentResult:
    """Run `spec` through the cache + sharded-dispatch path.

    Semantics match `runner.run` on the physics: the merged result's
    canonical form (`to_canonical_json`) is byte-identical to a
    single-process run at any shard/worker/cache setting. Differences
    are confined to timing bookkeeping: monotonic stamps are cleared
    (meaningless across hosts, so per-arm ``elapsed_s`` stays 0/absent)
    and ``wall_clock_s`` is the summed per-point task-seconds —
    deterministic under cache replay.

      shards       target shard count (default: the resolved worker
                   count, so every lane gets work); clamped to the
                   number of uncached points
      cache        `ResultCache` or a directory path; hits are replayed
                   (duration/RSS included), computed points are stored,
                   and the per-run {hits, misses, stale, writes} delta
                   lands on ``result.cache`` and in the runlog
      workers      pool width for the default `LocalExecutor` (None =
                   the spec's `SweepSpec.workers`)
      executor     alternative `Executor` (a worker fleet); receives
                   only JSON-able payloads
      cost_log     runlog JSONL to mine per-point cost predictions from
                   (default: `runlog` itself when it's an existing file,
                   so iterated sweeps self-improve their packing)
      runlog/progress/heartbeat_s   as in `runner.run`; progress counts
                   shards, the runlog gains ``shard_plan`` and
                   ``cache_stats`` records, and per-point ``point``
                   records mark replayed points ``cached``
    """
    spec.validate()
    arms = spec.resolve_arms()
    arm_by_name = {a.name: a for a in arms}
    if workers is None:
        workers = spec.sweep.workers
    tasks = [
        (arm.name, float(lam), s)
        for arm in arms
        for lam in arm.sweep.rates
        for s in range(arm.sweep.n_seeds)
    ]

    store: Optional[ResultCache] = None
    if cache is not None:
        store = cache if isinstance(cache, ResultCache) else ResultCache(cache)
    stats0 = store.stats.as_dict() if store is not None else None

    # ----------------------------------------------------- cache lookup
    flat: List[Optional[PointRun]] = [None] * len(tasks)
    pending: List[Tuple[int, str, float, int]] = []
    for tid, (name, rate, seed) in enumerate(tasks):
        if store is not None:
            hit = store.get(arm_by_name[name], rate, seed)
            if hit is not None:
                flat[tid] = hit
                continue
        pending.append((tid, name, rate, seed))

    # ------------------------------------------------------- shard plan
    if cost_log is None and isinstance(runlog, (str, bytes, os.PathLike)) \
            and os.path.exists(os.fspath(runlog)):
        cost_log = os.fspath(runlog)
    cost = (CostModel.from_runlog(cost_log)
            if cost_log is not None else CostModel())
    lanes = resolve_workers(workers)
    n_shards = int(shards) if shards is not None else max(lanes, 1)
    plan = plan_shards(pending, n_shards, cost) if pending else []

    rl = None
    own_runlog = False
    if runlog is not None:
        from .runlog import RunLog

        if isinstance(runlog, (str, bytes, os.PathLike)):
            rl = RunLog(os.fspath(runlog))
            own_runlog = True
        else:
            rl = runlog
    prog = None
    if progress is not None and progress is not False:
        if progress is True:
            from .progress import SweepProgress

            prog = SweepProgress(total=len(plan))
        else:
            prog = progress

    labels = [
        {
            "shard": shard.index,
            "n_points": len(shard.points),
            "arms": ",".join(sorted({p[0] for p in shard.points})),
        }
        for shard in plan
    ]
    monitor = None
    if rl is not None or prog is not None:
        def monitor(ev: dict) -> None:
            i = ev.get("task")
            if isinstance(i, int) and 0 <= i < len(labels):
                ev = {**ev, **labels[i]}
            if prog is not None:
                prog.handle(ev)
            if rl is not None:
                rl.task_event(ev)
    if monitor is not None and heartbeat_s is None:
        heartbeat_s = 5.0

    if rl is not None:
        rl.write("run_start", experiment=spec.name,
                 arms=[a.name for a in arms], n_tasks=len(tasks),
                 n_shards=len(plan) or None,
                 n_cached=(len(tasks) - len(pending)) or None)
        if plan:
            rl.write("shard_plan", n_shards=len(plan), shards=[
                {"shard": s.index, "n_points": len(s.points),
                 "est_cost_s": s.est_cost_s} for s in plan
            ])

    # --------------------------------------------------------- execute
    if plan:
        exe = executor if executor is not None else LocalExecutor(workers)
        # the per-point budget scales to the shard: a shard is one
        # dispatch unit, so its wall-clock budget covers all its points
        timeout = spec.sweep.task_timeout_s
        if timeout is not None:
            timeout = timeout * max(len(s.points) for s in plan)
        shard_results = exe.run(spec.to_json(), plan, monitor=monitor,
                                heartbeat_s=heartbeat_s,
                                task_timeout_s=timeout)
        for shard, res in zip(plan, shard_results):
            if isinstance(res, TaskError):
                err = {"error": res.error, "message": res.message,
                       "attempts": res.attempts}
                res = [PointRun(result=None, error=dict(err))
                       for _ in shard.task_ids]
            for tid, pr in zip(shard.task_ids, res):
                flat[tid] = pr
                if store is not None:
                    name, rate, seed = tasks[tid]
                    store.put(arm_by_name[name], rate, seed, pr)
    if prog is not None:
        prog.finish()
    assert all(pr is not None for pr in flat)

    # mono stamps don't compare across processes/hosts — clear them so
    # per-arm elapsed_s stays 0/absent and serialization is identical
    # between cold (computed) and warm (replayed) runs
    for pr in flat:
        pr.t_start_mono = pr.t_end_mono = 0.0

    wall = round(sum(pr.duration_s for pr in flat), 2)
    result = assemble_result(spec, arms, flat, wall)
    if store is not None:
        s1 = store.stats.as_dict()
        result.cache = {k: s1[k] - stats0[k] for k in s1}
        if rl is not None:
            rl.write("cache_stats", experiment=spec.name, **result.cache)
    if rl is not None:
        _log_run_summary(rl, result)
        if own_runlog:
            rl.close()
    return result
