"""Unified experiment results: one schema for every capacity study.

The port's copy of `repro/experiments/result.py` (imports and docstrings
rewritten only).

`run(spec)` returns an `ExperimentResult`: per-arm `CapacityCurve`s
(the Def.-1 satisfaction curve over the rate grid, the interpolated Def.-2
capacity, and the `saturated` flag marking curves that never crossed
alpha in the swept range — a lower bound, not a capacity), per-point
per-seed `SimResult`s with engine counters (`extras`: KV-cache pressure,
route shares, admission rejections, handovers), the spec echo, wall-clock,
and a schema version. ``to_dict``/``from_dict`` round-trip the whole tree;
``to_json`` emits stable (sorted-key) JSON, the form the tracked
``BENCH_*.json`` baselines store and ``validate-bench`` checks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from ..core.simulator import SimResult
from .spec import _COMPAT_VERSIONS, SCHEMA_VERSION, ExperimentSpec

__all__ = [
    "PointRun",
    "PointResult",
    "CapacityCurve",
    "ArmResult",
    "ExperimentResult",
    "load_result",
]


@dataclasses.dataclass
class PointRun:
    """One simulation: a scored `SimResult` plus engine counters that live
    outside Def.-1 scoring (batched-node KV/batch stats, network route
    shares, controller admission counts, mobility handovers)."""

    result: Optional[SimResult]
    extras: Dict[str, object] = dataclasses.field(default_factory=dict)
    # wall-clock of this one simulation (seconds); lets sweep-time
    # regressions be attributed to a specific (arm, rate, seed) point
    duration_s: float = 0.0
    # structured failure record (resilient sweeps, core.parallel.TaskError):
    # {"error", "message", "attempts"} when this point could not be
    # computed — `result` is None and seed-means simply skip the point
    error: Optional[Dict[str, object]] = None
    # peak RSS (MB) of the process that ran this point — a worker-lifetime
    # high-water mark (ru_maxrss), so readings from a reused worker are
    # monotone across its points; None when monitoring was off
    peak_rss_mb: Optional[float] = None
    # runtime-only monotonic stamps set by the runner (NOT serialized):
    # arm elapsed wall is max(t_end) - min(t_start) over its points —
    # CLOCK_MONOTONIC is system-wide on Linux, so worker stamps compare
    t_start_mono: float = 0.0
    t_end_mono: float = 0.0
    # runtime-only (NOT serialized): this run replayed the point from a
    # `repro_torch.experiments.cache.ResultCache` instead of simulating it —
    # kept out of the serialized form so warm and cold runs of the same
    # spec emit byte-identical result files
    cached: bool = False


@dataclasses.dataclass
class PointResult:
    """One rate on one arm's grid: the per-seed runs + their seed-mean
    (`core.capacity.mean_over_seeds`: NaN-safe, window-pooling)."""

    rate: float
    mean: Optional[SimResult]  # None when every seed errored (resilient)
    seeds: List[PointRun]


@dataclasses.dataclass
class CapacityCurve:
    """Def.-1 satisfaction over the rate grid and the Def.-2 readout."""

    rates: List[float]
    satisfaction: List[float]  # seed-averaged Def.-1 satisfaction per rate
    capacity: float  # lambda*: largest rate holding satisfaction >= alpha
    saturated: bool  # curve never crossed alpha: capacity is a lower bound
    alpha: float


@dataclasses.dataclass
class ArmResult:
    name: str
    curve: CapacityCurve
    points: List[PointResult]
    # summed per-point task-seconds across this arm's grid (attributable
    # compute time, added across workers); under a process pool this can
    # exceed — and must not be confused with — elapsed wall-clock
    wall_clock_s: float = 0.0
    # true elapsed wall-clock for this arm: last point end minus first
    # point start (monotonic stamps); 0.0 when the runner didn't stamp
    elapsed_s: float = 0.0
    # merged engine-phase profile across this arm's profiled points
    # (repro_torch.telemetry.profile.merge_profiles); None on unprofiled runs
    profile: Optional[dict] = None


@dataclasses.dataclass
class ExperimentResult:
    experiment: str
    spec: ExperimentSpec
    arms: List[ArmResult]
    wall_clock_s: float
    schema_version: int = SCHEMA_VERSION
    # runtime-only (NOT serialized): per-run cache accounting attached by
    # the sharded dispatcher — {"hits", "misses", "stale", "writes"}.
    # Deliberately outside to_dict: a warm rerun must reproduce a cold
    # run's result files byte-identically, and hit counts differ by
    # definition. The runlog and the suite cache-stats artifact carry it.
    cache: Optional[Dict[str, int]] = None

    def arm(self, name: str) -> ArmResult:
        for a in self.arms:
            if a.name == name:
                return a
        raise KeyError(
            f"no arm {name!r}; known: {[a.name for a in self.arms]}"
        )

    # ---------------------------------------------------------- serialize
    def to_dict(self, points: str = "full") -> dict:
        """`points` controls per-point detail: "full" (per-seed SimResults
        + extras), "mean" (seed-means only), "none" (curves only — the
        compact form tracked baselines store)."""
        if points not in ("full", "mean", "none"):
            raise ValueError(f"points must be full/mean/none, got {points!r}")

        def enc_point(p: PointResult) -> dict:
            d = {
                "rate": p.rate,
                "mean": (
                    dataclasses.asdict(p.mean) if p.mean is not None else None
                ),
            }
            if points == "full":
                d["seeds"] = [
                    {"result": (
                        dataclasses.asdict(s.result)
                        if s.result is not None else None
                     ),
                     "extras": dict(s.extras),
                     "duration_s": s.duration_s,
                     # conditional so results written before run-health
                     # monitoring re-serialize byte-identically
                     **({"peak_rss_mb": s.peak_rss_mb}
                        if s.peak_rss_mb is not None else {}),
                     **({"error": dict(s.error)} if s.error else {})}
                    for s in p.seeds
                ]
            return d

        return {
            "schema_version": self.schema_version,
            "experiment": self.experiment,
            "spec": self.spec.to_dict(),
            "wall_clock_s": self.wall_clock_s,
            "arms": [
                {
                    "name": a.name,
                    "curve": dataclasses.asdict(a.curve),
                    "wall_clock_s": a.wall_clock_s,
                    # conditional (see peak_rss_mb above): files written
                    # before per-arm timing must re-serialize without these
                    **({"elapsed_s": a.elapsed_s} if a.elapsed_s else {}),
                    **({"profile": a.profile} if a.profile else {}),
                    "points": (
                        [] if points == "none"
                        else [enc_point(p) for p in a.points]
                    ),
                }
                for a in self.arms
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentResult":
        version = d.get("schema_version")
        if version not in _COMPAT_VERSIONS:
            raise ValueError(
                f"result schema_version {version!r} not in supported "
                f"{_COMPAT_VERSIONS}"
            )

        def dec_sim(sd: Optional[dict]) -> Optional[SimResult]:
            return SimResult(**sd) if sd is not None else None

        arms = []
        for ad in d["arms"]:
            points = [
                PointResult(
                    rate=pd["rate"],
                    mean=dec_sim(pd["mean"]),
                    seeds=[
                        PointRun(result=dec_sim(sd["result"]),
                                 extras=dict(sd.get("extras", {})),
                                 duration_s=sd.get("duration_s", 0.0),
                                 error=sd.get("error"),
                                 peak_rss_mb=sd.get("peak_rss_mb"))
                        for sd in pd.get("seeds", [])
                    ],
                )
                for pd in ad.get("points", [])
            ]
            arms.append(
                ArmResult(
                    name=ad["name"],
                    curve=CapacityCurve(**ad["curve"]),
                    points=points,
                    # absent in baselines written before per-arm timing
                    wall_clock_s=ad.get("wall_clock_s", 0.0),
                    elapsed_s=ad.get("elapsed_s", 0.0),
                    profile=ad.get("profile"),
                )
            )
        return cls(
            experiment=d["experiment"],
            spec=ExperimentSpec.from_dict(d["spec"]),
            arms=arms,
            wall_clock_s=d["wall_clock_s"],
            schema_version=version,
        )

    def to_json(self, points: str = "full") -> str:
        return json.dumps(self.to_dict(points=points), indent=1, sort_keys=True)

    def to_canonical_dict(self, points: str = "full") -> dict:
        """The *physics* of the result with every timing/monitoring field
        normalized out: wall-clocks zeroed, elapsed/profile/duration/RSS
        keys dropped. Two runs of the same spec — serial vs pooled,
        single-process vs sharded, cold vs warm cache — must agree on
        this form exactly; it is what the shard-merge bit-identity tests
        and the CI cache gate compare."""
        d = self.to_dict(points=points)
        d["wall_clock_s"] = 0.0
        for a in d["arms"]:
            a["wall_clock_s"] = 0.0
            a.pop("elapsed_s", None)
            a.pop("profile", None)
            for p in a["points"]:
                for s in p.get("seeds", []):
                    s["duration_s"] = 0.0
                    s.pop("peak_rss_mb", None)
        return d

    def to_canonical_json(self, points: str = "full") -> str:
        return json.dumps(
            self.to_canonical_dict(points=points), indent=1, sort_keys=True
        )

    def drop_reason_totals(self) -> Dict[str, Dict[str, int]]:
        """Per-arm loss attribution summed over every stored point mean
        (empty dicts when the result predates reason codes or stores no
        points). Keys sorted for stable serialization."""
        out: Dict[str, Dict[str, int]] = {}
        for a in self.arms:
            merged: Dict[str, int] = {}
            for p in a.points:
                if p.mean is None:
                    continue
                for reason, k in (p.mean.drop_reasons or {}).items():
                    merged[reason] = merged.get(reason, 0) + k
            out[a.name] = dict(sorted(merged.items()))
        return out

    # ------------------------------------------------------------ display
    def summary(self) -> str:
        lines = [f"experiment {self.experiment}  "
                 f"({len(self.arms)} arms, {self.wall_clock_s:.1f}s)"]
        for a in self.arms:
            c = a.curve
            mark = ">=" if c.saturated else "  "
            lines.append(
                f"  {a.name:24s} capacity{mark}{c.capacity:8.2f} jobs/s  "
                f"sat@{c.rates[0]:g}={c.satisfaction[0]:.3f}"
                + (f"  sat@{c.rates[-1]:g}={c.satisfaction[-1]:.3f}"
                   if len(c.rates) > 1 else "")
            )
        slowest = max(self.arms, key=lambda a: a.wall_clock_s, default=None)
        if slowest is not None and slowest.wall_clock_s > 0.0:
            total = sum(a.wall_clock_s for a in self.arms)
            elapsed = (
                f"; {slowest.elapsed_s:.1f}s elapsed"
                if slowest.elapsed_s > 0.0 else ""
            )
            lines.append(
                f"  slowest arm: {slowest.name} "
                f"({slowest.wall_clock_s:.1f}s of {total:.1f}s summed "
                f"task-seconds{elapsed})"
            )
        if self.cache is not None:
            c = self.cache
            lines.append(
                f"  cache: {c.get('hits', 0)} hits, "
                f"{c.get('misses', 0)} misses, {c.get('stale', 0)} stale, "
                f"{c.get('writes', 0)} writes"
            )
        return "\n".join(lines)


def load_result(path: str):
    """Load a result JSON from disk: either a raw ``ExperimentResult``
    dump (``run --out``) or a tracked ``BENCH_*.json`` wrapper
    (``{schema_version, experiment, headline, result}``).

    Returns ``(result, headline)`` — ``headline`` is the wrapper's compact
    claim dict, or None for raw results. The single loader the offline
    report generator (`repro_torch.telemetry.report`) uses, so both forms render
    without re-simulating anything.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "schema_version" not in doc:
        raise ValueError(
            f"{path}: not an experiment result (no schema_version; "
            f"top-level keys: {sorted(doc)[:6]}) — only ExperimentResult "
            f"dumps and tracked capacity baselines render as reports"
        )
    if "result" in doc and "arms" not in doc:
        # tracked-baseline wrapper around the ExperimentResult payload
        return ExperimentResult.from_dict(doc["result"]), doc.get("headline")
    return ExperimentResult.from_dict(doc), None
