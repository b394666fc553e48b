"""Benchmark suites: named groups of registered experiments + writers
(the port's copy of `repro/experiments/suites.py`).

A suite names several registered experiments and, for each, the tracked
``BENCH_*.json`` file it regenerates and the ``bench_doc`` formatter that
renders an `ExperimentResult` into that file's wrapper shape
(``{schema_version, experiment, headline, result}``). One command
regenerates every tracked baseline:

    python -m repro_torch.experiments suite run bench_all --cache DIR --shards N
    python -m repro_torch.experiments suite run bench_quick --cache DIR

Execution goes through the sharded dispatcher
(`repro_torch.experiments.dispatch.run_sharded`), sharing one `ResultCache`
across the suite's experiments — a warm-cache rerun replays every point
and rewrites every result file byte-identically while doing near-zero
simulation work.

Writers are dotted references (``"repro_torch.experiments.bench_docs:
network_capacity"``) resolved lazily at run/validate time. Unlike the
reference's, which name the ``benchmarks`` scripts (those import `repro`),
the port's writers live in `bench_docs.py`, so a suite runs from any
directory with ``src/`` on the path."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple, Union

from .cache import ResultCache
from .dispatch import run_sharded
from .registry import get_experiment
from .result import ExperimentResult

__all__ = [
    "Suite",
    "SuiteEntry",
    "get_suite",
    "list_suites",
    "register_suite",
    "resolve_writer",
    "run_suite",
    "write_bench_doc",
]


@dataclasses.dataclass(frozen=True)
class SuiteEntry:
    """One experiment of a suite: what to run, how to render it, where
    the rendered baseline lives (repo-root-relative)."""

    experiment: str  # registered experiment name (registry.get_experiment)
    bench_path: str  # tracked BENCH_*.json this entry regenerates
    writer: str      # "pkg.module:function" -> bench_doc(result) -> dict


@dataclasses.dataclass(frozen=True)
class Suite:
    name: str
    description: str
    entries: Tuple[SuiteEntry, ...]


_SUITES: Dict[str, Suite] = {}


def register_suite(suite: Suite, *, replace: bool = False) -> Suite:
    if not isinstance(suite, Suite):
        raise TypeError(f"expected Suite, got {type(suite).__name__}")
    if not replace and suite.name in _SUITES:
        raise ValueError(
            f"suite {suite.name!r} is already registered; pass "
            "replace=True to override it deliberately"
        )
    if not suite.entries:
        raise ValueError(f"suite {suite.name!r} has no entries")
    paths = [e.bench_path for e in suite.entries]
    if len(set(paths)) != len(paths):
        raise ValueError(
            f"suite {suite.name!r} writes one file twice: {paths}"
        )
    _SUITES[suite.name] = suite
    return suite


def get_suite(name: str) -> Suite:
    try:
        return _SUITES[name]
    except KeyError:
        raise KeyError(
            f"unknown suite {name!r}; known: {sorted(_SUITES)}"
        ) from None


def list_suites() -> List[str]:
    return sorted(_SUITES)


def resolve_writer(ref: str) -> Callable[[ExperimentResult], dict]:
    """Resolve a ``"pkg.module:function"`` writer reference. Failures
    carry the reference so a typo'd suite entry is diagnosable."""
    mod_name, sep, fn_name = ref.partition(":")
    if not sep or not mod_name or not fn_name:
        raise ValueError(f"writer {ref!r} is not 'pkg.module:function'")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as exc:
        raise ImportError(
            f"suite writer {ref!r}: cannot import {mod_name!r} ({exc})"
        ) from exc
    fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise AttributeError(
            f"suite writer {ref!r}: {mod_name} has no callable {fn_name!r}"
        )
    return fn


def write_bench_doc(doc: dict, path: str) -> None:
    """Write one baseline wrapper in the exact byte format the benchmark
    scripts use (``json.dump(..., indent=1, sort_keys=True)``), via an
    atomic tmp-file + rename so a killed suite never tears a tracked
    file."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def run_suite(
    name: str,
    cache: Union[str, ResultCache, None] = None,
    shards: Optional[int] = None,
    workers: Union[int, str, None] = None,
    root: str = ".",
    runlog: Union[str, object, None] = None,
    progress: Union[bool, object, None] = None,
) -> dict:
    """Run every entry of suite `name` and regenerate its tracked files.

    One `ResultCache` is shared across the whole suite (``cache`` may be
    a directory path), so stats accumulate suite-wide; each experiment
    still reports its own per-run delta on ``result.cache``. ``root``
    rebases the entries' repo-root-relative ``bench_path``s (tests point
    it at a tmpdir). Returns a summary dict: per-entry file/arms/timing/
    cache-delta rows plus the suite-wide cache totals.
    """
    suite = get_suite(name)
    writers = [resolve_writer(e.writer) for e in suite.entries]
    store: Optional[ResultCache] = None
    if cache is not None:
        store = cache if isinstance(cache, ResultCache) else ResultCache(cache)

    entries = []
    results: Dict[str, ExperimentResult] = {}
    for entry, writer in zip(suite.entries, writers):
        spec = get_experiment(entry.experiment)
        result = run_sharded(
            spec, shards=shards, cache=store, workers=workers,
            runlog=runlog, progress=progress,
        )
        doc = writer(result)
        path = os.path.join(root, entry.bench_path)
        write_bench_doc(doc, path)
        results[entry.experiment] = result
        entries.append({
            "experiment": entry.experiment,
            "bench_path": entry.bench_path,
            "n_arms": len(result.arms),
            "n_points": sum(
                len(p.seeds) for a in result.arms for p in a.points
            ),
            "task_seconds": result.wall_clock_s,
            "cache": result.cache,
        })
    total: Optional[Dict[str, int]] = None
    if store is not None:
        total = {"hits": 0, "misses": 0, "stale": 0, "writes": 0}
        for row in entries:
            for k in total:
                total[k] += (row["cache"] or {}).get(k, 0)
    return {
        "suite": suite.name,
        "entries": entries,
        "cache": total,
        "results": results,
    }


# ------------------------------------------------- shipped suite catalog
_WRITERS = "repro_torch.experiments.bench_docs:"

# bench_all regenerates the tracked repo-root baselines (full-fidelity
# grids); bench_quick regenerates the reduced CI copies under
# benchmarks/results/. Entry experiments must stay registered and the
# bench_all paths must cover validate.BENCH_BASELINES —
# validate.validate_suite_coverage checks both, and CI runs it.
register_suite(Suite(
    name="bench_all",
    description="every tracked repo-root BENCH_*.json baseline",
    entries=(
        SuiteEntry("network_capacity", "BENCH_network.json",
                   _WRITERS + "network_capacity"),
        SuiteEntry("batching_capacity", "BENCH_batching.json",
                   _WRITERS + "batching_capacity"),
        SuiteEntry("control_capacity", "BENCH_control.json",
                   _WRITERS + "control_capacity"),
        SuiteEntry("resilience", "BENCH_resilience.json",
                   _WRITERS + "resilience"),
    ),
))
register_suite(Suite(
    name="bench_quick",
    description="reduced CI grids (benchmarks/results/BENCH_*_quick.json)",
    entries=(
        SuiteEntry("network_capacity_quick",
                   "benchmarks/results/BENCH_network_quick.json",
                   _WRITERS + "network_capacity"),
        SuiteEntry("batching_capacity_quick",
                   "benchmarks/results/BENCH_batching_quick.json",
                   _WRITERS + "batching_capacity"),
        SuiteEntry("control_capacity_quick",
                   "benchmarks/results/BENCH_control_quick.json",
                   _WRITERS + "control_capacity"),
        SuiteEntry("resilience_quick",
                   "benchmarks/results/BENCH_resilience_quick.json",
                   _WRITERS + "resilience"),
    ),
))
