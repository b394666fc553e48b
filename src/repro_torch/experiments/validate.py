"""Schema validation for the tracked benchmark baselines.

The port's copy of `repro/experiments/validate.py` (imports and docstrings
rewritten only).

Every tracked capacity baseline (``BENCH_network.json``,
``BENCH_batching.json``, ``BENCH_control.json``,
``BENCH_resilience.json``) is a wrapper around an `ExperimentResult`
payload:

    {
      "schema_version": <int>,      # must match the current schema
      "experiment": "<name>",       # the registered spec it was run from
      "headline": {...},            # the benchmark's compact claim numbers
      "result": {ExperimentResult.to_dict(points="none")},
    }

``validate_bench()`` re-parses each file through the real
``ExperimentResult.from_dict`` (so the spec echo, curves, and version all
round-trip) and cross-checks internal consistency. CI runs it after the
quick benchmark pass: accidental schema drift — or a hand-edited baseline
— fails loudly instead of silently de-synchronizing the tracked numbers
from the code that reads them.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from .result import ExperimentResult
from .spec import SCHEMA_VERSION

__all__ = [
    "BENCH_BASELINES",
    "validate_bench",
    "validate_bench_file",
    "validate_suite_coverage",
]

# repo-root tracked baselines produced by the capacity benchmarks
BENCH_BASELINES = (
    "BENCH_network.json",
    "BENCH_batching.json",
    "BENCH_control.json",
    "BENCH_resilience.json",
)


def validate_bench_file(path: str) -> List[str]:
    """Validate one tracked baseline; returns a list of problems (empty =
    valid)."""
    problems: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        return [f"{path}: unreadable ({exc})"]

    version = doc.get("schema_version")
    if version != SCHEMA_VERSION:
        problems.append(
            f"{path}: schema_version {version!r} != current {SCHEMA_VERSION} "
            "(regenerate the baseline or bump deliberately)"
        )
    for key in ("experiment", "headline", "result"):
        if key not in doc:
            problems.append(f"{path}: missing required key {key!r}")
    if problems:
        return problems

    try:
        result = ExperimentResult.from_dict(doc["result"])
    except (KeyError, TypeError, ValueError) as exc:
        return [f"{path}: result payload does not parse as an "
                f"ExperimentResult ({exc})"]

    if result.experiment != doc["experiment"]:
        problems.append(
            f"{path}: experiment {doc['experiment']!r} != result's "
            f"{result.experiment!r}"
        )
    if not result.arms:
        problems.append(f"{path}: result has no arms")
    for arm in result.arms:
        c = arm.curve
        if len(c.rates) != len(c.satisfaction):
            problems.append(
                f"{path}: arm {arm.name!r} curve has {len(c.rates)} rates "
                f"but {len(c.satisfaction)} satisfaction points"
            )
    # the spec echo must itself round-trip (from_dict already decoded it;
    # re-encode to prove the loop closes)
    reparsed = type(result.spec).from_dict(result.spec.to_dict())
    if reparsed != result.spec:
        problems.append(f"{path}: spec echo does not round-trip")
    return problems


def validate_bench(
    paths: Optional[Sequence[str]] = None, root: str = "."
) -> List[str]:
    """Validate the tracked baselines (or explicit `paths`); returns all
    problems found. Missing default baselines are reported — a tracked
    file disappearing is exactly the drift this check exists to catch."""
    if paths is None:
        paths = [os.path.join(root, p) for p in BENCH_BASELINES]
    problems: List[str] = []
    for p in paths:
        problems.extend(validate_bench_file(p))
    return problems


def validate_suite_coverage() -> List[str]:
    """Check the suite catalog against the tracked-baseline list.

    Every tracked baseline in `BENCH_BASELINES` must be regenerated by
    the ``bench_all`` suite (else ``suite run bench_all`` silently lets
    a tracked file go stale), every suite entry must reference a
    registered experiment, and every writer must resolve to a callable.
    Returns all problems found (empty = covered). Imports the suite
    catalog lazily.
    """
    from .registry import list_experiments
    from .suites import get_suite, list_suites, resolve_writer

    problems: List[str] = []
    try:
        bench_all = get_suite("bench_all")
    except KeyError:
        return ["suite 'bench_all' is not registered"]
    covered = {e.bench_path for e in bench_all.entries}
    for baseline in BENCH_BASELINES:
        if baseline not in covered:
            problems.append(
                f"tracked baseline {baseline!r} is not regenerated by "
                "suite 'bench_all'"
            )
    known = set(list_experiments())
    for suite_name in list_suites():
        for entry in get_suite(suite_name).entries:
            if entry.experiment not in known:
                problems.append(
                    f"suite {suite_name!r} entry {entry.bench_path!r} "
                    f"references unregistered experiment "
                    f"{entry.experiment!r}"
                )
            try:
                resolve_writer(entry.writer)
            except (ImportError, AttributeError, ValueError) as exc:
                problems.append(
                    f"suite {suite_name!r} writer {entry.writer!r} does "
                    f"not resolve: {exc}"
                )
    return problems
