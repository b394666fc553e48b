"""Engine phase profiler: where simulator wall-clock goes.

`PhaseProfiler` attributes *host* wall-clock (``time.perf_counter``) to
engine phases — arrival chunk draws, uplink stepping, wire dispatch,
routing, compute-node advance, controller epochs, fault drains, scoring —
and carries free-running counters (slots stepped vs fast-forwarded,
scalar- vs array-mode uplink slots, arrival chunks, batch iterations).
It is the host-side complement of the PR-6 `TraceRecorder`, which
instruments *simulated* time; this module instruments the simulator
itself, so perf work on the city-scale roadmap items has attribution
instead of one opaque ``duration_s`` per point.

Contracts (mirroring the recorder's):

* **Free when off.** Every hook sits behind ``if prof is not None``; the
  default path costs one attribute read per phase boundary and nothing
  else.
* **Non-perturbing when on.** The profiler only reads the monotonic
  clock and increments Python ints/floats — it never touches an RNG, a
  queue, or any control flow. Fixed-seed results with the profiler
  enabled are bit-identical to profiler-off (pinned in
  ``tests/test_runhealth.py``; gated in quick-bench with a <=1.10x
  overhead check).
* **Telescoping.** Drivers chain laps — each `lap()` returns the new
  mark, so the next phase starts exactly where the last ended and loop
  bookkeeping is absorbed into the following phase. Summed phase times
  cover >=95% of the measured total (enforced in tests and quick-bench).

The exported artifact is a plain dict (``to_profile``) riding on
``SimResult.profile`` — JSON-ready, schema-tagged, and mergeable across
seeds/points via `merge_profiles` for the per-arm rollup in
`ExperimentResult`.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional

__all__ = [
    "PROFILE_SCHEMA",
    "PhaseProfiler",
    "active_profiler",
    "merge_profiles",
]

PROFILE_SCHEMA = 1


class PhaseProfiler:
    """Accumulates wall-clock per phase plus sub-phase timings/counters.

    ``phases`` hold the top-level driver-loop attribution (telescoping:
    they sum to ~the run's total). ``sub`` holds finer-grained timings
    nested *inside* phases (e.g. ``arrival_draw`` inside ``uplink_step``)
    — informative, not part of the telescoping sum. ``counters`` are
    plain integers (slots, skips, mode switches, chunks).
    """

    __slots__ = ("phases", "sub", "counters")

    # duck-typed enable flag, mirroring TraceRecorder/NullRecorder: a
    # profiler with enabled=False normalizes to None in active_profiler()
    enabled = True

    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}
        self.sub: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}

    # ------------------------------------------------------------ timing
    def lap(self, phase: str, t_mark: float) -> float:
        """Charge ``now - t_mark`` to ``phase``; return the new mark.

        Drivers thread the returned mark into the next `lap()` call so
        consecutive phases tile the timeline with no gaps — the only
        unattributed time is the clock reads themselves.
        """
        t = perf_counter()
        ph = self.phases
        ph[phase] = ph.get(phase, 0.0) + (t - t_mark)
        return t

    def add(self, phase: str, dt: float) -> None:
        ph = self.phases
        ph[phase] = ph.get(phase, 0.0) + dt

    def add_sub(self, key: str, dt: float) -> None:
        sub = self.sub
        sub[key] = sub.get(key, 0.0) + dt

    def count(self, key: str, n: int = 1) -> None:
        c = self.counters
        c[key] = c.get(key, 0) + n

    # ------------------------------------------------------------ export
    def to_profile(self, total_s: float) -> dict:
        """Freeze into the plain schema-tagged dict that rides on results."""
        attributed = sum(self.phases.values())
        return {
            "schema": PROFILE_SCHEMA,
            "total_s": round(total_s, 6),
            "attributed_s": round(attributed, 6),
            "coverage": (
                round(attributed / total_s, 4) if total_s > 0 else None
            ),
            "phases": {k: round(v, 6) for k, v in sorted(self.phases.items())},
            "sub": {k: round(v, 6) for k, v in sorted(self.sub.items())},
            "counters": dict(sorted(self.counters.items())),
        }


def active_profiler(profiler) -> Optional[PhaseProfiler]:
    """Normalize a profiler argument: None / disabled -> None.

    Engines call this once at entry and then use the one fast check
    ``if prof is not None`` everywhere (the recorder's `active` idiom).
    """
    if profiler is None or not getattr(profiler, "enabled", False):
        return None
    return profiler


def merge_profiles(profiles: List[Optional[dict]]) -> Optional[dict]:
    """Sum per-run profile dicts into one rollup (the per-arm view).

    Phases, sub-phases, counters, and totals add; coverage is recomputed
    from the sums. Entries that are None/empty are skipped; returns None
    when nothing survives.
    """
    valid = [p for p in profiles if p]
    if not valid:
        return None
    total = 0.0
    phases: Dict[str, float] = {}
    sub: Dict[str, float] = {}
    counters: Dict[str, int] = {}
    for p in valid:
        total += p.get("total_s") or 0.0
        for k, v in (p.get("phases") or {}).items():
            phases[k] = phases.get(k, 0.0) + v
        for k, v in (p.get("sub") or {}).items():
            sub[k] = sub.get(k, 0.0) + v
        for k, v in (p.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
    attributed = sum(phases.values())
    return {
        "schema": PROFILE_SCHEMA,
        "n_runs": len(valid),
        "total_s": round(total, 6),
        "attributed_s": round(attributed, 6),
        "coverage": round(attributed / total, 4) if total > 0 else None,
        "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
        "sub": {k: round(v, 6) for k, v in sorted(sub.items())},
        "counters": dict(sorted(counters.items())),
    }
