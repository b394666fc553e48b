"""Structured run logs: one JSON line per sweep lifecycle event.

The port's copy of `repro/experiments/runlog.py` (imports and docstrings
rewritten only).

``run --runlog out.jsonl`` (or ``run(spec, runlog=...)``) appends a
machine-readable record for every run/arm/point lifecycle event — task
start/end, worker heartbeat, retry, `TaskError`, per-point duration +
peak worker RSS + engine-phase profile summary, and a final run summary.
The file is the artifact CI uploads (``benchmarks/results/
runlog_quick.jsonl``) and the raw material perf-trajectory mining and the
report's "where time goes" section consume.

Format: JSON Lines, append-only, flushed per record, sorted keys. Each
line carries ``event`` (its type), ``schema`` (`RUNLOG_SCHEMA`), ``ts``
(wall-clock epoch seconds), and ``t_s`` (seconds since the `RunLog`
opened). Appending means one file can hold several runs back to back;
`read_runlog` tolerates a truncated final line (a killed run tears at
most its last write), so a crashed sweep's log is still minable.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "RUNLOG_SCHEMA",
    "RunLog",
    "read_runlog",
    "summarize_runlog",
]

RUNLOG_SCHEMA = 1

# parallel_map monitor event kinds -> runlog event names
_KIND_EVENT = {
    "start": "task_start",
    "heartbeat": "heartbeat",
    "finish": "task_end",
    "attempt_failed": "task_attempt_failed",
    "retry": "task_retry",
    "task_error": "task_error",
}


class RunLog:
    """Append-only JSONL writer for sweep lifecycle events.

    Thread-safe (`parallel_map`'s event drainer and the runner both
    write); every record is flushed so a killed run loses at most the
    line being written. Usable as a context manager.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def write(self, event: str, **fields) -> None:
        """Append one event record (None-valued fields are dropped)."""
        rec = {
            "event": event,
            "schema": RUNLOG_SCHEMA,
            "ts": round(time.time(), 3),
            "t_s": round(time.monotonic() - self._t0, 3),
        }
        rec.update((k, v) for k, v in fields.items() if v is not None)
        line = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def task_event(self, ev: dict) -> None:
        """Log one `parallel_map` monitor event (unknown kinds ignored)."""
        ev = dict(ev)
        name = _KIND_EVENT.get(ev.pop("kind", None))
        if name is not None:
            self.write(name, **ev)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_runlog(path: str) -> List[dict]:
    """Parse a runlog back into a list of event dicts.

    An undecodable *final* line is tolerated (a run killed mid-write
    tears exactly its last record); corruption anywhere else raises —
    that is not a torn tail but a damaged file.
    """
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    nonempty = [k for k, ln in enumerate(lines) if ln.strip()]
    events: List[dict] = []
    for k in nonempty:
        try:
            events.append(json.loads(lines[k]))
        except json.JSONDecodeError:
            if k == nonempty[-1]:
                break  # torn tail write of a killed run
            raise ValueError(f"{path}:{k + 1}: corrupt runlog line")
    return events


def summarize_runlog(events: List[dict]) -> dict:
    """Mine a runlog into the per-point rollup the report renders.

    Returns counts (runs, points, errors, retries, heartbeats), summed
    task-seconds, the peak worker RSS seen, a deterministic per-point
    list (sorted by arm/rate/seed) with durations and RSS, and summed
    engine-phase seconds across every point that carried a profile.
    """
    points = [e for e in events if e.get("event") == "point"]
    phases: Dict[str, float] = {}
    for e in points:
        for k, v in ((e.get("profile") or {}).get("phases") or {}).items():
            phases[k] = phases.get(k, 0.0) + v
    rss = [e["peak_rss_mb"] for e in points
           if e.get("peak_rss_mb") is not None]
    return {
        "n_events": len(events),
        "n_runs": sum(1 for e in events if e.get("event") == "run_start"),
        "n_points": len(points),
        "n_errors": sum(1 for e in points if e.get("error")),
        "n_retries": sum(
            1 for e in events if e.get("event") == "task_retry"
        ),
        "n_heartbeats": sum(
            1 for e in events if e.get("event") == "heartbeat"
        ),
        "task_seconds": round(
            sum(e.get("duration_s") or 0.0 for e in points), 3
        ),
        "peak_rss_mb": max(rss) if rss else None,
        "points": sorted(
            (
                {
                    "arm": e.get("arm"),
                    "rate": e.get("rate"),
                    "seed": e.get("seed"),
                    "duration_s": e.get("duration_s"),
                    "peak_rss_mb": e.get("peak_rss_mb"),
                    "error": e.get("error"),
                }
                for e in points
            ),
            key=lambda p: (str(p["arm"]), p["rate"] or 0.0, p["seed"] or 0),
        ),
        "phases": {k: round(v, 6) for k, v in sorted(phases.items())},
    }
