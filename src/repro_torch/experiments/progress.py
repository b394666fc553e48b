"""Live sweep progress: `parallel_map` monitor events -> one status line.

The port's copy of `repro/experiments/progress.py` (imports and docstrings
rewritten only).

`SweepProgress.handle` consumes the per-task lifecycle events the runner
fans out (start / heartbeat / finish / retry / task_error) and renders a
throttled, carriage-return-overwritten single line:

    [sweep] 34/96 points  2 running  1 errors  eta 1m40s  on icc,mec_only

TTY-aware by design: the default (``enabled=None``) auto-detects
``out.isatty()`` and stays completely silent when the stream is piped or
redirected, so ``run --progress`` never corrupts captured output or CI
logs. The ETA is summed-finished-duration extrapolation divided by the
number of distinct worker pids seen — crude, honest, and cheap.

Purely observational and parent-side only: rendering never touches
results, and a rendering problem never fails the sweep (the runner wraps
callbacks). Out/clock are injectable for deterministic tests.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, TextIO

__all__ = ["SweepProgress"]


def _fmt_s(seconds: float) -> str:
    s = int(round(seconds))
    if s >= 3600:
        return f"{s // 3600}h{(s % 3600) // 60:02d}m"
    if s >= 60:
        return f"{s // 60}m{s % 60:02d}s"
    return f"{s}s"


class SweepProgress:
    """Aggregates monitor events into done/running/error counts + ETA."""

    def __init__(
        self,
        total: int,
        out: Optional[TextIO] = None,
        enabled: Optional[bool] = None,
        min_interval_s: float = 0.25,
        clock=time.monotonic,
    ):
        self.total = int(total)
        self.out = sys.stderr if out is None else out
        if enabled is None:
            isatty = getattr(self.out, "isatty", None)
            enabled = bool(isatty and isatty())
        self.enabled = enabled
        self.min_interval_s = min_interval_s
        self.clock = clock
        self.done = 0
        self.errors = 0
        self.retries = 0
        self.running: Dict[int, str] = {}  # task idx -> arm label
        self.workers: Dict[int, float] = {}  # pid -> last event time
        self._sum_duration = 0.0
        self._last_render = float("-inf")
        self._dirty = False  # an overwritten line needs a final newline

    # ----------------------------------------------------------- events
    def handle(self, ev: dict) -> None:
        kind = ev.get("kind")
        pid = ev.get("pid")
        if pid is not None:
            self.workers[pid] = self.clock()
        i = ev.get("task")
        if kind == "start":
            self.running[i] = str(ev.get("arm") or "")
        elif kind == "finish":
            self.running.pop(i, None)
            self.done += 1
            self._sum_duration += ev.get("duration_s") or 0.0
        elif kind == "attempt_failed":
            self.running.pop(i, None)  # a retry may restart it
        elif kind == "retry":
            self.retries += 1
        elif kind == "task_error":
            self.running.pop(i, None)
            self.done += 1
            self.errors += 1
        self.render()

    # ---------------------------------------------------------- display
    def eta_s(self) -> Optional[float]:
        if self.done == 0 or self._sum_duration <= 0.0:
            return None
        lanes = max(len(self.workers), 1)
        remaining = max(self.total - self.done, 0)
        return self._sum_duration / self.done * remaining / lanes

    def line(self) -> str:
        parts = [
            f"[sweep] {min(self.done, self.total)}/{self.total} points",
            f"{len(self.running)} running",
        ]
        if self.errors:
            parts.append(f"{self.errors} errors")
        if self.retries:
            parts.append(f"{self.retries} retries")
        eta = self.eta_s()
        if eta is not None and self.done < self.total:
            parts.append(f"eta {_fmt_s(eta)}")
        arms = sorted({a for a in self.running.values() if a})
        if arms:
            parts.append("on " + ",".join(arms[:3]))
        return "  ".join(parts)

    def render(self, force: bool = False) -> None:
        if not self.enabled:
            return
        now = self.clock()
        if not force and now - self._last_render < self.min_interval_s:
            return
        self._last_render = now
        # \r + erase-to-eol: overwrite in place, no scrollback spam
        self.out.write("\r" + self.line() + "\x1b[K")
        self.out.flush()
        self._dirty = True

    def finish(self) -> None:
        """Final render + newline so the shell prompt lands clean."""
        if not self.enabled:
            return
        self.render(force=True)
        if self._dirty:
            self.out.write("\n")
            self.out.flush()
            self._dirty = False
