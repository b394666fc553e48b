"""Process-pool plumbing for capacity sweeps.

Sweep grids (rate x seed x policy) are embarrassingly parallel: every point
is an independent simulation with its own derived seed, so running them in a
`ProcessPoolExecutor` changes nothing but wall-clock — results are collected
back in submission order and each point's RNG stream is untouched
(equivalence-tested in tests/test_fast_sim.py).

Parallelism is opt-in (`workers=0` keeps the historical serial path).
Tasks are batched per worker dispatch (`chunk=`, auto-sized by default) to
amortize process startup and pickling on small grids — a pure dispatch
knob: results are identical to serial at any chunking. The
callable and every argument must be picklable — module-level functions,
`functools.partial` over dataclasses, or callable class instances; closures
over local state only work serially. On platforms where worker processes
cannot be spawned (sandboxes), `parallel_map` degrades to the serial path
with a warning rather than failing the sweep.

Resilient mode (``task_timeout_s=``) hardens long sweeps for CI: each task
gets a per-attempt wall-clock budget and bounded retries, and a point that
keeps timing out or raising yields a structured `TaskError` in its result
slot instead of hanging the pipeline or aborting the grid.

Monitoring (``monitor=`` / ``heartbeat_s=``) streams per-task lifecycle
events — start, periodic heartbeat, finish with duration and peak RSS,
retry, final error — from the workers back to a parent-side callback over
a multiprocessing queue. Purely observational: a sweep returns identical
results with monitoring on or off, and a broken event queue degrades to
silence, never to failure. Heartbeats also feed resilient mode: a task
whose worker is actively heartbeating is never declared wedged, so
``task_timeout_s`` only fires on genuinely silent workers.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "resolve_workers", "resolve_chunk", "parallel_map", "TaskError",
    "peak_rss_mb",
]

# package logger: sweeps/tests capture or silence diagnostics via the
# standard logging tree ("repro_torch" and children) instead of scraping stderr
logger = logging.getLogger("repro_torch.parallel")


def resolve_workers(workers: Union[int, str, None]) -> int:
    """Normalize a `workers=` argument to a concrete process count.

    0/1/None -> serial; "auto" or any negative int -> one per CPU.
    """
    if workers is None:
        return 0
    if workers == "auto":
        return os.cpu_count() or 1
    workers = int(workers)
    if workers < 0:
        return os.cpu_count() or 1
    return workers


def _run_chunk(fn: Callable, chunk: Sequence[Tuple]) -> List:
    """One worker dispatch: a batch of grid points, results in order."""
    return [fn(*t) for t in chunk]


def peak_rss_mb() -> Optional[float]:
    """Peak RSS of the calling process in MB, or None when unavailable.

    ``getrusage(...).ru_maxrss`` is KiB on Linux but bytes on macOS; the
    value is a process-lifetime high-water mark, so per-task readings from
    a reused worker are monotone (the biggest point a worker has run so
    far), not per-task deltas.
    """
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        scale = 2 ** 20 if sys.platform == "darwin" else 1024.0
        return round(peak / scale, 1)
    except Exception:
        return None


class _Monitor:
    """Parent-side event hub for one `parallel_map` call.

    Stamps per-task liveness (`seen_within`) on every event it receives
    and forwards the event to the user callback. Thread-safe: the queue
    drainer thread and the resilient wait loop touch it concurrently. A
    raising callback is logged and dropped — observation never fails the
    sweep.
    """

    def __init__(self, callback: Optional[Callable[[dict], None]]):
        self._callback = callback
        self._last_seen: Dict[int, float] = {}
        self._lock = threading.Lock()

    def handle(self, ev: dict) -> None:
        idx = ev.get("task")
        if isinstance(idx, int):
            with self._lock:
                self._last_seen[idx] = time.monotonic()
        if self._callback is not None:
            try:
                self._callback(ev)
            except Exception:
                logger.exception("monitor callback failed")

    def seen_within(self, idx: int, window_s: float) -> bool:
        with self._lock:
            t = self._last_seen.get(idx)
        return t is not None and (time.monotonic() - t) <= window_s


class _MonitoredTask:
    """Picklable worker-side wrapper: ``fn(*task)`` plus lifecycle events.

    Emits start / heartbeat / finish (or attempt_failed) events over a
    Manager queue. The heartbeat runs on a daemon thread so it keeps
    beating while the task itself is deep in numpy. `_put` swallows queue
    errors: eventing must never fail the simulation it observes.
    """

    def __init__(self, fn: Callable, queue, heartbeat_s: Optional[float]):
        self.fn = fn
        self.queue = queue
        self.heartbeat_s = heartbeat_s

    def _put(self, ev: dict) -> None:
        try:
            self.queue.put(ev)
        except Exception:
            pass

    def _beat(self, idx: int, pid: int, stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_s):
            self._put({"kind": "heartbeat", "task": idx, "pid": pid})

    def __call__(self, idx: int, task: Tuple):
        pid = os.getpid()
        t0 = time.perf_counter()
        self._put({"kind": "start", "task": idx, "pid": pid})
        stop = None
        if self.heartbeat_s is not None and self.heartbeat_s > 0:
            stop = threading.Event()
            threading.Thread(
                target=self._beat, args=(idx, pid, stop), daemon=True
            ).start()
        try:
            out = self.fn(*task)
        except BaseException as exc:
            if stop is not None:
                stop.set()
            self._put({
                "kind": "attempt_failed", "task": idx, "pid": pid,
                "error": type(exc).__name__,
                "duration_s": round(time.perf_counter() - t0, 4),
            })
            raise
        if stop is not None:
            stop.set()
        self._put({
            "kind": "finish", "task": idx, "pid": pid, "ok": True,
            "duration_s": round(time.perf_counter() - t0, 4),
            "peak_rss_mb": peak_rss_mb(),
        })
        return out


def _run_chunk_monitored(mt: "_MonitoredTask", chunk, base_idx: int) -> List:
    """Chunked dispatch through the monitored wrapper (global task ids)."""
    return [mt(base_idx + k, t) for k, t in enumerate(chunk)]


def _drain_events(q, mon: "_Monitor") -> None:
    """Parent thread: pump worker events into the monitor until sentinel."""
    while True:
        try:
            ev = q.get()
        except (EOFError, OSError):
            return
        if ev is None:
            return
        mon.handle(ev)


def _serial_map(
    fn: Callable,
    tasks: Sequence[Tuple],
    monitor: Optional[Callable[[dict], None]],
    resilient: bool,
    tries: int,
) -> List:
    """Serial execution with synchronous monitor events (heartbeats don't
    apply: nothing runs concurrently with the parent)."""
    mon = _Monitor(monitor)
    pid = os.getpid()
    results: List = []
    for i, t in enumerate(tasks):
        mon.handle({"kind": "start", "task": i, "pid": pid})
        t0 = time.perf_counter()
        r = _attempt_serial(fn, t, i, tries) if resilient else fn(*t)
        if isinstance(r, TaskError):
            mon.handle({
                "kind": "task_error", "task": i, "pid": pid,
                "error": r.error, "attempts": r.attempts,
                "duration_s": round(time.perf_counter() - t0, 4),
            })
        else:
            mon.handle({
                "kind": "finish", "task": i, "pid": pid, "ok": True,
                "duration_s": round(time.perf_counter() - t0, 4),
                "peak_rss_mb": peak_rss_mb(),
            })
        results.append(r)
    return results


@dataclass(frozen=True)
class TaskError:
    """Structured failure marker for one grid point (resilient mode).

    Occupies the failed task's slot in the `parallel_map` result list so a
    sweep returns every point it *could* compute instead of hanging CI on
    one pathological simulation or aborting the whole grid on one raised
    exception. Picklable; aggregators skip it (`isinstance` check).

      error     exception class name, or ``"timeout"``
      message   ``str(exc)``, or a description of the timeout
      attempts  how many times the task was tried before giving up
    """

    task_index: int
    error: str
    message: str
    attempts: int


def _attempt_serial(fn: Callable, task: Tuple, idx: int, tries: int):
    """Run one task in-process with retry + error capture (no timeout:
    without a worker process there is nothing safe to interrupt)."""
    last: Optional[BaseException] = None
    for _ in range(max(1, tries)):
        try:
            return fn(*task)
        except Exception as exc:  # captured, not raised: resilient mode
            last = exc
    return TaskError(idx, type(last).__name__, str(last), max(1, tries))


def resolve_chunk(
    chunk: Union[int, str, None], n_tasks: int, n_workers: int
) -> int:
    """Normalize a `chunk=` argument to tasks-per-dispatch.

    None/"auto" -> ~4 dispatches per worker (amortizes process startup and
    per-task pickling on small sweeps while keeping the pool load-balanced);
    any int >= 1 is taken literally (1 = the historical task-per-dispatch).
    """
    if chunk is None or chunk == "auto":
        return max(1, n_tasks // (n_workers * 4))
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return chunk


def parallel_map(
    fn: Callable,
    tasks: Sequence[Tuple],
    workers: Union[int, str, None] = 0,
    chunk: Union[int, str, None] = None,
    task_timeout_s: Optional[float] = None,
    task_retries: int = 2,
    monitor: Optional[Callable[[dict], None]] = None,
    heartbeat_s: Optional[float] = None,
) -> List:
    """``[fn(*t) for t in tasks]`` across `workers` processes, order kept.

    Serial when `workers` resolves to <= 1 (bit-identical aggregation order
    either way: results always come back in task order). `chunk` batches
    multiple tasks per worker dispatch (default: auto-sized, ~4 dispatches
    per worker) — a pure dispatch-granularity knob, every task still runs
    `fn(*t)` with its own arguments in submission order.

    **Resilient mode** (``task_timeout_s`` set): each task is dispatched
    individually (chunking is bypassed) and given `task_timeout_s` seconds
    of wall clock per attempt and `task_retries` total attempts; a task
    that times out or raises on every attempt yields a `TaskError` in its
    result slot instead of hanging/aborting the sweep. A worker stuck past
    the final timeout is abandoned (its process is terminated at pool
    teardown). Serially (``workers<=1``) the timeout cannot be enforced —
    exceptions are still captured and retried.

    **Monitoring** (``monitor=`` and/or ``heartbeat_s=``): `monitor` is
    called in the parent with one small dict per lifecycle event —
    ``{"kind": "start"|"heartbeat"|"finish"|"attempt_failed"|"retry"|
    "task_error", "task": i, "pid": ..., ...}`` — and ``heartbeat_s``
    adds a periodic liveness event per running task. Events ride a
    multiprocessing Manager queue drained by a parent thread (the serial
    path emits start/finish synchronously). Observation only: results
    are identical with monitoring on or off. In resilient mode the
    timeout becomes heartbeat-aware — a task whose worker has produced
    any event within the last `task_timeout_s` is kept waiting instead
    of killed, so only silent (wedged or never-started) workers trip
    the retry/`TaskError` path; set ``heartbeat_s`` well below
    ``task_timeout_s`` for that protection to engage on long points.
    """
    if task_retries < 1:
        raise ValueError(f"task_retries must be >= 1, got {task_retries}")
    n = resolve_workers(workers)
    resilient = task_timeout_s is not None
    monitored = monitor is not None or heartbeat_s is not None
    if n <= 1 or len(tasks) <= 1:
        if monitored:
            return _serial_map(fn, tasks, monitor, resilient, task_retries)
        if resilient:
            return [_attempt_serial(fn, t, i, task_retries)
                    for i, t in enumerate(tasks)]
        return [fn(*t) for t in tasks]
    if monitored:
        return _monitored_map(fn, tasks, n, chunk, task_timeout_s,
                              task_retries, monitor, heartbeat_s)
    if resilient:
        return _resilient_map(fn, tasks, n, task_timeout_s, task_retries)
    size = resolve_chunk(chunk, len(tasks), n)
    groups = [tasks[i:i + size] for i in range(0, len(tasks), size)]
    try:
        with ProcessPoolExecutor(max_workers=min(n, len(groups))) as pool:
            futures = [pool.submit(_run_chunk, fn, g) for g in groups]
            return [r for f in futures for r in f.result()]
    except (OSError, PermissionError, BrokenProcessPool) as exc:
        # no subprocess support here (sandbox), or the workers were killed
        # (seccomp/cgroup/OOM): tasks are pure simulations, rerun serially
        logger.warning(
            "process pool unavailable (%s); running serially", exc
        )
        return [fn(*t) for t in tasks]


def _monitored_map(
    fn: Callable,
    tasks: Sequence[Tuple],
    n_workers: int,
    chunk: Union[int, str, None],
    timeout_s: Optional[float],
    tries: int,
    monitor: Optional[Callable[[dict], None]],
    heartbeat_s: Optional[float],
) -> List:
    """Pooled execution with worker lifecycle events over a Manager queue.

    Mirrors the unmonitored paths exactly (same chunking, same resilient
    semantics) with a `_MonitoredTask` wrapper around `fn`; any failure of
    the eventing machinery itself degrades to the serial monitored path,
    never to lost results.
    """
    mon = _Monitor(monitor)
    try:
        manager = multiprocessing.Manager()
    except Exception as exc:  # no subprocess/semaphore support here
        logger.warning("event queue unavailable (%s); running serially", exc)
        return _serial_map(fn, tasks, monitor, timeout_s is not None, tries)
    try:
        q = manager.Queue()
        drainer = threading.Thread(
            target=_drain_events, args=(q, mon), daemon=True
        )
        drainer.start()
        mt = _MonitoredTask(fn, q, heartbeat_s)
        try:
            if timeout_s is not None:
                return _resilient_map(fn, tasks, n_workers, timeout_s,
                                      tries, mt=mt, mon=mon)
            size = resolve_chunk(chunk, len(tasks), n_workers)
            groups = [tasks[i:i + size]
                      for i in range(0, len(tasks), size)]
            bases = list(range(0, len(tasks), size))
            with ProcessPoolExecutor(
                max_workers=min(n_workers, len(groups))
            ) as pool:
                futures = [
                    pool.submit(_run_chunk_monitored, mt, g, b)
                    for g, b in zip(groups, bases)
                ]
                return [r for f in futures for r in f.result()]
        except (OSError, PermissionError, BrokenProcessPool) as exc:
            logger.warning(
                "process pool unavailable (%s); running serially", exc
            )
            return _serial_map(fn, tasks, monitor,
                               timeout_s is not None, tries)
        finally:
            try:
                q.put(None)  # sentinel: stop the drainer
            except Exception:
                pass
            drainer.join(timeout=2.0)
    finally:
        manager.shutdown()


def _resilient_map(
    fn: Callable,
    tasks: Sequence[Tuple],
    n_workers: int,
    timeout_s: float,
    tries: int,
    mt: Optional["_MonitoredTask"] = None,
    mon: Optional["_Monitor"] = None,
) -> List:
    """Per-task dispatch with timeout + retry + structured error capture.

    Futures are drained in task order; `timeout_s` bounds the wait on each
    (tasks running concurrently behind the head of line get their run time
    counted while earlier results are awaited, so the cap is per-attempt
    wall clock, not cumulative). On a final timeout the worker is left
    running and its process group is terminated at teardown so neither the
    sweep nor interpreter exit blocks on it.

    With a monitor attached (``mt``/``mon`` from `_monitored_map`), the
    timeout is heartbeat-aware: a head-of-line task whose worker produced
    any event within the last `timeout_s` keeps its attempt alive — only
    silent workers (wedged, or queued and not yet started) are cancelled
    and retried, and parent-side ``retry``/``task_error`` events are
    emitted on those transitions.
    """
    results: List = [None] * len(tasks)
    pool = ProcessPoolExecutor(max_workers=min(n_workers, len(tasks)))
    abandoned = False

    def submit(i: int):
        if mt is not None:
            return pool.submit(mt, i, tasks[i])
        return pool.submit(fn, *tasks[i])

    def emit(kind: str, i: int, **fields) -> None:
        if mon is not None:
            mon.handle({"kind": kind, "task": i, **fields})

    try:
        futures = {i: submit(i) for i in range(len(tasks))}
        attempts = dict.fromkeys(futures, 1)
        for i in range(len(tasks)):
            while True:
                try:
                    results[i] = futures[i].result(timeout=timeout_s)
                    break
                except FuturesTimeoutError:
                    if mon is not None and mon.seen_within(i, timeout_s):
                        # the worker is demonstrably alive (started or
                        # heartbeat within the window): a long point is
                        # not a wedged one — keep waiting
                        continue
                    futures[i].cancel()
                    if attempts[i] < tries:
                        attempts[i] += 1
                        futures[i] = submit(i)
                        emit("retry", i, reason="timeout",
                             attempts=attempts[i])
                        continue
                    abandoned = True
                    results[i] = TaskError(
                        i, "timeout",
                        f"task exceeded {timeout_s}s per attempt "
                        f"({attempts[i]} attempts)",
                        attempts[i],
                    )
                    emit("task_error", i, error="timeout",
                         attempts=attempts[i])
                    break
                except BrokenProcessPool:
                    raise
                except Exception as exc:
                    if attempts[i] < tries:
                        attempts[i] += 1
                        futures[i] = submit(i)
                        emit("retry", i, reason=type(exc).__name__,
                             attempts=attempts[i])
                        continue
                    results[i] = TaskError(
                        i, type(exc).__name__, str(exc), attempts[i]
                    )
                    emit("task_error", i, error=type(exc).__name__,
                         attempts=attempts[i])
                    break
        return results
    except (OSError, PermissionError, BrokenProcessPool) as exc:
        logger.warning(
            "process pool unavailable (%s); running serially", exc
        )
        abandoned = True  # don't wait on whatever state the pool is in
        return [_attempt_serial(fn, t, i, tries)
                for i, t in enumerate(tasks)]
    finally:
        if abandoned:
            # a worker may be wedged mid-task: kill outstanding processes
            # so shutdown (and interpreter exit) cannot hang on them
            for proc in list(getattr(pool, "_processes", {}).values()):
                try:
                    proc.terminate()
                except Exception:
                    pass
            pool.shutdown(wait=False, cancel_futures=True)
        else:
            pool.shutdown(wait=True)
