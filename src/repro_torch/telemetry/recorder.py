"""Trace recorders: the simulator's observability capture layer.

The simulators (`core.simulate`, `network.simulate_network`) accept a
``recorder``; every instrumentation point in the slot pipeline, the compute
nodes, and the control loop funnels through it:

  * **per-job lifecycle events** — generated, admission-rejected, uplink
    done (+ the routing decision), queue enter, dispatch/batch admission,
    prefill chunks, decode iterations, first token, preemption, drop,
    completion, Xn re-homing — each stamped with simulation time;
  * **time-series probes** — sampled per-cell uplink backlog / PRB
    occupancy, per-node queue depth, batch occupancy and KV-cache bytes
    (tracks are throttled to one sample per ``sample_every_s``);
  * **controller epochs** — the Observation numbers and the Actions taken,
    one record per epoch.

`NullRecorder` is the default and is provably free: drivers normalize it
(and ``None``) to internal ``None`` via `active()`, so the hot paths keep
their pre-telemetry shape — one ``is not None`` check per *job event site*,
nothing per slot — and fixed-seed results stay bit-identical (pinned in
tests/test_telemetry.py). The recorder never touches RNG or simulation
state: a traced run produces the exact same `SimResult` as an untraced one.

`EventRecorder.to_telemetry()` exports one compact columnar dict (plain
lists/floats/strings — picklable and JSON-safe) that attaches to
``SimResult.telemetry`` and flows through `ExperimentResult`; feed it to
`repro.telemetry.chrome_trace` for a Perfetto-loadable Chrome trace.

Stage-latency attribution: at completion each job's end-to-end latency is
decomposed into `STAGE_FIELDS`:

  radio      generation -> last uplink bit at the gNB (includes SR/grant
             wait, PRB contention, and any Xn re-homing stall)
  transport  wireline/backhaul hop gNB -> compute node
  queue      compute arrival -> service start (classic: dispatch; batched:
             batch admission)
  prefill    sum of the iteration time of every prefill chunk the job ran
  decode     sum of the iteration time of every decode step (classic
             whole-job nodes book their entire undifferentiated inference
             pass here, prefill = 0)
  stall      residual time resident in the batch while neither prefilling
             nor decoding (another job held the prefill slot); exactly 0
             for classic nodes

The six stages telescope: their sum equals the job's e2e latency to float
round-off (< 1e-9 s on every tracked horizon; asserted in tests).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

__all__ = [
    "STAGE_FIELDS",
    "TELEMETRY_SCHEMA",
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "EventRecorder",
    "active",
]

# stage names, in pipeline order (glossary in the module docstring / README)
STAGE_FIELDS = ("radio", "transport", "queue", "prefill", "decode", "stall")

# version of the columnar telemetry dict emitted by to_telemetry()
TELEMETRY_SCHEMA = 1


@runtime_checkable
class TraceRecorder(Protocol):
    """What the instrumentation points call. ``enabled`` gates everything:
    drivers normalize a disabled recorder to ``None`` once, up front."""

    enabled: bool

    def job_event(self, kind: str, uid: int, t: float, **fields) -> None: ...

    def sample(self, track: str, t: float, values: Dict[str, float]) -> None: ...

    def epoch(self, t: float, record: dict) -> None: ...

    def fault_event(self, t: float, kind: str, node: str, **fields) -> None: ...


class NullRecorder:
    """The zero-overhead default: disabled, so `active()` strips it before
    any simulation starts and no instrumentation site ever runs."""

    enabled = False

    def job_event(self, kind: str, uid: int, t: float, **fields) -> None:
        pass

    def sample(self, track: str, t: float, values: Dict[str, float]) -> None:
        pass

    def epoch(self, t: float, record: dict) -> None:
        pass

    def fault_event(self, t: float, kind: str, node: str, **fields) -> None:
        pass


NULL_RECORDER = NullRecorder()


def active(recorder) -> Optional["TraceRecorder"]:
    """Normalize a ``recorder=`` argument: ``None`` and any disabled
    recorder (`NullRecorder`) become ``None``, so driver hot paths guard
    with a single ``is not None`` and pay nothing when tracing is off."""
    if recorder is None or not getattr(recorder, "enabled", False):
        return None
    return recorder


class _JobTrace:
    """Per-job accumulator (one per generated job)."""

    __slots__ = (
        "uid", "cell", "ue", "route", "t_gen", "t_uplink", "t_arrival",
        "t_start", "t_complete", "t_drop", "prefill_s", "decode_s",
        "n_prefill_chunks", "n_decode", "drop_stage", "drop_reason",
        "n_rehomed", "n_redispatched",
    )

    def __init__(self, uid: int, t_gen: float, cell: int, ue: int):
        self.uid = uid
        self.cell = cell
        self.ue = ue
        self.route = ""
        self.t_gen = t_gen
        self.t_uplink: Optional[float] = None
        self.t_arrival: Optional[float] = None
        self.t_start: Optional[float] = None
        self.t_complete: Optional[float] = None
        self.t_drop: Optional[float] = None
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.n_prefill_chunks = 0
        self.n_decode = 0
        self.drop_stage: Optional[str] = None
        self.drop_reason: Optional[str] = None
        self.n_rehomed = 0
        self.n_redispatched = 0

    def stages(self) -> Optional[Tuple[float, ...]]:
        """The six-stage breakdown, or None for a job that never completed.

        ``stall`` is the residual of the resident span, so the six terms
        telescope to ``t_complete - t_gen`` exactly (up to float
        associativity — well under 1e-9 s)."""
        if (
            self.t_complete is None
            or self.t_start is None
            or self.t_arrival is None
            or self.t_uplink is None
        ):
            return None
        radio = self.t_uplink - self.t_gen
        transport = self.t_arrival - self.t_uplink
        queue = self.t_start - self.t_arrival
        stall = (self.t_complete - self.t_start) - self.prefill_s - self.decode_s
        return (radio, transport, queue, self.prefill_s, self.decode_s, stall)


class EventRecorder:
    """Capturing recorder: lifecycle events, per-job stage accounting,
    throttled probe series, and controller epoch records.

    ``sample_every_s`` throttles every probe track (a sample closer than
    this to the track's previous one is discarded). ``keep_events`` keeps
    the raw ``(t, kind, uid)`` stream (the determinism tests compare it and
    the Chrome exporter renders instants from it); disable it to trace very
    long runs with per-job/columnar data only.
    """

    enabled = True

    def __init__(self, sample_every_s: float = 0.01, keep_events: bool = True):
        if sample_every_s <= 0.0:
            raise ValueError("sample_every_s must be > 0")
        self.sample_every_s = float(sample_every_s)
        self.keep_events = keep_events
        self.events: List[Tuple[float, str, int]] = []
        self.series: Dict[str, Dict[str, list]] = {}
        self.epochs: List[dict] = []
        self.rehomes: List[Tuple[float, int, int, int]] = []
        self.faults: List[dict] = []
        self._jobs: Dict[int, _JobTrace] = {}

    # ------------------------------------------------------------ lifecycle
    def job_event(self, kind: str, uid: int, t: float, **fields) -> None:
        if self.keep_events:
            self.events.append((t, kind, uid))
        jt = self._jobs.get(uid)
        if jt is None:
            # "generated" opens the record; direct node-driven tests may
            # emit later events for jobs the engine never announced
            jt = self._jobs[uid] = _JobTrace(
                uid,
                t_gen=t if kind == "generated" else float("nan"),
                cell=fields.get("cell", 0),
                ue=fields.get("ue", -1),
            )
            if kind == "generated":
                return
        if kind == "generated":
            return
        if kind == "uplink_done":
            jt.t_uplink = t
            jt.route = fields.get("route", jt.route)
            jt.t_arrival = fields.get("t_arrival", jt.t_arrival)
        elif kind == "queue_enter":
            node = fields.get("node")
            if node and not jt.route:
                jt.route = node
        elif kind == "dispatch":
            # classic whole-job dispatch: the entire inference pass books
            # under `decode` (no prefill/decode split at this fidelity)
            jt.t_start = t
            jt.decode_s += fields.get("svc", 0.0)
        elif kind == "admit":
            jt.t_start = t
        elif kind == "prefill":
            jt.prefill_s += fields.get("dt", 0.0)
            jt.n_prefill_chunks += 1
        elif kind == "decode":
            jt.decode_s += fields.get("dt", 0.0)
            jt.n_decode += 1
        elif kind == "complete":
            jt.t_complete = t
        elif kind == "redispatch":
            # node crash recovery (repro.faults): the job lost its queue
            # slot / in-flight generation and restarts from scratch. The
            # aborted attempt's booked service is erased — the final
            # attempt's prefill/decode book normally, the lost work and
            # the re-dispatch wait land in transport/queue, and the six
            # stages still telescope to e2e exactly.
            jt.n_redispatched += 1
            jt.t_start = None
            jt.t_complete = None
            jt.prefill_s = 0.0
            jt.decode_s = 0.0
            jt.n_prefill_chunks = 0
            jt.n_decode = 0
            jt.route = fields.get("route", jt.route)
            jt.t_arrival = fields.get("t_arrival", jt.t_arrival)
        elif kind in ("drop", "preempt", "rejected"):
            jt.drop_stage = (
                "preempted" if kind == "preempt"
                else "admission" if kind == "rejected"
                else fields.get("stage", "queue")
            )
            # structured loss attribution (Job.drop_reason glossary);
            # events from older producers fall back to a stage-derived code
            jt.drop_reason = fields.get("reason") or (
                "deadline_preempt" if kind == "preempt"
                else "quota" if kind == "rejected"
                else "queue_drop"
            )
            jt.t_drop = t
            # a crash can retract an already-booked completion (the
            # iteration that "finished" the job never ran): dropping is
            # terminal, so the completion must not survive alongside it
            jt.t_complete = None
        elif kind == "rehomed":
            jt.n_rehomed += 1
            frm = jt.cell
            jt.cell = fields.get("cell", jt.cell)
            # (t, uid, from_cell, to_cell): the Chrome exporter renders a
            # paired instant on the source and target cell tracks
            self.rehomes.append((t, uid, frm, jt.cell))
        # unknown kinds: kept in the event stream, no columnar effect

    # --------------------------------------------------------------- probes
    def sample(self, track: str, t: float, values: Dict[str, float]) -> None:
        s = self.series.get(track)
        if s is None:
            s = self.series[track] = {"t": []}
        ts = s["t"]
        if ts and t - ts[-1] < self.sample_every_s:
            return
        ts.append(t)
        for key, v in values.items():
            s.setdefault(key, []).append(v)

    def epoch(self, t: float, record: dict) -> None:
        self.epochs.append(record)

    def fault_event(self, t: float, kind: str, node: str, **fields) -> None:
        """Injected-fault lifecycle (repro.faults): ``node_fail`` /
        ``node_recover`` instants, stamped with the node name and any
        driver-supplied fields (e.g. ``n_affected`` jobs on a crash)."""
        self.faults.append({"t": t, "kind": kind, "node": node, **fields})

    # -------------------------------------------------------------- exports
    def stage_breakdown(self, uid: int) -> Optional[Dict[str, float]]:
        jt = self._jobs.get(uid)
        if jt is None:
            return None
        st = jt.stages()
        return dict(zip(STAGE_FIELDS, st)) if st is not None else None

    def track_names(self) -> List[str]:
        """Probe tracks sampled so far, in first-seen (deterministic)
        order — e.g. ``cell0.uplink``, ``mec.queue``, ``mec.batch``."""
        return list(self.series)

    def drop_reason_counts(self) -> Dict[str, int]:
        """Per-reason loss counts over every traced job (sorted keys, so
        the dict serializes deterministically)."""
        counts: Dict[str, int] = {}
        for jt in self._jobs.values():
            if jt.drop_reason is not None:
                counts[jt.drop_reason] = counts.get(jt.drop_reason, 0) + 1
        return dict(sorted(counts.items()))

    def to_metrics(self, **kwargs) -> dict:
        """Derived-metric rollup of everything captured so far — a
        convenience front-end for `repro_torch.telemetry.metrics.summarize`."""
        from .metrics import summarize

        return summarize(self.to_telemetry(), **kwargs)

    def to_telemetry(self, meta: Optional[dict] = None) -> dict:
        """Compact columnar export: plain lists keyed by column, aligned
        across ``jobs`` and ``stages`` (one row per generated job; stage
        columns are None for jobs that never completed). Attaches to
        `SimResult.telemetry` and round-trips pickle/JSON."""
        jobs = list(self._jobs.values())
        cols: Dict[str, list] = {
            "uid": [j.uid for j in jobs],
            "cell": [j.cell for j in jobs],
            "ue": [j.ue for j in jobs],
            "route": [j.route for j in jobs],
            "t_gen": [_none_if_nan(j.t_gen) for j in jobs],
            "t_uplink": [j.t_uplink for j in jobs],
            "t_arrival": [j.t_arrival for j in jobs],
            "t_start": [j.t_start for j in jobs],
            "t_complete": [j.t_complete for j in jobs],
            "t_drop": [j.t_drop for j in jobs],
            "drop_stage": [j.drop_stage for j in jobs],
            "drop_reason": [j.drop_reason for j in jobs],
            "n_prefill_chunks": [j.n_prefill_chunks for j in jobs],
            "n_decode": [j.n_decode for j in jobs],
            "n_rehomed": [j.n_rehomed for j in jobs],
            "n_redispatched": [j.n_redispatched for j in jobs],
        }
        stage_rows = [j.stages() for j in jobs]
        stages: Dict[str, list] = {
            name: [row[i] if row is not None else None for row in stage_rows]
            for i, name in enumerate(STAGE_FIELDS)
        }
        tel = {
            "schema": TELEMETRY_SCHEMA,
            "meta": dict(meta or {}),
            "jobs": cols,
            "stages": stages,
            "series": {
                track: {k: list(v) for k, v in s.items()}
                for track, s in self.series.items()
            },
            "epochs": list(self.epochs),
            "rehomes": {
                "t": [r[0] for r in self.rehomes],
                "uid": [r[1] for r in self.rehomes],
                "from_cell": [r[2] for r in self.rehomes],
                "to_cell": [r[3] for r in self.rehomes],
            },
            "faults": {
                "t": [f["t"] for f in self.faults],
                "kind": [f["kind"] for f in self.faults],
                "node": [f["node"] for f in self.faults],
                "n_affected": [f.get("n_affected") for f in self.faults],
            },
            "counts": {
                "jobs": len(jobs),
                "events": len(self.events),
                "completed": sum(r is not None for r in stage_rows),
                "dropped": sum(j.drop_stage is not None for j in jobs),
                "drop_reasons": self.drop_reason_counts(),
                "rehomes": len(self.rehomes),
                "redispatches": sum(j.n_redispatched for j in jobs),
                "faults": len(self.faults),
                "epochs": len(self.epochs),
            },
        }
        if self.keep_events:
            tel["events"] = {
                "t": [e[0] for e in self.events],
                "kind": [e[1] for e in self.events],
                "uid": [e[2] for e in self.events],
            }
        return tel


def _none_if_nan(x: float) -> Optional[float]:
    return None if math.isnan(x) else x
