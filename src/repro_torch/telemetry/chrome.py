"""Chrome trace-event exporter for the columnar telemetry dict (the port's
copy of `repro/telemetry/chrome.py`).

`chrome_trace` is a pure function over the dict produced by
`EventRecorder.to_telemetry()` (so it runs post-hoc in the parent process —
telemetry crosses `parallel_map` workers as plain data, never as live
recorder objects). The output follows the Trace Event Format and loads in
Perfetto (https://ui.perfetto.dev) or `chrome://tracing`:

  * one *process* track per cell, per compute node, and one for the
    controller — job spans land on the process that served them;
  * per completed job an async span group (``cat="job"``, ``id=uid``) with
    nested radio / transport / queue / service phases; the closing event
    carries the full six-stage breakdown in ``args``;
  * counter tracks (``ph="C"``) for every sampled probe series (uplink
    backlog, PRB occupancy, queue depth, batch occupancy, KV bytes, ...);
  * instant events for drops / preemptions / re-homings and controller
    epochs (epoch args hold the Observation/Actions record).

Timestamps are microseconds (simulation time x 1e6). The emitted structure
is JSON-safe: no NaN/Inf ever appears (``json.dumps(..., allow_nan=False)``
is asserted in tests).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

__all__ = ["chrome_trace", "write_chrome_trace"]

_US = 1e6  # seconds -> trace-event microseconds


def _num(x) -> Optional[float]:
    """None for missing/NaN/Inf, else a plain float (JSON-safe)."""
    if x is None:
        return None
    x = float(x)
    if math.isnan(x) or math.isinf(x):
        return None
    return x


class _Pids:
    """Deterministic owner-name -> pid allocation (first-seen order)."""

    def __init__(self):
        self._by_name: Dict[str, int] = {}

    def __call__(self, name: str) -> int:
        pid = self._by_name.get(name)
        if pid is None:
            pid = self._by_name[name] = len(self._by_name) + 1
        return pid

    def metadata(self) -> List[dict]:
        return [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name}}
            for name, pid in self._by_name.items()
        ]


def chrome_trace(tel: dict) -> dict:
    """Render a telemetry dict as a Chrome trace-event JSON object."""
    if tel.get("schema") != 1:
        raise ValueError(f"unsupported telemetry schema: {tel.get('schema')!r}")
    pid = _Pids()
    ev: List[dict] = []

    jobs = tel.get("jobs", {})
    stages = tel.get("stages", {})
    n = len(jobs.get("uid", []))
    col = jobs.get

    def owner(i: int) -> str:
        route = col("route", [""] * n)[i]
        return route if route else f"cell{col('cell', [0] * n)[i]}"

    for i in range(n):
        uid = jobs["uid"][i]
        t_gen = _num(col("t_gen", [None] * n)[i])
        t_up = _num(col("t_uplink", [None] * n)[i])
        t_arr = _num(col("t_arrival", [None] * n)[i])
        t_start = _num(col("t_start", [None] * n)[i])
        t_done = _num(col("t_complete", [None] * n)[i])
        t_drop = _num(col("t_drop", [None] * n)[i])
        p = pid(owner(i))
        sid = str(uid)

        def span(name: str, t0: Optional[float], t1: Optional[float],
                 args: Optional[dict] = None) -> None:
            if t0 is None or t1 is None:
                return
            base = {"cat": "job", "id": sid, "pid": p, "tid": 0}
            b = {"name": name, "ph": "b", "ts": t0 * _US, **base}
            if args:
                b["args"] = args
            ev.append(b)
            ev.append({"name": name, "ph": "e", "ts": t1 * _US, **base})

        if t_done is not None:
            breakdown = {
                k: _num(stages[k][i]) for k in stages if stages[k][i] is not None
            }
            span("job", t_gen, t_done, {
                "uid": uid,
                "cell": col("cell", [0] * n)[i],
                "ue": col("ue", [-1] * n)[i],
                "route": col("route", [""] * n)[i],
                "stages_s": breakdown,
            })
            span("radio", t_gen, t_up)
            span("transport", t_up, t_arr)
            span("queue", t_arr, t_start)
            span("service", t_start, t_done, {
                "prefill_s": _num(stages.get("prefill", [None] * n)[i]),
                "decode_s": _num(stages.get("decode", [None] * n)[i]),
                "stall_s": _num(stages.get("stall", [None] * n)[i]),
                "n_prefill_chunks": col("n_prefill_chunks", [0] * n)[i],
                "n_decode": col("n_decode", [0] * n)[i],
            })
        if t_drop is not None:
            ev.append({
                "name": f"drop:{col('drop_stage', [None] * n)[i]}",
                "cat": "job", "ph": "i", "s": "p",
                "ts": t_drop * _US, "pid": p, "tid": 0,
                "args": {"uid": uid},
            })

    # probe series -> counter tracks; the pid is the track's owner (the
    # part before the first dot: "cell0.uplink" -> cell0, "mec.batch" -> mec)
    for track, series in tel.get("series", {}).items():
        ts = series.get("t", [])
        p = pid(track.split(".", 1)[0])
        metrics = [k for k in series if k != "t"]
        for j, t in enumerate(ts):
            t = _num(t)
            if t is None:
                continue
            args = {}
            for k in metrics:
                v = _num(series[k][j]) if j < len(series[k]) else None
                if v is not None:
                    args[k] = v
            if args:
                ev.append({"name": track, "ph": "C", "ts": t * _US,
                           "pid": p, "tid": 0, "args": args})

    # mobility re-homings: one paired instant on the source and the target
    # cell tracks, so a rebalanced burst reads as "left here / landed there"
    # when both process groups are open side by side
    rh = tel.get("rehomes", {})
    for j, t in enumerate(rh.get("t", [])):
        t = _num(t)
        if t is None:
            continue
        frm, to = rh["from_cell"][j], rh["to_cell"][j]
        args = {"uid": rh["uid"][j], "from_cell": frm, "to_cell": to}
        for name, cell in (("rehome_out", frm), ("rehome_in", to)):
            ev.append({
                "name": name, "cat": "mobility", "ph": "i", "s": "p",
                "ts": t * _US, "pid": pid(f"cell{cell}"), "tid": 0,
                "args": args,
            })

    # injected faults (repro_torch.faults): fail/recover instants on the track of
    # the node that went down, so the survivability story reads in place —
    # the queue-depth counter collapses right at the node_fail marker
    flt = tel.get("faults", {})
    for j, t in enumerate(flt.get("t", [])):
        t = _num(t)
        if t is None:
            continue
        node = flt["node"][j] or "fleet"
        args = {"node": node}
        n_aff = flt.get("n_affected", [None] * len(flt["t"]))[j]
        if n_aff is not None:
            args["n_affected"] = n_aff
        ev.append({
            "name": flt["kind"][j], "cat": "fault", "ph": "i", "s": "p",
            "ts": t * _US, "pid": pid(node), "tid": 0, "args": args,
        })

    for rec in tel.get("epochs", []):
        t = _num(rec.get("t"))
        if t is None:
            continue
        ev.append({
            "name": "epoch", "cat": "control", "ph": "i", "s": "p",
            "ts": t * _US, "pid": pid("controller"), "tid": 0,
            "args": {k: v for k, v in rec.items()
                     if k != "t" and _json_safe(v)},
        })

    ev.sort(key=lambda e: (e.get("ts", 0.0), e.get("ph") != "b"))
    return {
        "traceEvents": pid.metadata() + ev,
        "displayTimeUnit": "ms",
        "otherData": dict(tel.get("meta", {})),
    }


def _json_safe(v) -> bool:
    if isinstance(v, float):
        return not (math.isnan(v) or math.isinf(v))
    if isinstance(v, dict):
        return all(_json_safe(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_json_safe(x) for x in v)
    return isinstance(v, (int, str, bool, type(None)))


def write_chrome_trace(tel: dict, path: str) -> None:
    """Export `tel` as a Chrome/Perfetto trace JSON file."""
    with open(path, "w") as fh:
        json.dump(chrome_trace(tel), fh, allow_nan=False)
