"""Derived metrics over the columnar telemetry dict (schema 1; the port's
copy of `repro/telemetry/metrics.py`, bit for bit).

Everything here is a *read-only* consumer of the plain dict that
`EventRecorder.to_telemetry()` exports (and that rides on
``SimResult.telemetry`` / ``NetResult.total.telemetry``): pure functions from
telemetry to aggregates, deterministic for a fixed input — same traced
run, same rollup, bit for bit. Nothing in this module touches the
simulators' RNG or state, so the metrics layer costs exactly nothing
when tracing is off.

Three families:

  * **rollups** — per-stage latency percentiles sliced by cell / route
    (`stage_percentiles`), goodput / loss timelines binned from lifecycle
    events (`goodput_timeline`), probe-series occupancy distributions and
    bucketed utilization timelines (`occupancy_distribution`,
    `utilization_timeline`), all assembled by `summarize()`;
  * **consistency checks** — `littles_law_check` computes L = lambda * W
    for every queueing track twice, from *independent* measurements: the
    event side (arrival rate x mean wait from per-job timestamps) and the
    probe side (time-weighted mean of the sampled queue depth). The two
    agree up to sampling noise iff the event timestamps and the probe
    series describe the same system — a permanent cross-instrument
    self-check on the recorder itself;
  * **analytic conformance** — `mm1_conformance()` drives the *real*
    slot-stepped simulator into a regime where the paper's §III tandem
    model is exact (single cell, near-constant air interface, Exp(mu2)
    compute service, FIFO, no drops) and compares the measured sojourn
    distributions and Def.-1 satisfaction against
    `core.queueing.ICCSystem`'s closed forms with KS-style tolerance
    bands. This is the paper's Fig. 4 simulation-vs-theory claim kept as
    an executable self-check: if engine drift ever skews the queueing
    behaviour, the conformance test fails CI.

Little's-law interpretation per node kind: the classic `ComputeNode`
reports ``len()`` (and therefore the ``*.queue`` ``depth`` probe) as jobs
*waiting*, so its L matches lambda x W_wait (arrival -> dispatch); the
batched node's ``len()`` counts waiting + resident jobs, so its L matches
lambda x W_resident (arrival -> exit). The check detects the batched case
by the presence of the node's ``*.batch`` probe track.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.queueing import ICCSystem, ks_distance, sojourn_cdf
from .recorder import STAGE_FIELDS

__all__ = [
    "PERCENTILES",
    "stage_percentiles",
    "goodput_timeline",
    "utilization_timeline",
    "occupancy_distribution",
    "time_weighted_mean",
    "littles_law_check",
    "drop_reason_counts",
    "summarize",
    "ExpService",
    "mm1_conformance",
]

# the percentile grid every latency rollup reports
PERCENTILES = (50, 90, 95, 99)

_LATENCY_FIELDS = STAGE_FIELDS + ("e2e",)


def _check(tel: dict) -> dict:
    if not isinstance(tel, dict) or tel.get("schema") != 1:
        raise ValueError(
            "expected a telemetry dict with schema == 1 "
            "(EventRecorder.to_telemetry output)"
        )
    return tel


def _pct_stats(xs: Sequence[float]) -> dict:
    """``{"n", "mean", "p50", ...}`` for one latency sample set."""
    out: Dict[str, float] = {"n": len(xs)}
    if xs:
        arr = np.asarray(xs, dtype=float)
        out["mean"] = float(arr.mean())
        for q in PERCENTILES:
            out[f"p{q}"] = float(np.percentile(arr, q))
    else:
        out["mean"] = None
        for q in PERCENTILES:
            out[f"p{q}"] = None
    return out


# ------------------------------------------------------------------ rollups
def stage_percentiles(tel: dict, by: Optional[str] = None) -> dict:
    """Per-stage latency percentiles over completed jobs.

    ``by`` slices the population: None (one ``"all"`` group), ``"cell"``,
    ``"route"``, or ``"ue"`` (group keys are the stringified column
    values, sorted). Each group maps stage name (the six `STAGE_FIELDS`
    plus ``"e2e"``) to ``{"n", "mean", "p50", "p90", "p95", "p99"}``.
    """
    _check(tel)
    jobs, stages = tel["jobs"], tel["stages"]
    if by is None:
        key: Callable[[int], str] = lambda i: "all"
    elif by in ("cell", "route", "ue"):
        col = jobs[by]
        key = lambda i: str(col[i])
    else:
        raise ValueError(f"unknown slice {by!r}; use None, 'cell', 'route', 'ue'")
    groups: Dict[str, Dict[str, List[float]]] = {}
    radio = stages["radio"]
    for i in range(len(jobs["uid"])):
        if radio[i] is None:  # never completed: no stage breakdown
            continue
        g = groups.get(key(i))
        if g is None:
            g = groups[key(i)] = {s: [] for s in _LATENCY_FIELDS}
        for s in STAGE_FIELDS:
            g[s].append(stages[s][i])
        g["e2e"].append(jobs["t_complete"][i] - jobs["t_gen"][i])
    return {
        k: {s: _pct_stats(grp[s]) for s in _LATENCY_FIELDS}
        for k, grp in sorted(groups.items())
    }


def _horizon(tel: dict) -> float:
    """Latest meaningful timestamp: the configured horizon when the meta
    carries it, else the max lifecycle timestamp seen."""
    t = tel["meta"].get("sim_time")
    if t is not None:
        return float(t)
    jobs = tel["jobs"]
    t = 0.0
    for col in ("t_gen", "t_complete", "t_drop"):
        t = max(t, max((x for x in jobs[col] if x is not None), default=0.0))
    return t


def goodput_timeline(tel: dict, bucket_s: float = 1.0) -> dict:
    """Generated / completed / dropped job counts per time bucket, plus
    the goodput rate (completions per second). Binned from the per-job
    lifecycle timestamps, so it needs no probe series."""
    _check(tel)
    if bucket_s <= 0.0:
        raise ValueError("bucket_s must be > 0")
    horizon = _horizon(tel)
    nb = max(1, int(math.ceil(horizon / bucket_s - 1e-9)))
    jobs = tel["jobs"]

    def bincount(col: str) -> List[int]:
        out = [0] * nb
        for t in jobs[col]:
            if t is not None:
                out[min(int(t / bucket_s), nb - 1)] += 1
        return out

    completed = bincount("t_complete")
    return {
        "bucket_s": float(bucket_s),
        "t": [i * bucket_s for i in range(nb)],
        "generated": bincount("t_gen"),
        "completed": completed,
        "dropped": bincount("t_drop"),
        "goodput_jobs_per_s": [c / bucket_s for c in completed],
    }


def time_weighted_mean(
    ts: Sequence[float],
    vs: Sequence[float],
    t_lo: Optional[float] = None,
    t_hi: Optional[float] = None,
) -> Optional[float]:
    """Step-hold (zero-order) time average of a probe series over
    ``[t_lo, t_hi]``: each sample holds until the next one; the last
    holds to ``t_hi``. None when the window has no coverage."""
    n = len(ts)
    if n == 0:
        return None
    lo = ts[0] if (t_lo is None or t_lo < ts[0]) else t_lo
    hi = ts[-1] if t_hi is None else t_hi
    if hi <= lo:
        return None
    total = 0.0
    for k in range(n):
        seg_lo = ts[k] if ts[k] > lo else lo
        seg_hi = ts[k + 1] if k + 1 < n else hi
        if seg_hi > hi:
            seg_hi = hi
        if seg_hi > seg_lo:
            total += vs[k] * (seg_hi - seg_lo)
    return total / (hi - lo)


def utilization_timeline(
    tel: dict, bucket_s: float = 1.0, tracks: Optional[Sequence[str]] = None
) -> dict:
    """Bucketed step-hold time averages of every probe metric.

    Returns ``{track: {"t": [bucket starts], metric: [bucket means]}}``;
    a bucket the series does not cover reports None. This is the
    utilization view: e.g. the time-mean batch occupancy or queue depth
    per second of simulated time.
    """
    _check(tel)
    if bucket_s <= 0.0:
        raise ValueError("bucket_s must be > 0")
    horizon = _horizon(tel)
    nb = max(1, int(math.ceil(horizon / bucket_s - 1e-9)))
    edges = [i * bucket_s for i in range(nb + 1)]
    names = sorted(tel["series"]) if tracks is None else list(tracks)
    out: Dict[str, dict] = {}
    for track in names:
        s = tel["series"][track]
        ts = s["t"]
        row: Dict[str, list] = {"t": edges[:-1]}
        for metric in sorted(s):
            if metric == "t":
                continue
            row[metric] = [
                time_weighted_mean(ts, s[metric], edges[b], edges[b + 1])
                for b in range(nb)
            ]
        out[track] = row
    return out


def occupancy_distribution(tel: dict) -> dict:
    """Distribution summary of every probe metric: time-weighted mean,
    max, and sample percentiles (the probe cadence is uniform up to
    throttling, so sample percentiles track time percentiles).

    Covers the queue-length distributions (``*.queue`` ``depth``) and
    KV-cache occupancy (``*.batch`` ``kv_bytes``) the capacity report
    quotes, plus every other sampled track.
    """
    _check(tel)
    out: Dict[str, dict] = {}
    for track in sorted(tel["series"]):
        s = tel["series"][track]
        ts = s["t"]
        row: Dict[str, dict] = {}
        for metric in sorted(s):
            if metric == "t":
                continue
            vs = s[metric]
            st = _pct_stats(vs)
            st["mean_tw"] = time_weighted_mean(ts, vs)
            st["max"] = float(max(vs)) if vs else None
            row[metric] = st
        out[track] = row
    return out


# --------------------------------------------------------------- Little's law
def littles_law_check(
    tel: dict, t_lo: float = 0.0, t_hi: Optional[float] = None
) -> List[dict]:
    """L = lambda * W per queueing track, events vs. probes independently.

    For every ``<node>.queue`` track: lambda is the arrival rate of jobs
    routed to that node inside the window, W is their mean wait
    (classic node: arrival -> dispatch; batched node, detected by its
    ``<node>.batch`` track: arrival -> exit, since its depth probe counts
    resident jobs), and L_events = lambda * W. L_probes is the
    time-weighted mean of the sampled ``depth`` over the same window —
    measured by a different instrument entirely. For every
    ``cell<i>.uplink`` track the same is done for the air interface
    (generation -> uplink done vs. the ``in_flight`` probe; re-homed jobs
    are excluded since their air time spans two cells).

    Returns one dict per track with both sides and their relative error;
    entries with too little data carry None and ``rel_err`` None.
    """
    _check(tel)
    jobs = tel["jobs"]
    n = len(jobs["uid"])
    if t_hi is None:
        t_hi = _horizon(tel)
    span = t_hi - t_lo
    if span <= 0.0:
        raise ValueError("empty window")
    out: List[dict] = []

    def entry(track, kind, interp, n_arr, w, l_probe):
        lam = n_arr / span
        l_events = lam * w if w is not None else None
        if l_events is None or l_probe is None:
            rel = None
        else:
            rel = abs(l_events - l_probe) / max(l_events, l_probe, 1e-9)
        return {
            "track": track,
            "kind": kind,
            "interpretation": interp,
            "n": n_arr,
            "lam_jobs_per_s": lam,
            "w_s": w,
            "l_events": l_events,
            "l_probes": l_probe,
            "rel_err": rel,
        }

    for track in sorted(tel["series"]):
        s = tel["series"][track]
        if track.endswith(".queue"):
            name = track[: -len(".queue")]
            resident = f"{name}.batch" in tel["series"]
            waits: List[float] = []
            n_arr = 0
            for i in range(n):
                ta = jobs["t_arrival"][i]
                if jobs["route"][i] != name or ta is None:
                    continue
                if not (t_lo <= ta <= t_hi):
                    continue
                n_arr += 1
                if resident:
                    end = jobs["t_complete"][i]
                    if end is None:
                        end = jobs["t_drop"][i]
                else:
                    end = jobs["t_start"][i]
                    if end is None:
                        end = jobs["t_drop"][i]
                if end is not None:
                    waits.append(end - ta)
            w = float(np.mean(waits)) if waits else None
            lp = time_weighted_mean(s["t"], s["depth"], t_lo, t_hi)
            out.append(entry(
                track, "node", "resident" if resident else "wait",
                n_arr, w, lp,
            ))
        elif track.endswith(".uplink") and track.startswith("cell"):
            cell = int(track[len("cell"): -len(".uplink")])
            airs: List[float] = []
            n_arr = 0
            for i in range(n):
                tg = jobs["t_gen"][i]
                if (
                    jobs["cell"][i] != cell
                    or jobs["n_rehomed"][i]
                    or tg is None
                    or not (t_lo <= tg <= t_hi)
                    or jobs["drop_reason"][i] == "quota"  # never entered the air
                ):
                    continue
                n_arr += 1
                tu = jobs["t_uplink"][i]
                if tu is not None:
                    airs.append(tu - tg)
            w = float(np.mean(airs)) if airs else None
            lp = time_weighted_mean(s["t"], s["in_flight"], t_lo, t_hi)
            out.append(entry(track, "uplink", "resident", n_arr, w, lp))
    return out


def drop_reason_counts(tel: dict) -> Dict[str, int]:
    """Per-reason loss counts from the jobs column (sorted keys)."""
    _check(tel)
    counts: Dict[str, int] = {}
    for r in tel["jobs"]["drop_reason"]:
        if r is not None:
            counts[r] = counts.get(r, 0) + 1
    return dict(sorted(counts.items()))


# ------------------------------------------------------------------ summarize
def summarize(
    tel: dict,
    bucket_s: float = 1.0,
    t_lo: float = 0.0,
    t_hi: Optional[float] = None,
) -> dict:
    """One deterministic rollup of a telemetry dict: counts, stage
    percentiles (overall / by cell / by route), goodput timeline, probe
    occupancy distributions, Little's-law cross-checks, and loss
    attribution. JSON-safe; identical input produces identical output
    (sorted group keys, no timestamps, no RNG)."""
    _check(tel)
    return {
        "schema": 1,
        "meta": dict(tel["meta"]),
        "counts": dict(tel["counts"]),
        "stages": {
            "overall": stage_percentiles(tel).get("all", {}),
            "by_cell": stage_percentiles(tel, "cell"),
            "by_route": stage_percentiles(tel, "route"),
        },
        "goodput": goodput_timeline(tel, bucket_s),
        "occupancy": occupancy_distribution(tel),
        "littles_law": littles_law_check(tel, t_lo=t_lo, t_hi=t_hi),
        "drop_reasons": drop_reason_counts(tel),
    }


# --------------------------------------------------------------- conformance
class ExpService:
    """I.i.d. Exp(mu) inference times drawn at dispatch — the stochastic
    service model that makes the compute node an exact M/M/1 server.

    Owns its RNG (salted from ``seed``), so the simulator's arrival /
    channel stream is untouched; the node must keep the default
    ``deterministic_service=False`` so the draw happens at dispatch, in
    FIFO order. Picklable (process-pool safe)."""

    def __init__(self, mu: float, seed: int = 0):
        if mu <= 0.0:
            raise ValueError("mu must be > 0")
        self.mu = float(mu)
        self.seed = int(seed)
        self._rng = np.random.default_rng(
            np.random.SeedSequence([0x4D4D31, self.seed])  # "MM1"
        )

    def __call__(self, job) -> float:
        return float(self._rng.exponential(1.0 / self.mu))


def mm1_conformance(
    mu2: float = 100.0,
    lam: float = 70.0,
    b_total: float = 0.080,
    t_wireline: float = 0.005,
    sim_time: float = 50.0,
    warmup: float = 2.0,
    seed: int = 7,
    tol_ks: float = 0.09,
    tol_sat: float = 0.04,
    tol_little: float = 0.25,
) -> dict:
    """Run the real slot engine in an M/M/1-exact regime and compare it
    against `core.queueing`'s closed forms (the paper's Fig. 4 claim as a
    permanent self-check).

    Regime: one cell, ``lam`` UEs at 1 job/s (Poisson(lam) aggregate),
    1-token payload and zero background traffic (the air interface
    collapses to the near-constant SR/grant cycle), constant wireline,
    FIFO compute with Exp(mu2) service and no drops. Then exactly:

      * compute sojourn  T_comp ~ Exp(mu2 - lam)  (M/M/1 with Poisson
        arrivals preserved through the near-deterministic air stage),
      * e2e ~ radio + t_wireline + T_comp with radio ~ const, so the
        measured e2e CDF matches the shifted compute CDF,
      * Def.-1 satisfaction = F_comp(b_total - t_wireline - radio_mean).

    Checks (each a dict in ``checks``): the radio stage really is
    near-constant (regime precondition), KS(T_comp) and KS(e2e) within
    ``tol_ks`` of the closed form, measured satisfaction within
    ``tol_sat`` of the analytic value, and the compute queue's
    Little's-law events-vs-probes error within ``tol_little``.
    ``passed`` is the conjunction. Fixed ``seed`` makes the whole dict
    reproducible bit for bit.

    Tolerance bands: sojourn samples from one queue are autocorrelated
    across busy periods, so the effective sample size is far below the
    job count and the KS fluctuation is several times the i.i.d.
    1.36/sqrt(n) figure. The defaults (calibrated over seeds) hold for
    arbitrary seeds; a CI pin on one fixed seed can assert tighter bands
    because the fixed-seed value is exactly reproducible.
    """
    # local imports: core.simulator imports the recorder from this package
    from ..core.channel import ChannelConfig
    from ..core.simulator import SchemeConfig, SimConfig, simulate
    from .recorder import EventRecorder

    n_ues = max(1, int(round(lam)))
    scheme = SchemeConfig(
        name="mm1_probe", t_wireline=t_wireline, packet_priority=False,
        compute_policy="fifo", management="joint", drop_infeasible=False,
    )
    sim = SimConfig(
        n_ues=n_ues, lam_per_ue=lam / n_ues, n_input=1, n_output=1,
        b_total=b_total, sim_time=sim_time, warmup=warmup, seed=seed,
        channel=ChannelConfig(background_bps=0.0),
    )
    rec = EventRecorder(keep_events=False)
    result = simulate(scheme, sim, service_time=ExpService(mu2, seed),
                      recorder=rec)
    tel = result.telemetry
    jobs = tel["jobs"]

    # the same scoring window as score_jobs, so satisfaction lines up
    t_lo, t_hi = warmup, sim_time - 2 * b_total
    comp: List[float] = []
    e2e: List[float] = []
    radio: List[float] = []
    for i in range(len(jobs["uid"])):
        tg, tc = jobs["t_gen"][i], jobs["t_complete"][i]
        if tc is None or not (t_lo <= tg <= t_hi):
            continue
        radio.append(jobs["t_uplink"][i] - tg)
        comp.append(tc - jobs["t_arrival"][i])
        e2e.append(tc - tg)
    if not comp:
        raise RuntimeError("conformance run produced no completed jobs")
    radio_mean = float(np.mean(radio))
    radio_std = float(np.std(radio))

    # air stage treated as a constant -> only the compute branch of the
    # tandem closed form is exercised (mu1 = inf keeps it stable)
    sys = ICCSystem(mu1=math.inf, mu2=mu2, t_wireline=t_wireline)
    ks_comp = ks_distance(comp, lambda t: sojourn_cdf(sys, lam, "comp", t))
    shift = t_wireline + radio_mean
    ks_e2e = ks_distance(
        e2e, lambda t: sojourn_cdf(sys, lam, "comp", t - shift)
    )
    sat_model = sojourn_cdf(sys, lam, "comp", b_total - shift)
    sat_meas = result.satisfaction

    little = [
        e for e in littles_law_check(tel, t_lo=warmup, t_hi=sim_time)
        if e["kind"] == "node"
    ]
    little_err = little[0]["rel_err"] if little else None

    rate = mu2 - lam
    quantiles = {
        f"p{q}": {
            "measured": float(np.percentile(comp, q)),
            "model": -math.log1p(-q / 100.0) / rate,
        }
        for q in PERCENTILES
    }

    checks = [
        {
            "name": "radio_near_constant", "value": radio_std,
            "tol": 2e-3, "passed": radio_std <= 2e-3,
        },
        {
            "name": "ks_comp", "value": ks_comp,
            "tol": tol_ks, "passed": ks_comp <= tol_ks,
        },
        {
            "name": "ks_e2e", "value": ks_e2e,
            "tol": tol_ks, "passed": ks_e2e <= tol_ks,
        },
        {
            "name": "satisfaction_abs_err",
            "value": abs(sat_meas - sat_model),
            "tol": tol_sat, "passed": abs(sat_meas - sat_model) <= tol_sat,
        },
        {
            "name": "littles_law_rel_err", "value": little_err,
            "tol": tol_little,
            "passed": little_err is not None and little_err <= tol_little,
        },
    ]
    return {
        "passed": all(c["passed"] for c in checks),
        "checks": checks,
        "params": {
            "mu2": mu2, "lam": lam, "b_total": b_total,
            "t_wireline": t_wireline, "sim_time": sim_time,
            "warmup": warmup, "seed": seed,
        },
        "n_jobs": len(comp),
        "radio_mean_s": radio_mean,
        "radio_std_s": radio_std,
        "satisfaction": {"measured": sat_meas, "model": sat_model},
        "comp_quantiles_s": quantiles,
        "littles_law": little,
    }
