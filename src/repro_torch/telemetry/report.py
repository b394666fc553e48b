"""Deterministic capacity reports from stored experiment results.

The port's copy of `repro/telemetry/report.py` (imports and docstrings
rewritten only): the same bytes out for the same result files.

``python -m repro_torch.experiments report <result.json|BENCH_*.json>`` renders
any `ExperimentResult` — including the tracked baselines — into a
self-contained Markdown or HTML capacity report, entirely offline: the
input file is the only source of data, nothing is re-simulated, and two
invocations over the same file produce byte-identical output (fixed float
formats, sorted iteration, no timestamps).

Sections (each present only when the stored result carries the data):

  * headline claim numbers (tracked ``BENCH_*.json`` wrappers),
  * the capacity table — per-arm Def.-2 capacity, saturation flag, and a
    unicode sparkline of the Def.-1 satisfaction curve,
  * the full satisfaction-vs-rate grid across arms,
  * per-arm per-rate detail (jobs, drop rate, e2e mean/p99, tokens/s)
    when point means are stored,
  * per-arm loss attribution (the structured `Job.drop_reason` counts),
  * per-arm stage-attribution tables when a traced point telemetry dict
    is stored (``run --trace`` / ``points="full"``), via
    `repro_torch.telemetry.metrics.stage_percentiles`,
  * "where time goes" — per-arm summed task-seconds vs elapsed wall,
    merged engine-phase profiles (``run --profile``) with coverage,
    sub-phase and counter readouts,
  * a run-health section mined from a ``run --runlog`` JSONL
    (``report --runlog``): per-point durations, peak worker RSS,
    errors/retries/heartbeats, and a phase rollup,
  * deltas against a reference result (``--ref``): capacity and per-rate
    satisfaction changes over the arms the two results share.

The builder emits a small block IR (headings, paragraphs, tables) and the
two back-ends render it; the HTML back-end inlines its own minimal CSS so
the file is self-contained.
"""

from __future__ import annotations

import html as _html
import json
import os
from typing import List, Optional, Sequence, Tuple

from .metrics import stage_percentiles

__all__ = ["build_blocks", "render_blocks", "render_report", "generate_report"]

_SPARK = "▁▂▃▄▅▆▇█"


def _f(x, nd: int = 3) -> str:
    """Fixed-width float cell; '-' for missing values (determinism: one
    code path for every number the report prints)."""
    if x is None:
        return "-"
    if isinstance(x, float) and x != x:  # NaN
        return "-"
    return f"{x:.{nd}f}"


def _ms(x) -> str:
    return "-" if x is None or (isinstance(x, float) and x != x) \
        else f"{x * 1e3:.2f}"


def _spark(values: Sequence[float]) -> str:
    out = []
    for v in values:
        v = min(max(v, 0.0), 1.0)
        out.append(_SPARK[min(int(v * len(_SPARK)), len(_SPARK) - 1)])
    return "".join(out)


# --------------------------------------------------------------- block IR
# ("h", level, text) | ("p", text) | ("table", headers, rows)
Block = Tuple


def build_blocks(
    result,
    headline: Optional[dict] = None,
    source: Optional[str] = None,
    ref=None,
    ref_source: Optional[str] = None,
    runlog: Optional[List[dict]] = None,
    runlog_source: Optional[str] = None,
) -> List[Block]:
    """Assemble the report IR from an `ExperimentResult` (+ optional
    tracked-baseline headline, reference result for deltas, and parsed
    runlog events for the per-point run-health table)."""
    blocks: List[Block] = []
    blocks.append(("h", 1, f"Capacity report: {result.experiment}"))
    src = f"`{source}`" if source else "an in-memory result"
    blocks.append((
        "p",
        f"Rendered offline from {src} (result schema v"
        f"{result.schema_version}); {len(result.arms)} arms, "
        f"sweep wall-clock {_f(result.wall_clock_s, 1)} s.",
    ))

    # ----------------------------------------------------------- headline
    if headline:
        blocks.append(("h", 2, "Headline"))
        cap = headline.get("capacity_per_policy")
        if isinstance(cap, dict) and cap:
            blocks.append((
                "table",
                ["arm", "capacity (jobs/s)", "saturated"],
                [
                    [
                        name,
                        _f(cap[name], 2),
                        str((headline.get("saturated") or {}).get(name, "-")),
                    ]
                    for name in sorted(cap)
                ],
            ))
        extra = {
            k: v for k, v in sorted(headline.items())
            if k not in ("capacity_per_policy", "saturated")
        }
        if extra:
            blocks.append(("p", "Claim context: " + json.dumps(
                extra, sort_keys=True, separators=(", ", ": "))))

    # ----------------------------------------------------- capacity table
    blocks.append(("h", 2, "Capacity (Def. 2)"))
    rows = []
    for a in result.arms:
        c = a.curve
        rows.append([
            a.name,
            (">= " if c.saturated else "") + _f(c.capacity, 2),
            _f(c.alpha, 2),
            _f(c.satisfaction[0]) if c.satisfaction else "-",
            _f(c.satisfaction[-1]) if c.satisfaction else "-",
            _spark(c.satisfaction),
        ])
    blocks.append((
        "table",
        ["arm", "capacity (jobs/s)", "alpha", "sat@first", "sat@last",
         "satisfaction curve"],
        rows,
    ))
    blocks.append((
        "p",
        "A `>=` capacity is a lower bound: the curve never crossed alpha "
        "inside the swept range.",
    ))

    # ----------------------------------------------- satisfaction vs rate
    all_rates = sorted({r for a in result.arms for r in a.curve.rates})
    if all_rates:
        blocks.append(("h", 2, "Satisfaction vs offered rate"))
        grid = {
            a.name: dict(zip(a.curve.rates, a.curve.satisfaction))
            for a in result.arms
        }
        blocks.append((
            "table",
            ["rate (jobs/s)"] + [a.name for a in result.arms],
            [
                [f"{r:g}"] + [
                    _f(grid[a.name].get(r)) for a in result.arms
                ]
                for r in all_rates
            ],
        ))

    # ------------------------------------------------------ ref deltas
    if ref is not None:
        blocks.append(("h", 2, "Delta vs reference"))
        blocks.append((
            "p",
            f"Reference: `{ref_source}`"
            if ref_source else "Reference: in-memory result",
        ))
        ref_arms = {a.name: a for a in ref.arms}
        rows = []
        for a in result.arms:
            b = ref_arms.get(a.name)
            if b is None:
                rows.append([a.name, _f(a.curve.capacity, 2), "-", "-"])
                continue
            rows.append([
                a.name,
                _f(a.curve.capacity, 2),
                _f(b.curve.capacity, 2),
                f"{a.curve.capacity - b.curve.capacity:+.2f}",
            ])
        for name in sorted(set(ref_arms) - {a.name for a in result.arms}):
            rows.append([f"{name} (reference only)", "-",
                         _f(ref_arms[name].curve.capacity, 2), "-"])
        blocks.append((
            "table",
            ["arm", "capacity", "ref capacity", "delta (jobs/s)"],
            rows,
        ))
        common = [a.name for a in result.arms if a.name in ref_arms]
        if common and all_rates:
            cur_grid = {
                a.name: dict(zip(a.curve.rates, a.curve.satisfaction))
                for a in result.arms
            }
            ref_grid = {
                name: dict(zip(ref_arms[name].curve.rates,
                               ref_arms[name].curve.satisfaction))
                for name in common
            }
            rows = []
            for r in all_rates:
                row = [f"{r:g}"]
                for name in common:
                    cur = cur_grid[name].get(r)
                    prev = ref_grid[name].get(r)
                    row.append(
                        f"{cur - prev:+.3f}"
                        if cur is not None and prev is not None else "-"
                    )
                rows.append(row)
            blocks.append(("h", 3, "Satisfaction delta per rate"))
            blocks.append(("table", ["rate (jobs/s)"] + common, rows))

    # ------------------------------------------------------ loss reasons
    reasons = result.drop_reason_totals()
    all_reasons = sorted({r for d in reasons.values() for r in d})
    if all_reasons:
        blocks.append(("h", 2, "Loss attribution"))
        blocks.append((
            "p",
            "Jobs lost per structured reason code, summed over every "
            "stored point mean (seed totals).",
        ))
        blocks.append((
            "table",
            ["arm"] + all_reasons,
            [
                [a.name] + [
                    str(reasons[a.name].get(r, 0)) for r in all_reasons
                ]
                for a in result.arms
            ],
        ))

    # --------------------------------------------------- per-arm detail
    detailed = [a for a in result.arms if a.points]
    if detailed:
        blocks.append(("h", 2, "Per-arm detail"))
    for a in detailed:
        blocks.append(("h", 3, a.name))
        blocks.append((
            "table",
            ["rate", "jobs", "sat", "drop", "e2e (ms)", "p99 e2e (ms)",
             "tok/s"],
            [
                [
                    f"{p.rate:g}",
                    str(p.mean.n_jobs),
                    _f(p.mean.satisfaction),
                    _f(p.mean.drop_rate),
                    _ms(p.mean.avg_e2e),
                    _ms(p.mean.p99_e2e),
                    _f(p.mean.avg_tokens_per_s, 1),
                ]
                for p in a.points
            ],
        ))
        tel = _find_telemetry(a)
        if tel is not None:
            rate, tel = tel
            groups = stage_percentiles(tel)
            st = groups.get("all")
            if st:
                blocks.append((
                    "h", 4, f"Stage attribution (traced point, rate {rate:g})"
                ))
                blocks.append((
                    "table",
                    ["stage", "n", "mean (ms)", "p50", "p90", "p95", "p99"],
                    [
                        [
                            stage,
                            str(st[stage]["n"]),
                            _ms(st[stage]["mean"]),
                            _ms(st[stage]["p50"]),
                            _ms(st[stage]["p90"]),
                            _ms(st[stage]["p95"]),
                            _ms(st[stage]["p99"]),
                        ]
                        for stage in st
                    ],
                ))

    # --------------------------------------------------- where time goes
    timed = [a for a in result.arms if a.wall_clock_s > 0.0]
    if timed:
        blocks.append(("h", 2, "Where time goes"))
        total = sum(a.wall_clock_s for a in timed)
        slowest = max(timed, key=lambda a: a.wall_clock_s)
        blocks.append((
            "p",
            f"Slowest arm: **{slowest.name}** "
            f"({_f(slowest.wall_clock_s, 1)} s of {_f(total, 1)} s summed "
            "task-seconds; under a process pool summed task-seconds "
            "exceed elapsed wall-clock).",
        ))
        blocks.append((
            "table",
            ["arm", "task-seconds (s)", "share", "elapsed wall (s)"],
            [
                [a.name, _f(a.wall_clock_s, 1),
                 _f(a.wall_clock_s / total if total else None, 2),
                 _f(a.elapsed_s, 1) if a.elapsed_s > 0.0 else "-"]
                for a in sorted(
                    timed, key=lambda a: (-a.wall_clock_s, a.name)
                )
            ],
        ))
    for a in result.arms:
        prof = a.profile or {}
        phases = prof.get("phases") or {}
        if not phases:
            continue
        blocks.append(("h", 3, f"Engine phases: {a.name}"))
        attributed = prof.get("attributed_s")
        blocks.append((
            "p",
            f"Phase attribution over {prof.get('n_runs', '?')} profiled "
            f"runs: {_f(attributed, 2)} s of {_f(prof.get('total_s'), 2)} "
            f"s engine wall attributed (coverage "
            f"{_f(prof.get('coverage'), 3)}).",
        ))
        phase_total = sum(phases.values()) or None
        blocks.append((
            "table",
            ["phase", "time (s)", "share"],
            [
                [name, _f(t, 3),
                 _f(t / phase_total if phase_total else None, 3)]
                for name, t in sorted(
                    phases.items(), key=lambda kv: (-kv[1], kv[0])
                )
            ],
        ))
        sub = prof.get("sub") or {}
        if sub:
            blocks.append((
                "p",
                "Sub-phases (inside phases above, not additive): "
                + ", ".join(f"{k}={_f(v, 3)}s"
                            for k, v in sorted(sub.items())) + ".",
            ))
        counters = prof.get("counters") or {}
        if counters:
            blocks.append((
                "p",
                "Counters: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(counters.items())
                ) + ".",
            ))
    if runlog:
        blocks.extend(_runlog_blocks(runlog, runlog_source))
    return blocks


_RUNLOG_POINT_CAP = 40


def _runlog_blocks(events: List[dict],
                   source: Optional[str] = None) -> List[Block]:
    """Render a parsed runlog (see `experiments.runlog`) into report IR:
    summary paragraph, slowest-first per-point table, phase rollup."""
    from ..experiments.runlog import summarize_runlog

    s = summarize_runlog(events)
    blocks: List[Block] = [("h", 2, "Run log")]
    src = f"`{source}`" if source else "an in-memory event list"
    rss = (f", peak worker RSS {_f(s['peak_rss_mb'], 1)} MB"
           if s["peak_rss_mb"] is not None else "")
    blocks.append((
        "p",
        f"Mined from {src}: {s['n_runs']} runs, {s['n_points']} points "
        f"({s['n_errors']} errors, {s['n_retries']} retries, "
        f"{s['n_heartbeats']} heartbeats), "
        f"{_f(s['task_seconds'], 1)} summed task-seconds{rss}.",
    ))
    pts = sorted(
        s["points"],
        key=lambda p: (-(p["duration_s"] or 0.0), str(p["arm"]),
                       p["rate"] or 0.0, p["seed"] or 0),
    )
    shown = pts[:_RUNLOG_POINT_CAP]
    if shown:
        blocks.append((
            "table",
            ["arm", "rate", "seed", "duration (s)", "peak RSS (MB)",
             "error"],
            [
                [str(p["arm"] or "-"),
                 f"{p['rate']:g}" if p["rate"] is not None else "-",
                 str(p["seed"]) if p["seed"] is not None else "-",
                 _f(p["duration_s"], 2),
                 _f(p["peak_rss_mb"], 1),
                 str((p["error"] or {}).get("error", "")) or "-"]
                for p in shown
            ],
        ))
        if len(pts) > len(shown):
            blocks.append((
                "p",
                f"Slowest {len(shown)} of {len(pts)} points shown.",
            ))
    if s["phases"]:
        blocks.append((
            "p",
            "Engine phases summed across logged points: " + ", ".join(
                f"{k}={_f(v, 3)}s" for k, v in sorted(s["phases"].items())
            ) + ".",
        ))
    return blocks


def _find_telemetry(arm) -> Optional[Tuple[float, dict]]:
    """The highest-rate stored telemetry dict on this arm (rate, tel), or
    None when the result was stored without traces."""
    for p in sorted(arm.points, key=lambda p: -p.rate):
        for s in p.seeds:
            tel = getattr(s.result, "telemetry", None)
            if isinstance(tel, dict) and tel.get("schema") == 1:
                return p.rate, tel
    return None


# -------------------------------------------------------------- renderers
def _render_md(blocks: List[Block]) -> str:
    out: List[str] = []
    for b in blocks:
        if b[0] == "h":
            out.append("#" * b[1] + " " + b[2])
        elif b[0] == "p":
            out.append(b[1])
        elif b[0] == "table":
            headers, rows = b[1], b[2]
            out.append("| " + " | ".join(headers) + " |")
            out.append("|" + "|".join(" --- " for _ in headers) + "|")
            for row in rows:
                out.append("| " + " | ".join(row) + " |")
        else:  # pragma: no cover - IR is produced locally
            raise ValueError(f"unknown block {b[0]!r}")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


_HTML_STYLE = (
    "body{font-family:sans-serif;margin:2em;max-width:70em}"
    "table{border-collapse:collapse;margin:1em 0}"
    "td,th{border:1px solid #999;padding:0.3em 0.6em;text-align:right}"
    "th{background:#eee}td:first-child,th:first-child{text-align:left}"
)


def _render_html(blocks: List[Block]) -> str:
    title = next((b[2] for b in blocks if b[0] == "h"), "Capacity report")
    out = [
        "<!doctype html>",
        "<html><head><meta charset=\"utf-8\">",
        f"<title>{_html.escape(title)}</title>",
        f"<style>{_HTML_STYLE}</style>",
        "</head><body>",
    ]
    for b in blocks:
        if b[0] == "h":
            lvl = min(b[1], 6)
            out.append(f"<h{lvl}>{_html.escape(b[2])}</h{lvl}>")
        elif b[0] == "p":
            # the IR uses markdown emphasis/backticks; strip to plain text
            txt = _html.escape(b[1]).replace("**", "").replace("`", "")
            out.append(f"<p>{txt}</p>")
        elif b[0] == "table":
            cells = "".join(f"<th>{_html.escape(h)}</th>" for h in b[1])
            out.append(f"<table><tr>{cells}</tr>")
            for row in b[2]:
                cells = "".join(f"<td>{_html.escape(c)}</td>" for c in row)
                out.append(f"<tr>{cells}</tr>")
            out.append("</table>")
        else:  # pragma: no cover
            raise ValueError(f"unknown block {b[0]!r}")
    out.append("</body></html>")
    return "\n".join(out) + "\n"


def render_blocks(blocks: List[Block], fmt: str = "md") -> str:
    if fmt == "md":
        return _render_md(blocks)
    if fmt == "html":
        return _render_html(blocks)
    raise ValueError(f"unknown format {fmt!r}; use md or html")


def render_report(
    result,
    headline: Optional[dict] = None,
    fmt: str = "md",
    source: Optional[str] = None,
    ref=None,
    ref_source: Optional[str] = None,
    runlog: Optional[List[dict]] = None,
    runlog_source: Optional[str] = None,
) -> str:
    """Render an in-memory `ExperimentResult` to md/html text."""
    return render_blocks(
        build_blocks(result, headline=headline, source=source, ref=ref,
                     ref_source=ref_source, runlog=runlog,
                     runlog_source=runlog_source),
        fmt=fmt,
    )


def generate_report(
    path: str,
    fmt: str = "md",
    ref_path: Optional[str] = None,
    runlog_path: Optional[str] = None,
) -> str:
    """Render a stored result file (raw `ExperimentResult` JSON or a
    tracked ``BENCH_*.json`` wrapper) to md/html text — offline and
    deterministic: the same file renders byte-identically every time.
    ``runlog_path`` (a ``run --runlog`` JSONL) adds the per-point
    run-health table."""
    from ..experiments.result import load_result
    from ..experiments.runlog import read_runlog

    result, headline = load_result(path)
    ref = ref_src = None
    if ref_path:
        ref, _ = load_result(ref_path)
        ref_src = os.path.basename(ref_path)
    runlog = runlog_src = None
    if runlog_path:
        runlog = read_runlog(runlog_path)
        runlog_src = os.path.basename(runlog_path)
    return render_report(
        result, headline=headline, fmt=fmt,
        source=os.path.basename(path), ref=ref, ref_source=ref_src,
        runlog=runlog, runlog_source=runlog_src,
    )
