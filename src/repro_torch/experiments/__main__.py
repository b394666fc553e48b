"""CLI for the declarative experiment layer.

The port's copy of `repro/experiments/__main__.py`, with the same
arguments.

    python -m repro_torch.experiments list
    python -m repro_torch.experiments show network_capacity
    python -m repro_torch.experiments run network_capacity --workers -1 \
        --out benchmarks/results/network_capacity_run.json
    python -m repro_torch.experiments run network_capacity --quick
    python -m repro_torch.experiments run network_capacity --quick \
        --profile --progress --runlog benchmarks/results/runlog.jsonl
    python -m repro_torch.experiments run network_capacity_quick \
        --cache /tmp/repro-cache --shards 4
    python -m repro_torch.experiments report BENCH_network.json --format md
    python -m repro_torch.experiments report run.json --runlog runlog.jsonl
    python -m repro_torch.experiments suite list
    python -m repro_torch.experiments suite run bench_quick \
        --cache /tmp/repro-cache --shards 2
    python -m repro_torch.experiments validate-bench --suite

``run --quick`` resolves the registered ``<name>_quick`` variant — the
same reduced grids CI drives — and, like every reduced output, should be
pointed at ``benchmarks/results/`` (never the tracked repo-root
baselines, which only the full benchmark scripts regenerate).

``run --cache/--shards`` and the ``suite`` subcommand go through the
sharded dispatcher (`repro_torch.experiments.dispatch.run_sharded`): points
already in the content-addressed result cache are replayed instead of
re-simulated, the rest are packed into cost-balanced shards, and the
merged result is bit-identical to the single-process runner. ``suite
run`` regenerates every tracked file a suite names (``--root`` rebases
the repo-root-relative paths).
"""

from __future__ import annotations

import argparse
import logging
import sys

from .registry import get_experiment, list_experiments
from .runner import run
from .validate import validate_bench


def _configure_logging(args) -> None:
    """Wire --log-level / -v into the stdlib root logger.

    -v maps to info, -vv to debug; an explicit --log-level wins over
    counted -v flags. Without either, logging stays at the library
    default (warnings only) so existing output is byte-unchanged.
    """
    level_name = args.log_level
    if level_name is None and args.verbose:
        level_name = "debug" if args.verbose >= 2 else "info"
    if level_name is None:
        return
    logging.basicConfig(
        level=getattr(logging, level_name.upper()),
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments", description=__doc__
    )
    ap.add_argument("--log-level", choices=("debug", "info", "warning",
                                            "error"), default=None,
                    help="stdlib logging level for all repro loggers")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="-v = info, -vv = debug (shorthand for "
                         "--log-level)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="registered experiment names + arm counts")

    p_show = sub.add_parser("show", help="print a registered spec as JSON")
    p_show.add_argument("name")

    p_run = sub.add_parser("run", help="run a registered experiment")
    p_run.add_argument("name")
    p_run.add_argument("--quick", action="store_true",
                       help="run the registered <name>_quick variant")
    p_run.add_argument("--workers", type=int, default=None,
                       help="process pool size (-1 = one per CPU; default: "
                            "the spec's own setting)")
    p_run.add_argument("--out", default=None,
                       help="write the ExperimentResult JSON here")
    p_run.add_argument("--points", choices=("full", "mean", "none"),
                       default="mean",
                       help="per-point detail in --out (default: mean)")
    p_run.add_argument("--trace", default=None, metavar="PATH",
                       help="run with telemetry on and export a Chrome "
                            "trace (open at https://ui.perfetto.dev) of one "
                            "point: the traced arm's highest rate, seed 0")
    p_run.add_argument("--trace-arm", default=None, metavar="NAME",
                       help="arm to export with --trace (default: first)")
    p_run.add_argument("--sample-every", type=float, default=None,
                       metavar="SECONDS",
                       help="probe-sampling interval for --trace "
                            "time-series (default: the recorder's 0.01 s; "
                            "throttles probes only, never job events)")
    p_run.add_argument("--profile", action="store_true",
                       help="attribute engine wall-clock to phases "
                            "(arrivals, uplink, compute, ...); merged "
                            "per arm and shown in the report's 'where "
                            "time goes' section")
    p_run.add_argument("--progress", action="store_true",
                       help="live single-line sweep status on stderr "
                            "(TTY only; silent when piped)")
    p_run.add_argument("--runlog", default=None, metavar="PATH",
                       help="append one JSON line per lifecycle event "
                            "(task start/end, heartbeat, retry, error, "
                            "per-point duration + peak RSS) to this file")
    p_run.add_argument("--heartbeat", type=float, default=None,
                       metavar="SECONDS",
                       help="worker heartbeat interval for --progress/"
                            "--runlog (default 5; heartbeating points "
                            "are never killed by the task timeout)")
    p_run.add_argument("--cache", default=None, metavar="DIR",
                       help="content-addressed result cache: replay "
                            "already-computed (arm, rate, seed) points "
                            "from DIR and store the rest (routes the run "
                            "through the sharded dispatcher)")
    p_run.add_argument("--shards", type=int, default=None, metavar="N",
                       help="pack uncached points into N cost-balanced "
                            "shards (default: one per worker; implies the "
                            "sharded dispatcher)")
    p_run.add_argument("--cost-log", default=None, metavar="PATH",
                       help="runlog JSONL from a prior run: mine per-point "
                            "durations to balance the shard packing "
                            "(default: --runlog's file when it exists)")

    p_rep = sub.add_parser(
        "report",
        help="render a capacity report from a stored result JSON "
             "(raw ExperimentResult or tracked BENCH_*.json) — offline, "
             "deterministic, nothing is re-simulated",
    )
    p_rep.add_argument("path")
    p_rep.add_argument("--format", choices=("md", "html"), default="md")
    p_rep.add_argument("--out", default=None,
                       help="write the report here (default: stdout)")
    p_rep.add_argument("--ref", default=None, metavar="PATH",
                       help="reference result JSON: adds capacity and "
                            "per-rate satisfaction deltas vs it")
    p_rep.add_argument("--runlog", default=None, metavar="PATH",
                       help="runlog JSONL from `run --runlog`: adds a "
                            "per-point duration/RSS table to the report")

    p_suite = sub.add_parser(
        "suite",
        help="run/list benchmark suites (named groups of experiments "
             "that regenerate the tracked BENCH_*.json files)",
    )
    suite_sub = p_suite.add_subparsers(dest="suite_cmd", required=True)
    suite_sub.add_parser("list", help="registered suites + their entries")
    p_sr = suite_sub.add_parser(
        "run",
        help="run every experiment of a suite through the sharded "
             "dispatcher and rewrite its tracked result files",
    )
    p_sr.add_argument("name")
    p_sr.add_argument("--cache", default=None, metavar="DIR",
                      help="shared content-addressed result cache "
                           "directory (warm reruns replay points instead "
                           "of re-simulating)")
    p_sr.add_argument("--shards", type=int, default=None, metavar="N",
                      help="shards per experiment (default: one per "
                           "worker)")
    p_sr.add_argument("--workers", type=int, default=None,
                      help="process pool size (-1 = one per CPU; default: "
                           "each spec's own setting)")
    p_sr.add_argument("--root", default=".",
                      help="rebase the suite's repo-root-relative output "
                           "paths (default: cwd)")
    p_sr.add_argument("--runlog", default=None, metavar="PATH",
                      help="append lifecycle + cache_stats events here")
    p_sr.add_argument("--progress", action="store_true",
                      help="live sweep status on stderr (TTY only)")
    p_sr.add_argument("--stats", default=None, metavar="PATH",
                      help="write the suite summary (per-entry cache "
                           "deltas + totals) as JSON here")

    p_val = sub.add_parser(
        "validate-bench",
        help="check tracked BENCH_*.json baselines against the result schema",
    )
    p_val.add_argument("paths", nargs="*",
                       help="explicit files (default: the tracked baselines)")
    p_val.add_argument("--suite", action="store_true",
                       help="also check the suite catalog: bench_all "
                            "covers every tracked baseline, experiments "
                            "are registered, writers resolve")

    args = ap.parse_args(argv)
    _configure_logging(args)

    if args.cmd == "list":
        for name in list_experiments():
            spec = get_experiment(name)
            arms = spec.resolve_arms()
            print(f"{name:28s} {len(arms):3d} arms  {spec.description}")
        return 0

    if args.cmd == "show":
        print(get_experiment(args.name).to_json())
        return 0

    if args.cmd == "run":
        name = f"{args.name}_quick" if args.quick else args.name
        spec = get_experiment(name)
        sharded = (args.cache is not None or args.shards is not None
                   or args.cost_log is not None)
        if sharded and (args.trace or args.profile):
            # cached points carry no telemetry/profile (the cache refuses
            # them), so a replayed run could not honor these flags
            print("error: --cache/--shards/--cost-log cannot be combined "
                  "with --trace or --profile (cached points carry no "
                  "telemetry); drop one side", file=sys.stderr)
            return 2
        if sharded:
            from .dispatch import run_sharded

            result = run_sharded(spec, shards=args.shards,
                                 cache=args.cache, workers=args.workers,
                                 cost_log=args.cost_log,
                                 runlog=args.runlog,
                                 progress=args.progress or None,
                                 heartbeat_s=args.heartbeat)
            print(result.summary())
            if args.out:
                with open(args.out, "w") as f:
                    f.write(result.to_json(points=args.points))
                print(f"wrote {args.out}")
            return 0
        if args.trace_arm is not None:
            # fail fast, before any simulation runs: a typo'd arm name
            # used to surface only after the whole sweep finished
            known = [a.name for a in spec.resolve_arms()]
            if args.trace_arm not in known:
                print(f"error: unknown --trace-arm {args.trace_arm!r}; "
                      f"available arms: {', '.join(known)}",
                      file=sys.stderr)
                return 2
        result = run(spec, workers=args.workers,
                     trace=args.trace is not None,
                     sample_every_s=args.sample_every,
                     profile=args.profile,
                     progress=args.progress or None,
                     runlog=args.runlog,
                     heartbeat_s=args.heartbeat)
        print(result.summary())
        if args.profile:
            for a in result.arms:
                prof = a.profile or {}
                top = sorted((prof.get("phases") or {}).items(),
                             key=lambda kv: -kv[1])[:3]
                if top:
                    body = ", ".join(f"{k} {v:.2f}s" for k, v in top)
                    print(f"  [profile] {a.name}: {body}  "
                          f"(coverage {prof.get('coverage')})")
        if args.out:
            with open(args.out, "w") as f:
                f.write(result.to_json(points=args.points))
            print(f"wrote {args.out}")
        if args.trace:
            from ..telemetry import write_chrome_trace

            arm = (result.arm(args.trace_arm) if args.trace_arm
                   else result.arms[0])
            point = max(arm.points, key=lambda p: p.rate)
            tel = point.seeds[0].result.telemetry
            if tel is None:  # defensive: trace=True attaches it everywhere
                print("[trace] no telemetry captured; nothing to export",
                      file=sys.stderr)
                return 1
            write_chrome_trace(tel, args.trace)
            print(f"wrote {args.trace} "
                  f"(arm={arm.name}, rate={point.rate:g}, seed 0; "
                  f"{tel['counts']['jobs']} jobs, "
                  f"{tel['counts']['events']} events)")
        return 0

    if args.cmd == "report":
        from ..telemetry.report import generate_report

        text = generate_report(args.path, fmt=args.format,
                               ref_path=args.ref,
                               runlog_path=args.runlog)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
            print(f"wrote {args.out}")
        else:
            print(text, end="")
        return 0

    if args.cmd == "suite":
        from .suites import get_suite, list_suites, run_suite

        if args.suite_cmd == "list":
            for name in list_suites():
                suite = get_suite(name)
                print(f"{name}: {suite.description}")
                for e in suite.entries:
                    print(f"  {e.experiment:28s} -> {e.bench_path}")
            return 0
        # suite run
        summary = run_suite(args.name, cache=args.cache,
                            shards=args.shards, workers=args.workers,
                            root=args.root, runlog=args.runlog,
                            progress=args.progress or None)
        for row in summary["entries"]:
            cache_s = ""
            if row["cache"] is not None:
                c = row["cache"]
                cache_s = (f"  cache {c['hits']} hit / {c['misses']} miss"
                           f" / {c['stale']} stale")
            print(f"[suite] {row['experiment']:28s} -> {row['bench_path']}"
                  f"  ({row['n_points']} points, "
                  f"{row['task_seconds']:.1f} task-s){cache_s}")
        if summary["cache"] is not None:
            t = summary["cache"]
            n = t["hits"] + t["misses"] + t["stale"]
            pct = 100.0 * t["hits"] / n if n else 0.0
            print(f"[suite] cache totals: {t['hits']}/{n} point hits "
                  f"({pct:.0f}%), {t['writes']} writes")
        if args.stats:
            import json as _json

            doc = {k: summary[k] for k in ("suite", "entries", "cache")}
            with open(args.stats, "w") as f:
                _json.dump(doc, f, indent=1, sort_keys=True)
            print(f"wrote {args.stats}")
        return 0

    if args.cmd == "validate-bench":
        problems = validate_bench(args.paths or None)
        if args.suite:
            from .validate import validate_suite_coverage

            problems = problems + validate_suite_coverage()
        if problems:
            for p in problems:
                print(f"[validate-bench] {p}")
            return 1
        suffix = " and the suite catalog covers them" if args.suite else ""
        print("[validate-bench] all tracked baselines parse against the "
              f"ExperimentResult schema{suffix}")
        return 0

    return 2  # unreachable: subparsers are required


if __name__ == "__main__":
    sys.exit(main())
