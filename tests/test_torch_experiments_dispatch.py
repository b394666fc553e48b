"""The port's result cache, sharded dispatch, suites and run logs
(`repro_torch.experiments.{cache,dispatch,suites,runlog}`) against the
reference's: the same shard plans, `run_sharded` byte-equal to `run` cold
and warm (all hits), stale entries after a schema or engine-code change,
`run_suite("bench_quick")` documents equal to the reference's less the
timing keys, and the same runlog events and rollup less their timings."""

import dataclasses
import json

import pytest

pytest.importorskip("torch")

import repro.experiments as ref_exp  # noqa: E402
from repro.experiments.runlog import summarize_runlog as ref_summarize_runlog  # noqa: E402
import repro_torch.experiments as exp  # noqa: E402
from repro_torch.experiments import cache as cache_mod  # noqa: E402
from repro_torch.experiments import spec as spec_mod  # noqa: E402
from repro_torch.experiments.__main__ import main  # noqa: E402
from repro_torch.experiments.runlog import read_runlog, summarize_runlog  # noqa: E402
from repro_torch.experiments.runner import run_point  # noqa: E402

QUICK = "network_capacity_quick"
WORKERS = 3
# a BENCH document's headline wall clocks; the result's timings are what
# `ExperimentResult.to_canonical_dict` normalizes
HEADLINE_TIMING = ("wall_clock_s", "sweep_wall_clock_s")
# runlog fields that carry clocks, process ids or memory
RUNLOG_TIMING = ("ts", "t_s", "pid", "duration_s", "peak_rss_mb", "wall_clock_s",
                 "task_seconds", "elapsed_s")


def physics(doc, pkg):
    """A BENCH document less its timing keys."""
    res = pkg.ExperimentResult.from_dict(doc["result"])
    return dict(doc, headline={k: v for k, v in doc["headline"].items()
                               if k not in HEADLINE_TIMING},
                result=res.to_canonical_dict(points="none"))


def points(spec):
    return [(tid, a.name, float(lam), s) for tid, (a, lam, s) in enumerate(
        (a, lam, s) for a in spec.resolve_arms() for lam in a.sweep.rates
        for s in range(a.sweep.n_seeds))]


@pytest.mark.parametrize("name", ["network_capacity", "batching_capacity", "resilience_quick"])
@pytest.mark.parametrize("n_shards", [1, 3, 7, 1000])
def test_plan_shards_equals_the_reference(name, n_shards):
    pts = points(exp.get_experiment(name))
    cost, ref_cost = exp.CostModel(), ref_exp.CostModel()
    for i, (_, arm, lam, _) in enumerate(pts[::5]):  # a cost model with data on some points
        cost.observe(arm, lam, 0.1 * (i % 7) + 0.05)
        ref_cost.observe(arm, lam, 0.1 * (i % 7) + 0.05)
    for c, rc in ((None, None), (cost, ref_cost)):
        got = exp.plan_shards(pts, n_shards, c)
        want = ref_exp.plan_shards(pts, n_shards, rc)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    assert cost.predict("nowhere", 1.0) == ref_cost.predict("nowhere", 1.0)


@pytest.fixture(scope="module")
def single():
    return exp.run(exp.get_experiment(QUICK), workers=WORKERS)


def test_run_sharded_cold_and_warm_equal_run(single, tmp_path):
    spec = exp.get_experiment(QUICK)
    n = sum(len(a.sweep.rates) * a.sweep.n_seeds for a in spec.resolve_arms())
    cold = exp.run_sharded(spec, shards=2, cache=str(tmp_path), workers=WORKERS)
    assert cold.cache == {"hits": 0, "misses": n, "stale": 0, "writes": n}
    assert cold.to_canonical_json() == single.to_canonical_json()
    warm = exp.run_sharded(spec, shards=2, cache=str(tmp_path), workers=WORKERS)
    assert warm.cache == {"hits": n, "misses": 0, "stale": 0, "writes": 0}
    assert warm.to_json() == cold.to_json()
    assert exp.run_sharded(spec, shards=5, workers=WORKERS).to_canonical_json() \
        == single.to_canonical_json()


def test_stale_after_a_code_fingerprint_change(tmp_path, monkeypatch):
    spec = exp.get_experiment(QUICK)
    arm = spec.resolve_arms()[0]
    rate = float(arm.sweep.rates[0])
    store = exp.ResultCache(tmp_path)
    assert store.put(arm, rate, 0, run_point(arm, rate, 0))
    got = store.get(arm, rate, 0)
    assert got is not None and got.cached
    monkeypatch.setattr(cache_mod, "code_fingerprint", lambda: "another engine")
    assert store.get(arm, rate, 0) is None
    assert store.stats.as_dict() == {"hits": 1, "misses": 0, "stale": 1, "writes": 1}


def test_stale_after_a_schema_change(tmp_path, monkeypatch):
    spec = exp.get_experiment(QUICK)
    arm = spec.resolve_arms()[0]
    rate = float(arm.sweep.rates[0])
    store = exp.ResultCache(tmp_path)
    store.put(arm, rate, 0, run_point(arm, rate, 0))
    monkeypatch.setattr(cache_mod, "CACHE_SCHEMA", cache_mod.CACHE_SCHEMA + 1)
    assert store.get(arm, rate, 0) is None and store.stats.stale == 1
    # a spec schema bump re-hashes every arm, so nothing old is even found
    before = cache_mod.arm_fingerprint(arm)
    monkeypatch.setattr(cache_mod, "SCHEMA_VERSION", spec_mod.SCHEMA_VERSION + 1)
    assert cache_mod.arm_fingerprint(arm) != before


def test_code_fingerprint_hashes_the_ports_own_engines():
    """A deliberate difference: the port hashes `repro_torch`'s engine
    sources, so the two packages never share cache entries."""
    fp = exp.code_fingerprint()
    assert len(fp) == 64 and fp == exp.code_fingerprint()
    assert fp != ref_exp.code_fingerprint()
    assert cache_mod._ENGINE_PACKAGES == ("core", "network", "batching", "control", "faults")


def test_run_suite_bench_quick_equals_the_reference(tmp_path):
    port = exp.run_suite("bench_quick", workers=WORKERS, root=str(tmp_path / "port"))
    ref = ref_exp.run_suite("bench_quick", workers=WORKERS, root=str(tmp_path / "ref"))
    entries = exp.get_suite("bench_quick").entries
    assert [e.bench_path for e in entries] == \
        [e.bench_path for e in ref_exp.get_suite("bench_quick").entries]
    for entry in entries:
        got = json.loads((tmp_path / "port" / entry.bench_path).read_text())
        want = json.loads((tmp_path / "ref" / entry.bench_path).read_text())
        assert sorted(got["headline"]) == sorted(want["headline"])
        assert physics(got, exp) == physics(want, ref_exp), entry.bench_path
    strip = lambda rows: [{k: v for k, v in r.items() if k != "task_seconds"} for r in rows]
    assert strip(port["entries"]) == strip(ref["entries"])
    for name, res in port["results"].items():
        assert res.to_canonical_json() == ref["results"][name].to_canonical_json()


def test_suite_catalogs_match_but_for_the_writers():
    assert exp.list_suites() == ["bench_all", "bench_quick"]
    for name in exp.list_suites():
        ours, theirs = exp.get_suite(name), ref_exp.get_suite(name)
        assert [(e.experiment, e.bench_path) for e in ours.entries] == \
            [(e.experiment, e.bench_path) for e in theirs.entries]
        assert all(e.writer.startswith("repro_torch.experiments.bench_docs:")
                   for e in ours.entries)


def test_register_suite_raises_and_replaces_as_the_reference():
    entry = exp.SuiteEntry(QUICK, "out.json", "repro_torch.experiments.bench_docs:network_capacity")
    with pytest.raises(ValueError, match="already registered"):
        exp.register_suite(exp.Suite("bench_all", "dup", (entry,)))
    with pytest.raises(ValueError, match="no entries"):
        exp.register_suite(exp.Suite("empty", "none", ()))
    with pytest.raises(ValueError, match="twice"):
        exp.register_suite(exp.Suite("dup-path", "x", (entry, entry)))
    with pytest.raises(KeyError, match="unknown suite"):
        exp.get_suite("never-registered")
    from repro_torch.experiments import suites

    try:
        one = exp.register_suite(exp.Suite("tiny", "one entry", (entry,)))
        assert exp.register_suite(one, replace=True) is one and exp.get_suite("tiny") is one
        with pytest.raises(ImportError, match="cannot import"):
            suites.resolve_writer("no_such_module:fn")
        with pytest.raises(AttributeError, match="no callable"):
            suites.resolve_writer("repro_torch.experiments.bench_docs:nothing")
    finally:
        suites._SUITES.pop("tiny", None)


def test_cli_suite_run_warm_rewrites_the_same_bytes(tmp_path, capsys):
    from repro_torch.experiments import suites

    entry = exp.SuiteEntry(QUICK, "BENCH_tiny.json",
                           "repro_torch.experiments.bench_docs:network_capacity")
    exp.register_suite(exp.Suite("tiny-cli", "one quick entry", (entry,)), replace=True)
    try:
        cache = str(tmp_path / "cache")
        out = exp.run_suite("tiny-cli", cache=cache, shards=2, workers=0, root=str(tmp_path))
        first = (tmp_path / "BENCH_tiny.json").read_bytes()
        assert out["cache"]["misses"] > 0 and out["cache"]["hits"] == 0
        stats = tmp_path / "stats.json"
        assert main(["suite", "run", "tiny-cli", "--cache", cache, "--shards", "2",
                     "--workers", "0", "--root", str(tmp_path), "--stats", str(stats)]) == 0
        assert (tmp_path / "BENCH_tiny.json").read_bytes() == first
        assert json.loads(stats.read_text())["cache"]["hits"] == out["cache"]["misses"]
        assert "point hits (100%)" in capsys.readouterr().out
    finally:
        suites._SUITES.pop("tiny-cli", None)


def untimed(events):
    return [{k: v for k, v in e.items() if k not in RUNLOG_TIMING} for e in events]


def test_runlog_matches_the_reference(tmp_path):
    """A serial run, so that the task events come in one order."""
    port_log, ref_log = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    kw = dict(rates=[40, 120], sim_time=2.0, warmup=0.5, n_seeds=2, name="runlog")
    exp.run(exp.network_capacity_spec(**kw), workers=0, runlog=str(port_log))
    ref_exp.run(ref_exp.network_capacity_spec(**kw), workers=0, runlog=str(ref_log))
    got, want = read_runlog(str(port_log)), read_runlog(str(ref_log))
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert untimed(got) == untimed(want)
    summary, ref_summary = summarize_runlog(got), ref_summarize_runlog(want)
    for s in (summary, ref_summary):
        s.pop("task_seconds"), s.pop("peak_rss_mb")
        s["points"] = untimed(s["points"])
    assert summary == ref_summary
    assert summary["n_points"] == 16 and summary["n_errors"] == 0
