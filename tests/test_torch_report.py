"""The port's capacity report (`repro_torch.telemetry.report`) and the
experiments CLI (`python -m repro_torch.experiments`) against the
reference's: `generate_report` byte-equal in md and html for each tracked
BENCH_*.json (alone and against itself as the reference) and for a quick
traced, profiled result with its runlog and a reference file; the CLI's
`list`, `show`, `run --out`, `report` and `validate-bench`."""

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.experiments.__main__ import main as ref_main  # noqa: E402
from repro.telemetry.report import generate_report as ref_generate_report  # noqa: E402
import repro_torch.experiments as exp  # noqa: E402
from repro_torch.experiments.__main__ import main  # noqa: E402
from repro_torch.telemetry import generate_report, render_report  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ["BENCH_network.json", "BENCH_batching.json", "BENCH_control.json",
         "BENCH_resilience.json"]
QUICK = "network_capacity_quick"


@pytest.mark.parametrize("fmt", ["md", "html"])
@pytest.mark.parametrize("path", BENCH)
def test_tracked_file_report_equals_the_reference(path, fmt):
    src = str(ROOT / path)
    got = generate_report(src, fmt=fmt)
    assert got == ref_generate_report(src, fmt=fmt)
    assert generate_report(src, fmt=fmt, ref_path=src) == \
        ref_generate_report(src, fmt=fmt, ref_path=src)
    if fmt == "md":
        assert got.startswith("# Capacity report: ")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced, profiled quick run written with every point, and its runlog."""
    tmp = tmp_path_factory.mktemp("traced")
    log = tmp / "runlog.jsonl"
    res = exp.run(exp.get_experiment(QUICK), workers=3, trace=True, profile=True,
                  runlog=str(log))
    out = tmp / "result.json"
    out.write_text(res.to_json(points="full"))
    return res, out, log


@pytest.mark.parametrize("fmt", ["md", "html"])
def test_quick_result_report_equals_the_reference(traced, fmt):
    _, out, log = traced
    ref = str(ROOT / "BENCH_network.json")
    got = generate_report(str(out), fmt=fmt, ref_path=ref, runlog_path=str(log))
    assert got == ref_generate_report(str(out), fmt=fmt, ref_path=ref, runlog_path=str(log))
    if fmt == "md":
        for section in ("## Delta vs reference", "Stage attribution", "## Where time goes",
                        "## Per-arm detail"):
            assert section in got, section


def test_render_report_of_a_result_in_memory(traced):
    res, out, _ = traced
    from repro_torch.experiments.result import load_result

    loaded, headline = load_result(str(out))
    assert headline is None
    assert render_report(loaded, source=out.name) == generate_report(str(out))
    assert render_report(res, fmt="html").startswith("<!doctype html>")


def cli(fn, argv, capsys):
    rc = fn(argv)
    return rc, capsys.readouterr().out


def test_cli_list_and_show_equal_the_reference(capsys):
    rc, out = cli(main, ["list"], capsys)
    assert rc == 0 and len(out.splitlines()) == len(exp.list_experiments())
    ref_rc, ref_out = cli(ref_main, ["list"], capsys)
    names = set(exp.list_experiments())
    assert out.splitlines() == [ln for ln in ref_out.splitlines() if ln.split()[0] in names]
    for name in ("network_capacity", "resilience_quick"):
        assert cli(main, ["show", name], capsys) == cli(ref_main, ["show", name], capsys)
    assert json.loads(cli(main, ["show", QUICK], capsys)[1]) == \
        exp.get_experiment(QUICK).to_dict()


def test_cli_run_out_and_report(traced, tmp_path, capsys):
    res, _, _ = traced
    out = tmp_path / "run.json"
    rc, text = cli(main, ["run", QUICK, "--workers", "3", "--out", str(out),
                          "--points", "none"], capsys)
    assert rc == 0 and f"wrote {out}" in text
    got = exp.ExperimentResult.from_dict(json.loads(out.read_text()))
    assert got.to_canonical_json(points="none") == res.to_canonical_json(points="none")
    for fmt in ("md", "html"):
        rc, text = cli(main, ["report", str(out), "--format", fmt,
                              "--ref", str(ROOT / "BENCH_network.json")], capsys)
        assert rc == 0
        assert text == ref_generate_report(str(out), fmt=fmt,
                                           ref_path=str(ROOT / "BENCH_network.json"))
    rc, text = cli(main, ["report", str(ROOT / "BENCH_control.json"), "--out",
                          str(tmp_path / "r.md")], capsys)
    assert rc == 0 and (tmp_path / "r.md").read_text() == \
        ref_generate_report(str(ROOT / "BENCH_control.json"))


def test_cli_validate_bench(tmp_path, capsys):
    paths = [str(ROOT / p) for p in BENCH]
    rc, out = cli(main, ["validate-bench", *paths, "--suite"], capsys)
    assert rc == 0 and "the suite catalog covers them" in out
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text("{}")
    rc, out = cli(main, ["validate-bench", str(bad)], capsys)
    assert rc == 1 and "[validate-bench]" in out
    assert cli(ref_main, ["validate-bench", str(bad)], capsys) == (rc, out)


def test_cli_rejects_cache_with_trace(tmp_path, capsys):
    rc = main(["run", QUICK, "--cache", str(tmp_path), "--trace", str(tmp_path / "t.json")])
    assert rc == 2 and "cannot be combined" in capsys.readouterr().err
