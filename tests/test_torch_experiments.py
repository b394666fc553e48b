"""The port's experiments layer (`repro_torch.experiments`) and
`core.capacity.network_sweep` against the reference's `repro.experiments`:
the same specs (JSON, hashes, arm fingerprints) for every registered
experiment, the tracked BENCH_*.json specs loading in the port, and
`run(spec)` byte-equal in canonical form (timing fields normalized out) on
the four quick grids. The layer is a plain-Python copy over engines that
keep the reference's draw order, so the bar is equality."""

import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.experiments as ref_exp  # noqa: E402
from repro.core.capacity import network_sweep as ref_network_sweep  # noqa: E402
from repro.experiments.cache import arm_fingerprint as ref_arm_fingerprint  # noqa: E402
from repro.network import three_cell_hetero as ref_three_cell_hetero  # noqa: E402
import repro_torch.experiments as exp  # noqa: E402
from repro_torch.core import network_sweep  # noqa: E402
from repro_torch.experiments import registry, result as result_mod  # noqa: E402
from repro_torch.experiments.cache import arm_fingerprint  # noqa: E402
from repro_torch.network import three_cell_hetero  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = ["batching_capacity", "batching_capacity_quick", "control_capacity",
               "control_capacity_quick", "network_capacity", "network_capacity_quick",
               "network_scenarios", "resilience", "resilience_quick"]
QUICK = ["network_capacity_quick", "batching_capacity_quick", "control_capacity_quick",
         "resilience_quick"]
BENCH = ["BENCH_network.json", "BENCH_batching.json", "BENCH_control.json",
         "BENCH_resilience.json"]
WORKERS = 3  # the quick grids' pool in both packages (the results do not depend on it)


def test_registries_hold_the_same_names():
    # the reference's own tests may have registered test specs in this process
    assert exp.list_experiments() == EXPERIMENTS
    assert set(EXPERIMENTS) <= set(ref_exp.list_experiments())


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_spec_equals_the_reference(name):
    spec, ref = exp.get_experiment(name), ref_exp.get_experiment(name)
    assert spec.to_dict() == ref.to_dict()
    assert spec.to_json() == ref.to_json()
    assert exp.spec_hash(spec) == ref_exp.spec_hash(ref)
    arms, ref_arms = spec.resolve_arms(), ref.resolve_arms()
    assert [a.name for a in arms] == [a.name for a in ref_arms]
    assert [arm_fingerprint(a) for a in arms] == [ref_arm_fingerprint(a) for a in ref_arms]
    assert type(spec).from_dict(spec.to_dict()) == spec
    assert type(spec).from_json(ref.to_json()) == spec


@pytest.mark.parametrize("path", BENCH)
def test_tracked_bench_spec_loads_in_the_port(path):
    doc = json.loads((ROOT / path).read_text())
    spec = exp.ExperimentSpec.from_dict(doc["result"]["spec"])
    assert spec == exp.get_experiment(doc["experiment"])
    assert spec.to_dict() == doc["result"]["spec"]
    res, headline = result_mod.load_result(str(ROOT / path))
    assert headline == doc["headline"]
    assert res.to_dict(points="none") == doc["result"]


@pytest.fixture(scope="module")
def quick_runs():
    """name -> (port result, reference result), each run once."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = (exp.run(exp.get_experiment(name), workers=WORKERS),
                          ref_exp.run(ref_exp.get_experiment(name), workers=WORKERS))
        return runs[name]
    return get


@pytest.mark.parametrize("name", QUICK)
def test_quick_run_is_byte_equal_to_the_reference(quick_runs, name):
    port, ref = quick_runs(name)
    assert port.to_canonical_json() == ref.to_canonical_json()
    assert port.to_canonical_json(points="mean") == ref.to_canonical_json(points="mean")
    assert [a.curve.capacity for a in port.arms] == [a.curve.capacity for a in ref.arms]


@pytest.mark.parametrize("name", QUICK)
def test_quick_result_round_trips(quick_runs, name):
    port, _ = quick_runs(name)
    back = exp.ExperimentResult.from_dict(json.loads(port.to_json()))
    assert back.to_json() == port.to_json()
    assert back.drop_reason_totals() == port.drop_reason_totals()


def test_summary_lines_equal_the_reference(quick_runs):
    port, ref = quick_runs("network_capacity_quick")
    # the arm lines; the first and the last carry wall clocks
    arms = lambda s: [ln for ln in s.splitlines() if " capacity" in ln]
    assert len(arms(port.summary())) == len(port.arms)
    assert arms(port.summary()) == arms(ref.summary())


def test_network_sweep_equals_the_reference():
    kw = dict(sim_time=2.0, warmup=0.5, n_seeds=2)
    rates = [30.0, 60.0]
    got = network_sweep(three_cell_hetero(), "slack_aware", rates, workers=0, **kw)
    assert got == ref_network_sweep(ref_three_cell_hetero(), "slack_aware", rates,
                                    workers=0, **kw)
    assert got == network_sweep(three_cell_hetero(), "slack_aware", rates, workers=2, **kw)
    with pytest.raises(TypeError, match="unsupported extra"):
        network_sweep(three_cell_hetero(), "slack_aware", rates, extra={"nope": 1}, **kw)


def test_validate_bench_finds_nothing_on_the_tracked_files():
    assert exp.validate_bench(root=str(ROOT)) == []
    assert exp.validate_suite_coverage() == []


def test_validate_bench_reports_a_broken_file(tmp_path):
    doc = json.loads((ROOT / "BENCH_network.json").read_text())
    doc["schema_version"] = -1
    bad = tmp_path / "BENCH_network.json"
    bad.write_text(json.dumps(doc))
    problems = exp.validate_bench([str(bad)])
    assert problems and "schema_version" in problems[0]
    assert ref_exp.validate_bench([str(bad)]) == problems


def test_register_experiment_raises_and_replaces_as_the_reference():
    spec = exp.get_experiment("network_capacity_quick")
    with pytest.raises(ValueError, match="already registered"):
        exp.register_experiment(spec)
    with pytest.raises(TypeError, match="expected ExperimentSpec"):
        exp.register_experiment(ref_exp.get_experiment("network_capacity_quick"))
    with pytest.raises(KeyError, match="unknown experiment"):
        exp.get_experiment("never-registered")
    try:
        again = exp.register_experiment(spec, replace=True)
        assert again is spec and exp.get_experiment(spec.name) is spec
    finally:
        registry._EXPERIMENTS[spec.name] = spec
