"""The port's derived telemetry (`repro_torch.telemetry.metrics` and
`.chrome`) against the reference's `repro.telemetry` on the same traced
runs: the counterparts of tests/test_metrics.py and the Chrome-trace part of
tests/test_telemetry.py. Every rollup is a pure function of the telemetry
dict, so the bar is equality of the JSON (`sort_keys`), single-cell and
network, classic and batched.
"""

import json
import pickle

import pytest

pytest.importorskip("torch")

from repro import network as ref_net  # noqa: E402
from repro import telemetry as ref_tel  # noqa: E402
from repro.batching import BatchedComputeNode as RefNode  # noqa: E402
from repro.control import MobilityConfig as RefMobility  # noqa: E402
from repro.core import latency_model as ref_lm  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.telemetry import metrics as ref_metrics  # noqa: E402
from repro_torch import network as net  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.batching import BatchedComputeNode  # noqa: E402
from repro_torch.control import MobilityConfig  # noqa: E402
from repro_torch.core import latency_model, simulator  # noqa: E402
from repro_torch.telemetry import (EventRecorder, chrome_trace, littles_law_check,  # noqa: E402
                                   mm1_conformance, stage_percentiles, summarize,
                                   write_chrome_trace)
from repro_torch.telemetry import metrics  # noqa: E402

SINGLE = dict(n_ues=60, sim_time=4.0, seed=3)


def single(pkg_sim, pkg_lm, pkg_node, rec, batched):
    cfg = pkg_sim.SimConfig(**SINGLE)
    hw = pkg_lm.GH200_NVL2.scaled(2)
    if not batched:
        return pkg_sim.simulate(pkg_sim.SCHEMES["icc"], cfg,
                                pkg_lm.ModelService(hw, pkg_lm.LLAMA2_7B), recorder=rec)
    lm = pkg_lm.LatencyModel(hw, pkg_lm.LLAMA2_7B, fidelity="extended")
    return pkg_sim.simulate(pkg_sim.SCHEMES["icc"], cfg, recorder=rec, node_factory=lambda:
                            pkg_node(lm, max_batch=8, policy="priority", drop_infeasible=True))


def network(pkg, mobility_cls, rec, case):
    if case == "network":  # classic fleet, past least_loaded's capacity: drops
        cfg = pkg.config_for_load(pkg.three_cell_hetero(), pkg.SCENARIOS["ar_translation"],
                                  140.0, sim_time=2.5, warmup=0.5, seed=1)
        return pkg.simulate_network(cfg, "least_loaded", recorder=rec)
    if case == "batched_network":
        cfg = pkg.config_for_load(pkg.three_cell_hetero(), pkg.SCENARIOS["ar_translation"],
                                  70.0, sim_time=2.5, warmup=0.5, seed=1, node_kind="batched")
        return pkg.simulate_network(cfg, "slack_aware", recorder=rec)
    if case == "flash":  # the joint controller acts through the spike at 4-6 s
        cfg = pkg.config_for_load(pkg.three_cell_hetero(), pkg.SCENARIOS["flash_crowd"], 40.0,
                                  sim_time=5.0, warmup=1.0, seed=0,
                                  controller="slack_aware_joint", window_s=1.0)
        return pkg.simulate_network(cfg, "controlled", recorder=rec)
    cfg = pkg.config_for_load(pkg.three_cell_hetero(), pkg.SCENARIOS["flash_crowd"], 30.0,
                              sim_time=2.5, warmup=0.5, seed=4,
                              mobility=mobility_cls(n_roamers=6, dwell_mean_s=0.25))
    return pkg.simulate_network(cfg, "slack_aware", recorder=rec)


CASES = ["single", "batched_single", "network", "batched_network", "flash", "mobility"]


@pytest.fixture(scope="module", params=CASES)
def traced(request):
    """(port recorder, port telemetry, reference telemetry, the port's
    result) of one traced run in each package on the same seed."""
    case = request.param
    ours, theirs = EventRecorder(), ref_tel.EventRecorder()
    if case.endswith("single"):
        res = single(simulator, latency_model, BatchedComputeNode, ours, case == "batched_single")
        single(ref_sim, ref_lm, RefNode, theirs, case == "batched_single")
    else:
        res = network(net, MobilityConfig, ours, case)
        network(ref_net, RefMobility, theirs, case)
        assert case != "mobility" or res.n_rehomed > 0  # Xn re-homing really ran
    return ours, ours.to_telemetry(), theirs.to_telemetry(), res


def same_json(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


class TestRollupsEqualReference:
    def test_telemetry_equals_reference(self, traced):
        _, tel, ref, _ = traced
        same_json(tel, ref)
        assert tel["counts"]["completed"] > 0

    def test_summarize(self, traced):
        rec, tel, ref, _ = traced
        ours = summarize(tel)
        same_json(ours, ref_metrics.summarize(ref))
        same_json(ours, summarize(tel))  # pure: the same blob twice
        json.dumps(ours, allow_nan=False)
        same_json(rec.to_metrics(), ours)  # the recorder's front end

    @pytest.mark.parametrize("by", [None, "cell", "route", "ue"])
    def test_stage_percentiles(self, traced, by):
        _, tel, ref, _ = traced
        ours = stage_percentiles(tel, by=by)
        same_json(ours, ref_metrics.stage_percentiles(ref, by=by))
        if by is None:
            e2e = ours["all"]["e2e"]
            assert e2e["n"] == tel["counts"]["completed"]
            assert 0.0 < e2e["p50"] <= e2e["p90"] <= e2e["p95"] <= e2e["p99"]
        else:
            assert sum(g["e2e"]["n"] for g in ours.values()) == tel["counts"]["completed"]

    def test_littles_law(self, traced):
        _, tel, ref, _ = traced
        ours = littles_law_check(tel)
        same_json(ours, ref_metrics.littles_law_check(ref))
        assert ours

    @pytest.mark.parametrize("bucket_s", [0.5, 1.0])
    def test_timelines_and_occupancy(self, traced, bucket_s):
        _, tel, ref, _ = traced
        g = metrics.goodput_timeline(tel, bucket_s=bucket_s)
        same_json(g, ref_metrics.goodput_timeline(ref, bucket_s=bucket_s))
        assert sum(g["generated"]) == tel["counts"]["jobs"]
        assert sum(g["completed"]) == tel["counts"]["completed"]
        same_json(metrics.utilization_timeline(tel, bucket_s=bucket_s),
                  ref_metrics.utilization_timeline(ref, bucket_s=bucket_s))
        occ = metrics.occupancy_distribution(tel)
        same_json(occ, ref_metrics.occupancy_distribution(ref))
        assert set(occ) == set(tel["series"])
        assert metrics.drop_reason_counts(tel) == tel["counts"]["drop_reasons"]

    def test_chrome_trace(self, traced, tmp_path):
        _, tel, ref, res = traced
        ct = chrome_trace(tel)
        same_json(ct, ref_tel.chrome_trace(ref))
        json.dumps(ct, allow_nan=False)  # no NaN or Inf reaches the JSON
        phases = [e["ph"] for e in ct["traceEvents"]]
        assert phases.count("b") == phases.count("e") > 0 and "M" in phases
        depth = {}
        for e in ct["traceEvents"]:
            if e["ph"] in ("b", "e"):
                key = (e["cat"], e["id"], e["name"])
                depth[key] = depth.get(key, 0) + (1 if e["ph"] == "b" else -1)
                assert depth[key] >= 0, key
        assert all(v == 0 for v in depth.values())
        path = tmp_path / "trace.json"
        write_chrome_trace(tel, str(path))
        assert json.loads(path.read_text()) == json.loads(json.dumps(ct))
        if getattr(res, "n_rehomed", 0):  # re-homed bursts paired across cell tracks
            outs = [e for e in ct["traceEvents"] if e.get("name") == "rehome_out"]
            ins = [e for e in ct["traceEvents"] if e.get("name") == "rehome_in"]
            assert len(outs) == len(ins) == res.n_rehomed


class TestConformance:
    @pytest.mark.parametrize("kw", [{}, {"lam": 50.0, "seed": 3, "sim_time": 30.0}],
                             ids=["default", "lam50"])
    def test_mm1_equals_reference(self, kw):
        """The M/M/1-exact regime of the real slot engine against
        `ICCSystem`'s closed forms: the same report as the reference's (the
        port's `exp_sum_cdf` clamp to [0, 1] does not reach the comp stage)."""
        ours = mm1_conformance(**kw)
        same_json(ours, ref_metrics.mm1_conformance(**kw))
        assert ours["passed"], ours["checks"]

    def test_mm1_fixed_seed_pin(self):
        r = mm1_conformance(tol_ks=0.05, tol_sat=0.025, tol_little=0.1)
        assert r["passed"], r["checks"]
        by = {c["name"]: c for c in r["checks"]}
        assert by["radio_near_constant"]["value"] <= 2e-3
        assert by["ks_comp"]["value"] <= 0.05 and by["ks_e2e"]["value"] <= 0.05
        assert r["n_jobs"] > 2000

    def test_expservice_equals_reference_and_pickles(self):
        a, b = metrics.ExpService(100.0, seed=5), ref_metrics.ExpService(100.0, seed=5)
        draws = [a(None) for _ in range(4)]
        assert draws == [b(None) for _ in range(4)]
        c = pickle.loads(pickle.dumps(metrics.ExpService(100.0, seed=5)))
        assert [c(None) for _ in range(4)] == draws
        with pytest.raises(ValueError):
            metrics.ExpService(0.0)


class TestPureHelpers:
    def test_time_weighted_mean(self):
        for args in (([0, 1, 3], [2, 4, 8], 0, 4), ([], [], 0, 1), ([0.0], [5.0], 2.0, 1.0),
                     ([0, 1, 2], [3, 3, 3], 0.5, 1.7)):
            assert metrics.time_weighted_mean(*args) == ref_metrics.time_weighted_mean(*args)
        assert metrics.time_weighted_mean([0, 1, 3], [2, 4, 8], 0, 4) == 4.5
        assert metrics.time_weighted_mean([], [], 0, 1) is None

    def test_schema_guards(self):
        for fn in (summarize, chrome_trace):
            with pytest.raises(ValueError):
                fn({"schema": 99})

    def test_exports_equal_reference(self):
        assert set(telemetry.__all__) == set(ref_tel.__all__)
