"""The port's simulator core (`repro_torch.core`, `control.arrivals`,
`telemetry.{profile,recorder}`) against the reference's on the same inputs.

The copies are plain numpy and keep the reference's draw order and float
summation order, so the bar is equality: `SimResult`s field by field with
`==` on floats (NaN equal to NaN, `np.testing.assert_equal`), the same
completion times and drops, the same channel trajectories, and the
latency model's values exactly. Queueing is held to 1e-12 (absolute and
relative), apart from `exp_sum_cdf`, which the port clamps to [0, 1]:
equal (==) to the reference wherever the reference lies in [0, 1], and 0
where the reference cancels to -2.2e-16. Then the measured service
(`serving.calibrate.MeasuredService`) on the CPU smoke llama2-7b through the
port's `simulate`, and `launch.capacity` (Fig. 6) against
`benchmarks/fig6_capacity.py`.
"""

import dataclasses
import importlib.util
import math
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.control import MMPP as RefMMPP  # noqa: E402
from repro.control import FlashCrowd as RefFlashCrowd  # noqa: E402
from repro.core import capacity as ref_capacity  # noqa: E402
from repro.core import channel as ref_channel  # noqa: E402
from repro.core import latency_model as ref_lm  # noqa: E402
from repro.core import queueing as ref_q  # noqa: E402
from repro.core import scheduler as ref_sched  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.faults import FaultSpec, NodeOutage  # noqa: E402
from repro.telemetry import EventRecorder as RefRecorder  # noqa: E402
from repro.telemetry import PhaseProfiler as RefProfiler  # noqa: E402
from repro_torch.control import MMPP, FlashCrowd  # noqa: E402
from repro_torch.core import capacity, channel, latency_model, queueing, scheduler, simulator  # noqa: E402
from repro_torch.telemetry import EventRecorder, PhaseProfiler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QUEUE_TOL = 1e-12
SVC = latency_model.ModelService(latency_model.GH200_NVL2.scaled(2), latency_model.LLAMA2_7B)
REF_SVC = ref_lm.ModelService(ref_lm.GH200_NVL2.scaled(2), ref_lm.LLAMA2_7B)
# 62 UEs at 1 prompt/s against the paper's 11.43 ms node: near every
# scheme's capacity, so drops, tails and the disjoint sub-budgets all show
BASE = dict(n_ues=62, sim_time=2.0, warmup=0.5)


def as_dict(res):
    d = dataclasses.asdict(res)
    d.pop("profile")  # host wall-clock: differs run to run by design
    return d


def assert_same(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    np.testing.assert_equal(as_dict(ours), as_dict(theirs))


def both(scheme, sim_kw, ref_sim_kw=None, traced=None, **kw):
    """(port result, reference result) of one simulate call; `traced`
    ("recorder" or "profiler") gives each side its own package's object."""
    make = {"recorder": (EventRecorder, RefRecorder), "profiler": (PhaseProfiler, RefProfiler)}
    ours_kw, ref_kw = dict(kw), dict(kw)
    if traced:
        ours_kw[traced], ref_kw[traced] = make[traced][0](), make[traced][1]()
    ours = simulator.simulate(simulator.SCHEMES[scheme], simulator.SimConfig(**sim_kw),
                              SVC, **ours_kw)
    theirs = ref_sim.simulate(ref_sim.SCHEMES[scheme],
                              ref_sim.SimConfig(**dict(sim_kw, **(ref_sim_kw or {}))),
                              REF_SVC, **ref_kw)
    return ours, theirs


class TestSimulate:
    @pytest.mark.parametrize("seed", [0, 7])
    @pytest.mark.parametrize("fast", [True, False])
    @pytest.mark.parametrize("scheme", sorted(simulator.SCHEMES))
    def test_equals_reference(self, scheme, fast, seed):
        ours, theirs = both(scheme, dict(BASE, seed=seed), fast=fast)
        assert ours.n_jobs > 0 and 0.0 < ours.satisfaction <= 1.0
        assert_same(ours, theirs)

    @pytest.mark.parametrize("arrivals", ["flash_crowd", "mmpp"])
    def test_arrival_process_and_windows(self, arrivals):
        if arrivals == "flash_crowd":
            ours_a, ref_a = FlashCrowd(1.0, 3.0, 0.8, 1.4), RefFlashCrowd(1.0, 3.0, 0.8, 1.4)
        else:
            ours_a = MMPP(3.0, 0.2, mean_on_s=0.3, mean_off_s=0.4, salt=5)
            ref_a = RefMMPP(3.0, 0.2, mean_on_s=0.3, mean_off_s=0.4, salt=5)
        kw = dict(BASE, n_ues=40, seed=3, window_s=0.25)
        ours, theirs = both("icc", dict(kw, arrivals=ours_a), dict(arrivals=ref_a))
        assert ours.windows and len(ours.windows) == 6
        assert_same(ours, theirs)

    def test_recorder_telemetry_equals_reference(self):
        ours, theirs = both("disjoint_mec", dict(BASE, seed=1), traced="recorder")
        assert_same(ours, theirs)
        assert ours.telemetry["jobs"]["uid"]
        untraced = simulator.simulate(simulator.SCHEMES["disjoint_mec"],
                                      simulator.SimConfig(**BASE, seed=1), SVC)
        np.testing.assert_equal(dict(as_dict(ours), telemetry=None), as_dict(untraced))
        with pytest.raises(NotImplementedError, match="telemetry/metrics.py"):
            EventRecorder().to_metrics()

    def test_profiler_leaves_the_result_alone(self):
        ours, theirs = both("icc", dict(BASE, seed=2), traced="profiler")
        assert_same(ours, theirs)
        assert ours.profile["counters"] == theirs.profile["counters"]
        assert set(ours.profile["phases"]) == set(theirs.profile["phases"])

    def test_controller_and_faults_raise(self):
        sim = simulator.SimConfig(**BASE)
        with pytest.raises(NotImplementedError, match="control"):
            simulator.simulate(simulator.SCHEMES["icc"], sim, SVC, controller="reactive")
        with pytest.raises(NotImplementedError, match="faults"):
            simulator.simulate(simulator.SCHEMES["icc"], sim, SVC,
                               faults=FaultSpec(node_outages=(NodeOutage("node", 0.5, 1.0),)))
        # an empty spec is free, as in the reference
        assert_same(simulator.simulate(simulator.SCHEMES["icc"], sim, SVC, faults=FaultSpec()),
                    simulator.simulate(simulator.SCHEMES["icc"], sim, SVC))


def job_list(mod, n=60, seed=4):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.008, n))
    jobs = []
    for i in range(n):
        j = mod.Job(i, i % 7, float(t[i]), int(rng.integers(5, 40)),
                    int(rng.integers(5, 40)), 0.08)
        j.t_compute_arrival = float(t[i] + rng.uniform(0.005, 0.03))
        jobs.append(j)
    return jobs


@pytest.mark.parametrize("comp_budget", [None, 0.056])
@pytest.mark.parametrize("policy", ["fifo", "priority"])
def test_compute_node_equals_reference(policy, comp_budget):
    """The same seeded jobs through both nodes, with a crash halfway: the
    same completion times, drops and crash victims."""
    out = []
    for mod, svc in ((scheduler, SVC), (ref_sched, REF_SVC)):
        node = mod.ComputeNode(svc, policy=policy, drop_infeasible=True,
                               comp_budget=comp_budget)
        jobs = job_list(mod)
        for j in sorted(jobs, key=lambda j: j.t_compute_arrival):
            node.run_until(j.t_compute_arrival)
            node.submit(j)
            if j.uid == 30:
                crashed = [c.uid for c in node.crash(j.t_compute_arrival, j.t_compute_arrival + 0.05)]
        node.run_until(math.inf)
        out.append(([(j.uid, j.t_complete, j.dropped, j.drop_reason) for j in jobs],
                    crashed, node.busy_until))
    np.testing.assert_equal(out[0], out[1])
    assert any(d for _, _, d, _ in out[0][0]) and out[0][1]


def test_uplink_channel_equals_reference():
    trace = []
    for mod in (channel, ref_channel):
        cfg = mod.ChannelConfig()
        ch = mod.UplinkChannel(cfg, 12, np.random.default_rng(4))
        bits, now, rows = 15 * cfg.bytes_per_token * 8.0, 0.0, []
        for s in range(600):
            ch.add_background(now)
            if s % 23 == 0:
                ch.add_job_bits(s % 12, bits, now)
            if s % 2:
                rows.append(ch.step(now, prioritize_jobs=s % 3 == 0).tolist())
            else:
                rows.append(ch.step_drain(now, prioritize_jobs=s % 3 == 0))
            now += cfg.slot_s
        trace.append((rows, list(ch.job_bits), list(ch.bg_bits), ch.full_carrier_bits_per_slot))
    np.testing.assert_equal(trace[0], trace[1])


HARDWARE = ["TPU_V5E", "A100", "GH200_NVL2", "H100", "L4", "GH200_NVL2 x2"]


def hardware(mod, name):
    """A preset of `mod`, or `name x n`: the preset scaled to n devices."""
    base, _, n = name.partition(" x")
    hw = getattr(mod, base)
    return hw.scaled(int(n)) if n else hw


@pytest.mark.parametrize("fidelity", ["paper", "extended"])
@pytest.mark.parametrize("hw", HARDWARE)
def test_latency_model_equals_reference(hw, fidelity):
    ours = latency_model.LatencyModel(hardware(latency_model, hw), latency_model.LLAMA2_7B,
                                      fidelity=fidelity)
    theirs = ref_lm.LatencyModel(hardware(ref_lm, hw), ref_lm.LLAMA2_7B, fidelity=fidelity)
    for n_in, n_out, batch in ((15, 15, 1), (1, 1, 1), (512, 64, 4), (128, 7, 8)):
        assert ours.job_latency(n_in, n_out, batch) == theirs.job_latency(n_in, n_out, batch)
    assert ours.iteration_latency(64, 8, 900.0) == theirs.iteration_latency(64, 8, 900.0)
    assert dataclasses.asdict(hardware(latency_model, hw)) == \
        dataclasses.asdict(hardware(ref_lm, hw))


class TestQueueing:
    LAMS = np.linspace(1.0, 99.0, 25)

    @pytest.mark.parametrize("scheme", ["joint_ran", "disjoint_ran", "disjoint_mec"])
    def test_fig4_satisfaction_and_capacity(self, scheme):
        sys_o, fn_o = queueing.paper_fig4_setup()[scheme]
        sys_r, fn_r = ref_q.paper_fig4_setup()[scheme]
        for lam in self.LAMS:
            assert fn_o(lam) == pytest.approx(fn_r(lam), rel=QUEUE_TOL, abs=QUEUE_TOL)
            for stage in ("comm", "comp", "e2e"):
                assert queueing.sojourn_cdf(sys_o, lam, stage, 0.05) == pytest.approx(
                    ref_q.sojourn_cdf(sys_r, lam, stage, 0.05), rel=QUEUE_TOL, abs=QUEUE_TOL)
        assert queueing.service_capacity(fn_o, sys_o.mu2) == pytest.approx(
            ref_q.service_capacity(fn_r, sys_r.mu2), rel=QUEUE_TOL, abs=QUEUE_TOL)

    def test_exp_sum_cdf_cancellation_case_is_zero(self):
        assert ref_q.exp_sum_cdf(5.0, 8.5, 2.2e-16) < 0.0  # the reference's fault
        assert queueing.exp_sum_cdf(5.0, 8.5, 2.2e-16) == 0.0


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # some containers lack hypothesis: that one test skips
    given = None

if given is not None:
    rates = st.floats(1e-3, 1e4, allow_nan=False)

    @settings(max_examples=300, deadline=None)
    @given(rates, rates, st.one_of(st.floats(0.0, 1e-12), st.floats(0.0, 50.0)))
    def test_exp_sum_cdf_is_a_probability_and_equals_reference(a, b, t):
        p = queueing.exp_sum_cdf(a, b, t)
        assert 0.0 <= p <= 1.0
        r = ref_q.exp_sum_cdf(a, b, t)
        if 0.0 <= r <= 1.0:
            assert p == r
else:
    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_exp_sum_cdf_is_a_probability_and_equals_reference():
        pass


class TestSweep:
    RATES = [20, 60, 90]

    def test_sweep_and_capacity_equal_reference(self):
        for name in ("icc", "disjoint_mec"):
            base = simulator.SimConfig(sim_time=1.5, warmup=0.5)
            ours = capacity.sweep(simulator.SCHEMES[name], base, self.RATES, SVC, n_seeds=2)
            theirs = ref_capacity.sweep(ref_sim.SCHEMES[name],
                                        ref_sim.SimConfig(sim_time=1.5, warmup=0.5),
                                        self.RATES, REF_SVC, n_seeds=2)
            for o, t in zip(ours, theirs):
                assert_same(o, t)
            assert capacity.capacity_from_sweep(self.RATES, ours) == \
                ref_capacity.capacity_from_sweep(self.RATES, theirs)

    def test_run_grid_with_workers_equals_serial(self):
        import functools

        base = simulator.SimConfig(sim_time=1.0, warmup=0.25)
        run_one = functools.partial(capacity._sim_point, simulator.SCHEMES["icc"], base, SVC)
        serial = capacity.run_grid([10, 40], run_one, n_seeds=2, workers=0)
        pooled = capacity.run_grid([10, 40], run_one, n_seeds=2, workers=2)
        for gs, gp in zip(serial, pooled):
            for s, p in zip(gs, gp):
                assert_same(s, p)


def smoke_llama():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama2-7b", smoke=True), dtype="float32")
    model = build_model(cfg)
    return model, model.init(seed=0, device="cpu")


class TestMeasuredService:
    def test_measured_service_drives_simulate(self):
        from repro_torch.serving import MeasuredService, measured_service_fn

        model, params = smoke_llama()
        svc, t = measured_service_fn(model, params, 15, 15, max_seq=32, repeats=1)
        assert isinstance(svc, MeasuredService)
        job = scheduler.Job(0, 0, 0.0, 15, 15, 0.08)
        assert svc(job) == pytest.approx(t["prefill_s"] + t["decode_s"], rel=1e-12)
        assert pickle.loads(pickle.dumps(svc)) == svc
        # the CPU's service time varies with the machine's load: offer 80%
        # of what the node serves, with a budget and a scored span (from
        # the warmup to sim_time - 2 b_total) in units of the service time
        s = svc(job)
        sim = simulator.SimConfig(n_ues=4, lam_per_ue=0.2 / s, b_total=5 * s, warmup=0.5,
                                  sim_time=0.5 + 10 * s + 40 * s)
        res = simulator.simulate(simulator.SCHEMES["icc"], sim, svc)
        assert res.n_jobs > 0 and 0.0 <= res.satisfaction <= 1.0
        assert res.drop_rate < 1.0 and math.isfinite(res.avg_comp)

    def test_capacity_cli_measured_on_cpu(self, tmp_path):
        from repro_torch.launch import capacity as cli

        out = cli.main(["--service", "measured", "--device", "cpu", "--rates", "2", "4",
                        "--sim-time", "5", "--seeds", "1", "--budget", "scaled",
                        "--out", str(tmp_path / "cap.json")])
        assert (tmp_path / "cap.json").is_file()
        assert out["calibration"]["total_s"] > 0 and out["card"] is None
        assert out["k"] == pytest.approx(out["service_ms"] / 11.43, rel=1e-3)
        for s in out["schemes"].values():
            assert all(n > 0 for n in s["n_jobs"])
            assert all(0.0 <= x <= 1.0 for x in s["satisfaction"])
            assert 0.0 <= s["capacity"] <= 4.0

    def test_capacity_cli_paper_equals_fig6(self, tmp_path):
        """`launch.capacity` on the paper's service and budget gives the
        numbers of benchmarks/fig6_capacity.py."""
        from repro_torch.launch import capacity as cli

        spec = importlib.util.spec_from_file_location(
            "fig6_capacity", ROOT / "benchmarks" / "fig6_capacity.py")
        fig6 = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fig6)
        rates = [30, 60, 90]
        theirs = fig6.run(out_dir=str(tmp_path), rates=rates, sim_time=3.0, n_seeds=1)
        ours = cli.run(cli.PAPER_SERVICE, rates, sim_time=3.0, n_seeds=1, log=lambda s: None)
        assert ours["schemes"]["disjoint_mec"]["capacity"] > 0
        for name, t in theirs["schemes"].items():
            for key in ("satisfaction", "avg_comm_ms", "avg_comp_ms", "capacity"):
                np.testing.assert_equal(ours["schemes"][name][key], t[key])
        assert ours["gain_icc_vs_mec"] == theirs["gain_icc_vs_mec"]


def test_scaled_budget_multiplies_all_three():
    """`run` under --budget scaled multiplies b_total, b_comm and b_comp by
    k = service / the paper's, and lengthens sim_time by 2 (k - 1) b_total;
    the paper budget leaves all of them as they are."""
    from repro_torch.launch import capacity as cli

    def svc(job):
        return 2.5 * cli.PAPER_SERVICE(job)

    quiet = dict(rates=[30], sim_time=3.0, n_seeds=2, log=lambda s: None)
    scaled = cli.run(svc, budget="scaled", **quiet)
    paper = cli.run(svc, budget="paper", **quiet)
    assert scaled["k"] == pytest.approx(2.5) and paper["k"] == 1.0
    assert scaled["b_total_ms"] == pytest.approx(200.0) and paper["b_total_ms"] == 80.0
    assert scaled["sim_time"] == pytest.approx(3.0 + 2 * 1.5 * 0.08) and paper["sim_time"] == 3.0
    for name, ref in simulator.SCHEMES.items():
        s, p = scaled["schemes"][name], paper["schemes"][name]
        assert (s["b_comm_ms"], s["b_comp_ms"]) == pytest.approx(
            (2.5e3 * ref.b_comm, 2.5e3 * ref.b_comp))
        assert (p["b_comm_ms"], p["b_comp_ms"]) == (ref.b_comm * 1e3, ref.b_comp * 1e3)
        for r in (s, p):
            assert len(r["satisfaction_sd"]) == len(r["n_jobs"]) == 1
            assert 0.0 <= r["satisfaction_sd"][0] <= 0.5
    assert cli.default_rates(0.0114)[-1] >= 1 / 0.0114
    assert cli.default_rates(0.1926) == [1, 2, 3, 4, 5, 6, 7]
