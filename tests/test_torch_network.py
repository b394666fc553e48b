"""The port's multi-cell network (`repro_torch.network` and
`core.capacity.network_point`) against the reference's `repro.network` on
fixed seeds: the counterparts of tests/test_network.py, with the network
cases of tests/test_faults.py and tests/test_control.py. The copies are
plain numpy and keep the reference's draw order, so the bar is equality:
`NetResult`s field by field (less the host wall-clock `profile`).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import control as ref_control  # noqa: E402
from repro import network as ref_net  # noqa: E402
from repro.core import capacity as ref_capacity  # noqa: E402
from repro.core.scheduler import Job as RefJob  # noqa: E402
from repro.telemetry import EventRecorder as RefRecorder  # noqa: E402
from repro_torch import network as net  # noqa: E402
from repro_torch.control import MobilityConfig, get_controller  # noqa: E402
from repro_torch.core import capacity  # noqa: E402
from repro_torch.core.scheduler import Job  # noqa: E402
from repro_torch.faults import Brownout, FaultSpec, LinkOutage, NodeOutage  # noqa: E402
from repro_torch.network import (GPU_SPECS, POLICIES, SCENARIOS, NetSimConfig,  # noqa: E402
                                 SiteConfig, Topology, TopologyConfig, get_policy,
                                 get_scenario, list_scenarios, register_scenario,
                                 simulate_network, three_cell_hetero)
from repro_torch.network.fleet import build_fleet_node  # noqa: E402
from repro_torch.network.simulator import config_for_load  # noqa: E402
from repro_torch.telemetry import EventRecorder  # noqa: E402
from test_torch_faults import to_ref  # noqa: E402

# 150 jobs/s on three_cell_hetero: past local_only's, mec_only's and
# least_loaded's capacity and at slack_aware's, so every policy routes,
# queues and drops (BENCH_network.json)
LOAD = dict(load=150.0, sim_time=1.5, warmup=0.3, seed=2)
# the slot-by-slot engine (fast=False) steps every slot of every cell: a
# shorter run, the faults and controller epochs still inside it
SLOW = dict(sim_time=1.0, warmup=0.2)
FS_CRASH = FaultSpec(node_outages=(NodeOutage("mec", 0.5, 0.8),))
FS_LINK = FaultSpec(link_outages=(LinkOutage(0.4, 0.7, node="mec"),
                                  LinkOutage(0.3, 0.9, site=1, down=False, latency_factor=3.0)))
FS_BOTH = FaultSpec(link_outages=(LinkOutage(0.4, 0.7, node="mec"),),
                    node_outages=(NodeOutage("ran:cell0", 0.5, 0.8),))


def tiny_topology(pkg=net, **kw):
    """Two small cells (fast H100 / slow L4) + MEC, built from `pkg`."""
    return pkg.TopologyConfig(sites=(pkg.SiteConfig("a", n_ues=8, ran_gpu="h100"),
                                     pkg.SiteConfig("b", n_ues=8, ran_gpu="l4")), **kw)


def make_job(uid=0, t_gen=0.0, n_input=15, n_output=15, b_total=0.080, cls=Job):
    j = cls(uid=uid, ue=0, t_gen=t_gen, n_input=n_input, n_output=n_output, b_total=b_total)
    j.t_compute_arrival = t_gen + 0.005
    return j


def configs(load, scenario="ar_translation", mobility=None, faults=None, **kw):
    """(port config, reference config) of `config_for_load` on
    three_cell_hetero; `mobility` is MobilityConfig's fields."""
    ours = config_for_load(three_cell_hetero(), SCENARIOS[scenario], load,
                           mobility=MobilityConfig(**mobility) if mobility else None,
                           faults=faults, **kw)
    theirs = ref_net.config_for_load(
        ref_net.three_cell_hetero(), ref_net.SCENARIOS[scenario], load,
        mobility=ref_control.MobilityConfig(**mobility) if mobility else None,
        faults=None if faults is None else to_ref(faults), **kw)
    return ours, theirs


def both(policy="slack_aware", fast=True, traced=False, **kw):
    """(port NetResult, reference NetResult) of one run."""
    ours_cfg, ref_cfg = configs(**dict(LOAD, **kw))
    ours = simulate_network(ours_cfg, policy, fast=fast,
                            recorder=EventRecorder() if traced else None)
    theirs = ref_net.simulate_network(ref_cfg, policy, fast=fast,
                                      recorder=RefRecorder() if traced else None)
    return ours, theirs


def as_dict(res):
    d = dataclasses.asdict(res)
    for r in [d["total"], *d["per_cell"].values()]:
        r.pop("profile")  # host wall-clock: differs run to run by design
    return d


def assert_same(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__ == "NetResult"
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    np.testing.assert_equal(as_dict(ours), as_dict(theirs))


# ------------------------------------------------------------ registries
class TestScenarios:
    def test_registry_equals_reference(self):
        assert list_scenarios() == ref_net.list_scenarios()
        for name in SCENARIOS:
            ours, theirs = dataclasses.asdict(SCENARIOS[name]), \
                dataclasses.asdict(ref_net.SCENARIOS[name])
            assert {k: v for k, v in ours.items() if k != "arrival"} == \
                {k: v for k, v in theirs.items() if k != "arrival"}
            assert (ours["arrival"] is None) == (theirs["arrival"] is None)
            if ours["arrival"] is not None:
                assert type(SCENARIOS[name].arrival).__name__ == \
                    type(ref_net.SCENARIOS[name].arrival).__name__
                assert ours["arrival"] == theirs["arrival"]

    def test_table_i_values(self):
        sc = get_scenario("ar_translation")
        assert (sc.n_input, sc.n_output, sc.b_total) == (15, 15, 0.080)

    def test_unknown_scenario_raises(self):
        with pytest.raises(KeyError, match="unknown scenario"):
            get_scenario("nope")

    def test_register_is_the_ports_own(self):
        """The port keeps a registry of its own: registering in it leaves
        the reference's untouched, and a duplicate name raises."""
        sc = dataclasses.replace(SCENARIOS["chatbot"], name="test_only_chat")
        try:
            register_scenario(sc)
            assert get_scenario("test_only_chat") is sc
            assert "test_only_chat" not in ref_net.SCENARIOS
            with pytest.raises(ValueError, match="already registered"):
                register_scenario(sc)
            assert register_scenario(sc, replace=True) is sc
            with pytest.raises(TypeError):
                register_scenario("chatbot")
        finally:
            SCENARIOS.pop("test_only_chat", None)
        assert list_scenarios() == ref_net.list_scenarios()


class TestGpuSpecs:
    def test_registry_equals_reference(self):
        assert sorted(GPU_SPECS) == sorted(ref_net.GPU_SPECS)
        for name, spec in GPU_SPECS.items():
            assert spec.name == name
            assert dataclasses.asdict(spec) == dataclasses.asdict(ref_net.GPU_SPECS[name])


# -------------------------------------------------------------- topology
class TestTopology:
    def test_fleet_build(self):
        topo = Topology(three_cell_hetero())
        assert set(topo.nodes) == {"mec", "ran:cell0", "ran:cell1"}
        assert topo.ran_of == ["ran:cell0", "ran:cell1", None]
        assert topo.local_node(2) == "mec"

    @pytest.mark.parametrize("node_kind", ["classic", "batched"])
    def test_service_times_equal_reference(self, node_kind):
        ours = Topology(tiny_topology(), node_kind=node_kind, max_batch=4)
        theirs = ref_net.Topology(tiny_topology(ref_net), node_kind=node_kind, max_batch=4)
        assert list(ours.nodes) == list(theirs.nodes)
        for name, fn in ours.nodes.items():
            for n_in, n_out in ((15, 15), (512, 64)):
                job = make_job(n_input=n_in, n_output=n_out)
                assert fn.service_time(job) == theirs.nodes[name].service_time(
                    make_job(n_input=n_in, n_output=n_out, cls=RefJob))
            assert fn.lm.fidelity == ("extended" if node_kind == "batched" else "paper")
        # L4 is an order of magnitude behind H100
        assert ours.nodes["ran:b"].service_time(make_job()) > \
            5 * ours.nodes["ran:a"].service_time(make_job())

    def test_candidates_and_wireline(self):
        cfg = tiny_topology(t_inter_site=0.012)
        topo = Topology(cfg)
        assert topo.candidates(0) == ["ran:a", "ran:b", "mec"]
        assert topo.candidates(1) == ["ran:b", "ran:a", "mec"]
        assert topo.wireline_latency(0, "ran:a") == cfg.sites[0].t_fronthaul
        assert topo.wireline_latency(0, "mec") == cfg.sites[0].t_backhaul_mec
        assert topo.wireline_latency(0, "ran:b") == 0.012

    def test_duplicate_site_names_rejected(self):
        cfg = TopologyConfig(sites=(SiteConfig("a", n_ues=4), SiteConfig("a", n_ues=4)))
        with pytest.raises(ValueError, match="unique"):
            Topology(cfg)

    def test_in_transit_commitments(self):
        fn = Topology(tiny_topology()).nodes["ran:a"]
        job = make_job()
        idle_finish = fn.predict_finish(job, 0.005, 0.0)
        fn.commit(job)
        assert fn.in_transit == 1
        assert fn.predict_finish(job, 0.005, 0.0) > idle_finish
        fn.settle(job)
        assert fn.in_transit == 0 and fn.in_transit_s == 0.0
        assert fn.predict_finish(job, 0.005, 0.0) == idle_finish

    @pytest.mark.parametrize("sizes,total", [((20, 20, 20), 90), ((20, 20, 20), 2),
                                             ((98, 1, 1), 37), ((0, 0, 0), 10)])
    def test_scaled_ues_equals_reference(self, sizes, total):
        mk = lambda pkg: pkg.TopologyConfig(sites=tuple(  # noqa: E731
            pkg.SiteConfig(f"s{i}", n_ues=n) for i, n in enumerate(sizes)))
        ours = [s.n_ues for s in mk(net).scaled_ues(total).sites]
        assert ours == [s.n_ues for s in mk(ref_net).scaled_ues(total).sites]
        assert sum(ours) == max(total, len(sizes)) and min(ours) >= 1

    def test_unknown_node_kind_rejected(self):
        with pytest.raises(ValueError, match="node_kind"):
            build_fleet_node("x", "ran", "h100", node_kind="nope")


# --------------------------------------------------------------- routing
class TestRouting:
    def test_registry(self):
        assert set(POLICIES) == set(ref_net.POLICIES) == {
            "local_only", "mec_only", "least_loaded", "slack_aware", "controlled"}

    def test_unknown_policy_raises(self):
        with pytest.raises(KeyError, match="unknown routing policy"):
            get_policy("nope")

    @pytest.mark.parametrize("policy", sorted(POLICIES))
    def test_route_equals_reference_under_load(self, policy):
        """A backlog on site a's node: each policy names the node the
        reference's names, for jobs from both sites."""
        picks = []
        for pkg, job in ((net, make_job), (ref_net, lambda **k: make_job(cls=RefJob, **k))):
            topo = pkg.Topology(tiny_topology(pkg))
            topo.nodes["ran:a"].node.busy_until = 1.0
            for i in range(3):
                topo.nodes["ran:a"].node.submit(job(uid=i))
            pol = pkg.get_policy(policy).bind(topo)
            picks.append([pol.route(job(uid=9, t_gen=t), site, t)
                          for site in (0, 1) for t in (0.0, 0.5, 1.2)])
        assert picks[0] == picks[1]

    def test_slack_aware_offloads_overloaded_local(self):
        topo = Topology(tiny_topology())
        pol = get_policy("slack_aware").bind(topo)
        assert pol.route(make_job(), 0, 0.0) == "ran:a"
        topo.nodes["ran:a"].node.busy_until = 1.0
        assert pol.route(make_job(), 0, 0.0) == "mec"


# ------------------------------------------------------------ simulation
class TestSimulateNetwork:
    @pytest.mark.parametrize("node_kind", ["classic", "batched"])
    @pytest.mark.parametrize("policy", sorted(POLICIES))
    def test_equals_reference(self, policy, node_kind):
        ours, theirs = both(policy, node_kind=node_kind, max_batch=4)
        assert ours.n_jobs > 0 and 0.0 < ours.satisfaction <= 1.0
        assert abs(sum(ours.route_share.values()) - 1.0) < 1e-9
        assert_same(ours, theirs)
        if node_kind == "batched":  # token-granular nodes report TTFT/TBT
            assert ours.total.avg_ttft is not None and ours.total.avg_tbt is not None

    @pytest.mark.parametrize("node_kind", ["classic", "batched"])
    def test_slow_engine_equals_reference_and_fast(self, node_kind):
        ours, theirs = both("slack_aware", fast=False, node_kind=node_kind, **SLOW)
        assert_same(ours, theirs)
        assert_same(ours, both("slack_aware", fast=True, node_kind=node_kind, **SLOW)[0])

    def test_recorder_telemetry_equals_reference(self):
        ours, theirs = both("slack_aware", traced=True)
        assert_same(ours, theirs)
        tel = ours.total.telemetry
        assert tel["meta"]["kind"] == "network" and tel["counts"]["jobs"] >= ours.n_jobs > 0

    def test_deterministic_and_policy_shapes(self):
        a, b = both("mec_only")[0], both("mec_only")[0]
        assert_same(a, b)
        assert a.route_share == {"mec": 1.0}

    def test_mismatched_slots_rejected(self):
        site = tiny_topology().sites[0]
        site = dataclasses.replace(site, channel=dataclasses.replace(site.channel, scs_hz=30e3))
        cfg = NetSimConfig(topology=TopologyConfig(sites=(site, tiny_topology().sites[1])),
                           sim_time=1.0, warmup=0.2)
        with pytest.raises(ValueError, match="slot duration"):
            simulate_network(cfg, "mec_only")

    def test_network_point_equals_reference(self):
        ours = capacity.network_point(three_cell_hetero(), SCENARIOS["ar_translation"],
                                      "slack_aware", 2.0, 0.5, 0, True, 120.0, 1)
        theirs = ref_capacity.network_point(ref_net.three_cell_hetero(),
                                            ref_net.SCENARIOS["ar_translation"], "slack_aware",
                                            2.0, 0.5, 0, True, 120.0, 1)
        assert_same(ours, theirs)

    def test_slack_aware_dominates_on_hetero_fleet(self):
        """The acceptance comparison of the reference at test scale, on the
        port's `network_point` and `capacity_from_sweep`."""
        rates = [40.0, 80.0, 120.0]
        caps = {}
        for policy in ("local_only", "mec_only", "slack_aware"):
            curve = [capacity.network_point(three_cell_hetero(), SCENARIOS["ar_translation"],
                                            policy, 2.0, 0.5, 0, True, lam, 0).satisfaction
                     for lam in rates]
            caps[policy] = capacity.capacity_from_sweep(rates, curve)
        assert caps["slack_aware"] >= caps["local_only"]
        assert caps["slack_aware"] >= caps["mec_only"]


# ---------------------------------------------------------------- faults
class TestNetworkFaults:
    @pytest.mark.parametrize("node_kind", ["classic", "batched"])
    @pytest.mark.parametrize("name,policy,fast", [
        ("crash", "slack_aware", True), ("crash", "mec_only", True), ("link", "mec_only", True),
        ("link", "slack_aware", True), ("both", "slack_aware", True),
        ("both", "slack_aware", False), ("link", "mec_only", False)])
    def test_equals_reference(self, name, policy, fast, node_kind):
        spec = {"crash": FS_CRASH, "link": FS_LINK, "both": FS_BOTH}[name]
        ours, theirs = both(policy, fast=fast, node_kind=node_kind, faults=spec,
                            **({} if fast else SLOW))
        assert_same(ours, theirs)
        if name != "link":
            assert ours.n_node_failures == 1

    @pytest.mark.parametrize("node_kind", ["classic", "batched"])
    def test_empty_spec_is_free(self, node_kind):
        off = both("slack_aware", node_kind=node_kind)[0]
        assert_same(both("slack_aware", node_kind=node_kind, faults=FaultSpec())[0], off)

    def test_redispatch_off_drops_instead(self):
        ours, theirs = both("mec_only", faults=dataclasses.replace(FS_CRASH, redispatch=False))
        assert_same(ours, theirs)
        assert ours.n_fault_drops > 0 and ours.n_redispatched == 0
        assert (ours.total.drop_reasons or {}).get("node_failure", 0) == ours.n_fault_drops

    def test_redispatch_on_reroutes(self):
        ours, theirs = both("slack_aware", faults=FS_BOTH, traced=True)
        assert_same(ours, theirs)
        assert ours.n_redispatched > 0 and ours.n_fault_drops == 0
        assert ours.total.telemetry["counts"]["faults"] > 0

    def test_brownout_on_the_network_equals_reference(self):
        spec = FaultSpec(brownouts=(Brownout("ran:cell0", 0.4, 1.2, 3.0),))
        assert_same(*both("slack_aware", node_kind="batched", faults=spec))


# ------------------------------------------------------------- control
class TestNetworkControl:
    @pytest.mark.parametrize("preset,policy", [("static", "slack_aware"),
                                               ("reactive", "slack_aware"),
                                               ("slack_aware_joint", "controlled")])
    def test_flash_crowd_equals_reference(self, preset, policy):
        """Each preset on a flash crowd, under the policy BENCH_control.json
        gives it (the uplink congests, so the reactive and joint presets
        act), windows on."""
        ours, theirs = both(policy, load=40.0, scenario="flash_crowd", sim_time=5.0, warmup=1.0,
                            controller=preset, window_s=0.5)
        assert_same(ours, theirs)
        assert ours.controller == preset and ours.n_epochs > 0
        if preset == "slack_aware_joint":
            assert ours.n_rejected > 0

    @pytest.mark.parametrize("fast", [True, False])
    def test_static_is_a_noop(self, fast):
        kw = {} if fast else SLOW
        plain = both("slack_aware", fast=fast, **kw)[0]
        static = both("slack_aware", fast=fast, controller="static", **kw)[0]
        np.testing.assert_equal(as_dict(plain)["total"], as_dict(static)["total"])
        assert plain.route_share == static.route_share
        assert static.n_epochs > 0 and static.n_rejected == 0

    def test_controlled_unbound_equals_slack_aware(self):
        a, b = both("slack_aware")[0], both("controlled")[0]
        assert a.satisfaction == b.satisfaction and a.route_share == b.route_share

    def test_epochs_fire_across_idle_fast_forward(self):
        cfg, _ = configs(3.0, sim_time=3.0, warmup=0.5, seed=1, controller="static")
        engines = []
        res = simulate_network(cfg, "slack_aware", _debug_engines=engines)
        eng = engines[0]
        assert eng.slots_skipped > 0
        epoch_slots = max(1, int(round(get_controller("static").epoch_s / eng.slot)))
        assert res.n_epochs == (eng.n_slots - 1) // epoch_slots

    @pytest.mark.parametrize("fast", [True, False])
    def test_mobility_equals_reference(self, fast):
        """Roamers on a flash crowd: handovers re-home in-flight uplink
        bursts, job for job as the reference does."""
        kw = dict(policy="slack_aware", fast=fast, load=30.0, scenario="flash_crowd",
                  sim_time=2.5, warmup=0.5, seed=4,
                  mobility=dict(n_roamers=6, dwell_mean_s=0.25))
        ours, theirs = both(**kw)
        assert_same(ours, theirs)
        assert ours.n_handovers > 0 and ours.n_rehomed > 0

    def test_mobility_with_the_joint_controller(self):
        ours, theirs = both("controlled", load=30.0, scenario="flash_crowd", sim_time=3.0,
                            warmup=0.5, seed=4, controller="slack_aware_joint",
                            mobility=dict(n_roamers=6, dwell_mean_s=0.25))
        assert_same(ours, theirs)
        assert ours.n_handovers > 0 and ours.n_epochs > 0

    def test_handover_conserves_jobs(self):
        cfg, _ = configs(30.0, scenario="flash_crowd", sim_time=3.0, warmup=0.5, seed=4,
                         mobility=dict(n_roamers=6, dwell_mean_s=0.25))
        engines = []
        simulate_network(cfg, "slack_aware", _debug_engines=engines)
        uids = [j.uid for e in engines for j in e.jobs]
        assert len(uids) == len(set(uids))
