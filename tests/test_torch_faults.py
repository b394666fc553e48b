"""The port's fault injection (`repro_torch.faults` and `simulate(faults=)`)
against the reference's `repro.faults` on fixed seeds: the single-cell part
of tests/test_faults.py. The copies are plain numpy and keep the reference's
draw order, so the bar is equality: the same schedules, and `SimResult`s
field by field. Link faults and the network-level cases are in
tests/test_torch_network.py.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import faults as ref_faults  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.experiments import get_experiment  # noqa: E402
from repro.telemetry import EventRecorder as RefRecorder  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.faults import (Brownout, FaultSpec, LinkOutage, NodeCrashProcess,  # noqa: E402
                                NodeOutage, bind_faults)
from repro_torch.faults.schedule import NODE_FAIL, NODE_RECOVER  # noqa: E402
from repro_torch.telemetry import EventRecorder  # noqa: E402
from test_torch_core import REF_SVC, SVC, assert_same  # noqa: E402

SLOT = 0.000125
# a crash window, a brownout, both, and a renewal crash process (nine
# crashes, most of them catching work) inside a 4 s run of 62 UEs, near the
# paper node's capacity
CRASH = FaultSpec(node_outages=(NodeOutage("node", 1.5, 2.5),))
BROWN = FaultSpec(brownouts=(Brownout("node", 1.0, 2.5, 2.0),))
BOTH = FaultSpec(node_outages=(NodeOutage("node", 1.2, 1.9),),
                 brownouts=(Brownout("node", 2.2, 3.1, 3.0),))
PROCESS = FaultSpec(crash_processes=(NodeCrashProcess("node", 0.6, 0.08, salt=2),), salt=1)
SPECS = {"crash": CRASH, "brownout": BROWN, "crash_and_brownout": BOTH,
         "crash_process": PROCESS}
SIM = dict(n_ues=62, sim_time=4.0, warmup=0.5, seed=3)


def to_ref(spec: FaultSpec):
    """The same spec built from the reference's classes."""
    return ref_faults.FaultSpec(
        node_outages=tuple(ref_faults.NodeOutage(**dataclasses.asdict(o))
                           for o in spec.node_outages),
        crash_processes=tuple(ref_faults.NodeCrashProcess(**dataclasses.asdict(c))
                              for c in spec.crash_processes),
        link_outages=tuple(ref_faults.LinkOutage(**dataclasses.asdict(x))
                           for x in spec.link_outages),
        brownouts=tuple(ref_faults.Brownout(**dataclasses.asdict(b)) for b in spec.brownouts),
        **{f: getattr(spec, f) for f in ("redispatch", "max_retries", "retry_backoff_s",
                                          "hysteresis_s", "salt")})


def both(spec, fast=True, traced=False, sim=SIM, scheme="icc"):
    """(port result, reference result) of one single-cell run under `spec`."""
    ours_kw = {"recorder": EventRecorder()} if traced else {}
    ref_kw = {"recorder": RefRecorder()} if traced else {}
    ours = simulator.simulate(simulator.SCHEMES[scheme], simulator.SimConfig(**sim), SVC,
                              faults=spec, fast=fast, **ours_kw)
    theirs = ref_sim.simulate(ref_sim.SCHEMES[scheme], ref_sim.SimConfig(**sim), REF_SVC,
                              faults=None if spec is None else to_ref(spec), fast=fast,
                              **ref_kw)
    return ours, theirs


# ---------------------------------------------------------------- spec
class TestFaultSpecValidation:
    def test_outage_window_ordering(self):
        with pytest.raises(ValueError):
            NodeOutage("mec", 3.0, 3.0)
        with pytest.raises(ValueError):
            NodeOutage("mec", -1.0, 2.0)

    def test_crash_process_params(self):
        with pytest.raises(ValueError):
            NodeCrashProcess("mec", mtbf_s=0.0, mttr_s=1.0)
        with pytest.raises(ValueError):
            NodeCrashProcess("mec", mtbf_s=1.0, mttr_s=0.0)

    def test_link_outage_params(self):
        with pytest.raises(ValueError):
            LinkOutage(2.0, 1.0)
        with pytest.raises(ValueError):
            LinkOutage(1.0, 2.0, down=False, latency_factor=0.5)
        with pytest.raises(ValueError):
            LinkOutage(1.0, 2.0, down=False, latency_add_s=-0.1)

    def test_brownout_params(self):
        with pytest.raises(ValueError):
            Brownout("mec", 1.0, 2.0, slow_factor=0.9)
        with pytest.raises(ValueError):
            Brownout("mec", 2.0, 1.0, slow_factor=2.0)

    def test_recovery_knobs(self):
        with pytest.raises(ValueError):
            FaultSpec(max_retries=-1)
        with pytest.raises(ValueError):
            FaultSpec(retry_backoff_s=-0.01)
        with pytest.raises(ValueError):
            FaultSpec(hysteresis_s=-1.0)

    def test_empty_property(self):
        assert FaultSpec().empty
        assert not CRASH.empty
        assert not BROWN.empty

    @pytest.mark.parametrize("name", ["NodeOutage", "NodeCrashProcess", "LinkOutage",
                                      "Brownout", "FaultSpec"])
    def test_fields_and_defaults_equal_reference(self, name):
        ours, theirs = getattr(faults, name), getattr(ref_faults, name)
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]


class TestFaultSpecCodec:
    def test_resilience_specs_round_trip_into_the_port(self):
        """Every arm of the reference's resilience experiment: its FaultSpec
        through JSON into the port's classes and back, field for field."""
        arms = get_experiment("resilience").resolve_arms()
        specs = [a.faults for a in arms if a.faults is not None]
        assert any(not s.empty for s in specs)
        for ref_spec in specs:
            d = json.loads(json.dumps(dataclasses.asdict(ref_spec)))
            ours = FaultSpec(
                node_outages=[NodeOutage(**o) for o in d["node_outages"]],
                crash_processes=[NodeCrashProcess(**c) for c in d["crash_processes"]],
                link_outages=[LinkOutage(**x) for x in d["link_outages"]],
                brownouts=[Brownout(**b) for b in d["brownouts"]],
                **{k: v for k, v in d.items() if not isinstance(v, list)})
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref_spec)
            assert to_ref(ours) == ref_spec
            assert ours.empty == ref_spec.empty


# ------------------------------------------------------------ schedule
class TestFaultSchedule:
    @pytest.mark.parametrize("seed", [0, 7])
    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_equals_reference(self, name, seed):
        spec = SPECS[name]
        ours = bind_faults(spec, SLOT, 8.0, seed)
        theirs = ref_faults.bind_faults(to_ref(spec), SLOT, 8.0, seed)
        assert ours.node_events() == theirs.node_events()
        assert ours.has_brownouts() == theirs.has_brownouts()
        for t in np.linspace(0.0, 8.0, 161):
            assert ours.node_down("node", t) == theirs.node_down("node", t)
            assert ours.down_until("node", t) == theirs.down_until("node", t)
            assert ours.routable("node", t) == theirs.routable("node", t)
            assert ours.slow_factor("node", t) == theirs.slow_factor("node", t)

    def test_links_equal_reference(self):
        spec = FaultSpec(link_outages=(
            LinkOutage(2.0, 4.0, node="mec"),
            LinkOutage(1.0, 3.0, site=1, down=False, latency_factor=2.0, latency_add_s=0.005)))
        ours = bind_faults(spec, 0.001, 8.0, seed=0)
        theirs = ref_faults.bind_faults(to_ref(spec), 0.001, 8.0, seed=0)
        for t in np.linspace(0.0, 8.0, 81):
            for site, node in ((0, "mec"), (1, "mec"), (1, "ran:cell0")):
                assert ours.link_down(site, node, t) == theirs.link_down(site, node, t)
                assert ours.link_latency(site, node, 0.01, t) == \
                    theirs.link_latency(site, node, 0.01, t)

    def test_bind_is_deterministic(self):
        spec = FaultSpec(
            node_outages=(NodeOutage("mec", 1.0, 2.0),),
            crash_processes=(NodeCrashProcess("ran:cell0", 1.5, 0.5),),
        )
        a = bind_faults(spec, SLOT, 8.0, seed=7)
        b = bind_faults(spec, SLOT, 8.0, seed=7)
        assert a.node_events() == b.node_events()
        assert not a.empty

    def test_crash_process_depends_only_on_seed_and_salt(self):
        spec = FaultSpec(crash_processes=(NodeCrashProcess("mec", 1.0, 0.3),))
        base = bind_faults(spec, SLOT, 20.0, seed=0).node_events()
        other_seed = bind_faults(spec, SLOT, 20.0, seed=1).node_events()
        salted = bind_faults(dataclasses.replace(spec, salt=9), SLOT, 20.0, seed=0).node_events()
        assert base
        assert base != other_seed
        assert base != salted

    def test_events_snap_to_slot_grid(self):
        spec = FaultSpec(
            node_outages=(NodeOutage("mec", 1.00001, 2.00007),),
            crash_processes=(NodeCrashProcess("mec", 2.0, 0.5),),
        )
        for t, kind, node in bind_faults(spec, SLOT, 10.0, seed=3).node_events():
            assert abs(t / SLOT - round(t / SLOT)) < 1e-6, (t, kind, node)
            assert kind in (NODE_FAIL, NODE_RECOVER)
            assert node == "mec"

    def test_node_down_and_routable_hysteresis(self):
        spec = FaultSpec(node_outages=(NodeOutage("mec", 2.0, 4.0),), hysteresis_s=0.25)
        sched = bind_faults(spec, 0.001, 8.0, seed=0)
        assert not sched.node_down("mec", 1.999)
        assert sched.node_down("mec", 2.0)
        assert sched.node_down("mec", 3.999)
        assert not sched.node_down("mec", 4.0)
        assert sched.down_until("mec", 2.5) == 4.0
        assert sched.routable("mec", 1.999)
        assert not sched.routable("mec", 2.0)
        assert not sched.routable("mec", 4.24)
        assert sched.routable("mec", 4.25)
        assert sched.routable("ran:cell0", 3.0)

    def test_overlapping_outages_merge(self):
        spec = FaultSpec(node_outages=(NodeOutage("mec", 1.0, 3.0), NodeOutage("mec", 2.0, 4.0)))
        ev = bind_faults(spec, 0.001, 8.0, seed=0).node_events()
        assert [k for _, k, _ in ev] == [NODE_FAIL, NODE_RECOVER]
        assert ev[0][0] == 1.0 and ev[1][0] == 4.0

    def test_link_store_and_forward(self):
        sched = bind_faults(FaultSpec(link_outages=(LinkOutage(2.0, 4.0, node="mec"),)),
                            0.001, 8.0, seed=0)
        assert sched.link_down(0, "mec", 3.0)
        assert not sched.link_down(0, "mec", 4.0)
        assert not sched.link_down(0, "ran:cell0", 3.0)
        assert sched.link_latency(0, "mec", 0.01, 3.0) == pytest.approx(1.01)
        assert sched.link_latency(0, "mec", 0.01, 5.0) == pytest.approx(0.01)

    def test_brownout_slow_factor(self):
        sched = bind_faults(FaultSpec(brownouts=(Brownout("mec", 1.0, 2.0, 3.0),)),
                            0.001, 8.0, seed=0)
        assert sched.slow_factor("mec", 1.5) == pytest.approx(3.0)
        assert sched.slow_factor("mec", 2.5) == pytest.approx(1.0)
        assert sched.slow_factor("ran:cell0", 1.5) == pytest.approx(1.0)

    def test_unknown_node_rejected(self):
        with pytest.raises(ValueError, match="unknown node"):
            bind_faults(FaultSpec(node_outages=(NodeOutage("nope", 1.0, 2.0),)),
                        0.001, 8.0, seed=0, node_names=["mec", "ran:cell0"])


# ---------------------------------------------- opt-in bit-identity
class TestFaultsOffIdentity:
    @pytest.mark.parametrize("fast", [True, False])
    @pytest.mark.parametrize("scheme", sorted(simulator.SCHEMES))
    def test_empty_spec_is_free(self, scheme, fast):
        """faults=None and FaultSpec() give the same result, which is the
        reference's."""
        cfg = simulator.SimConfig(**SIM)
        off = simulator.simulate(simulator.SCHEMES[scheme], cfg, SVC, faults=None, fast=fast)
        empty = simulator.simulate(simulator.SCHEMES[scheme], cfg, SVC, faults=FaultSpec(),
                                   fast=fast)
        assert_same(off, empty)
        assert_same(empty, both(FaultSpec(), fast=fast, scheme=scheme)[1])


# --------------------------------------------- simulate(faults=...) == reference
class TestSimulateWithFaults:
    @pytest.mark.parametrize("redispatch", [True, False])
    @pytest.mark.parametrize("fast", [True, False])
    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_equals_reference(self, name, fast, redispatch):
        spec = dataclasses.replace(SPECS[name], redispatch=redispatch)
        ours, theirs = both(spec, fast=fast)
        assert ours.n_jobs > 0
        assert_same(ours, theirs)

    @pytest.mark.parametrize("scheme", ["disjoint_mec", "disjoint_ran"])
    def test_other_schemes_equal_reference(self, scheme):
        assert_same(*both(BOTH, scheme=scheme))

    def test_fast_equals_slow(self):
        for spec in SPECS.values():
            assert_same(both(spec, fast=True)[0], both(spec, fast=False)[0])

    def test_recorder_telemetry_equals_reference(self):
        ours, theirs = both(PROCESS, traced=True)
        assert_same(ours, theirs)
        tel = ours.telemetry
        assert tel["counts"]["faults"] == 18  # nine fail and nine recover instants
        assert tel["counts"]["redispatches"] > 0


# ------------------------------------------------- crash/recovery semantics
class TestCrashRecoverySemantics:
    def test_redispatch_off_drops_instead(self):
        spec = dataclasses.replace(CRASH, redispatch=False)
        res = simulator.simulate(simulator.SCHEMES["icc"], simulator.SimConfig(**SIM), SVC,
                                 faults=spec)
        assert (res.drop_reasons or {}).get("node_failure", 0) > 0
        on = simulator.simulate(simulator.SCHEMES["icc"], simulator.SimConfig(**SIM), SVC,
                                faults=CRASH)
        assert (on.drop_reasons or {}).get("node_failure", 0) == 0

    def test_exactly_once_termination(self):
        """A crash may retract a booked completion, but no job ends both
        completed and dropped, and the crash leaves no more jobs unfinished
        than the fault-free run's stragglers at the end."""
        def counts(spec):
            res = simulator.simulate(simulator.SCHEMES["icc"], simulator.SimConfig(**SIM), SVC,
                                     faults=spec, recorder=EventRecorder())
            tc, td = res.telemetry["jobs"]["t_complete"], res.telemetry["jobs"]["t_drop"]
            return (sum(c is not None and d is not None for c, d in zip(tc, td)),
                    sum(c is None and d is None for c, d in zip(tc, td)))

        both_, neither = counts(dataclasses.replace(CRASH, redispatch=False))
        both_off, neither_off = counts(None)
        assert both_ == 0 and both_off == 0
        assert neither == neither_off

    def test_crash_lowers_satisfaction(self):
        cfg = simulator.SimConfig(**SIM)
        clean = simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC)
        crashed = simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC, faults=CRASH)
        assert crashed.satisfaction < clean.satisfaction

    def test_single_cell_rejects_link_faults(self):
        cfg = simulator.SimConfig(n_ues=10, sim_time=2.0, seed=0)
        fs = FaultSpec(link_outages=(LinkOutage(0.5, 1.0),))
        with pytest.raises(ValueError, match="multi-cell"):
            simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC, faults=fs)
