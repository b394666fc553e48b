"""The port's control loop (`repro_torch.control` controllers, presets,
`ControlState`, mobility draws, and `simulate(controller=)`) against the
reference's `repro.control` on fixed seeds: the single-cell part of
tests/test_control.py. The copies are plain numpy, so the bar is equality:
the same Actions, the same draws, and `SimResult`s field by field. The
multi-cell cases (routing retargets, handovers moving uplink state) are in
tests/test_torch_network.py.
"""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import control as ref_control  # noqa: E402
from repro.core import scheduler as ref_sched  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.telemetry import EventRecorder as RefRecorder  # noqa: E402
from repro_torch import control  # noqa: E402
from repro_torch.control import (ControlState, MobilityConfig, MobilityModel,  # noqa: E402
                                 get_controller, list_controllers, validate_controller)
from repro_torch.core import scheduler, simulator  # noqa: E402
from repro_torch.faults import FaultSpec, NodeOutage  # noqa: E402
from repro_torch.telemetry import EventRecorder  # noqa: E402
from test_torch_core import REF_SVC, SVC, assert_same  # noqa: E402
from test_torch_faults import to_ref  # noqa: E402

PRESETS = ["static", "reactive", "slack_aware_joint"]
# 1000-token prompts congest the uplink: the reactive preset closes the cell
# and boosts urgent UEs, the joint one meters admission with quotas
CONGESTED = dict(n_ues=60, n_input=1000, sim_time=3.0, warmup=0.5, seed=6)
# Table I's 15-token prompts near the paper node's capacity: no preset acts
PLAIN = dict(n_ues=62, sim_time=3.0, warmup=0.5, seed=6)


def both(controller, sim, fast=True, faults=None, traced=True):
    ours_kw = {"recorder": EventRecorder()} if traced else {}
    ref_kw = {"recorder": RefRecorder()} if traced else {}
    ours = simulator.simulate(simulator.SCHEMES["icc"], simulator.SimConfig(**sim), SVC,
                              controller=controller, faults=faults, fast=fast, **ours_kw)
    theirs = ref_sim.simulate(ref_sim.SCHEMES["icc"], ref_sim.SimConfig(**sim), REF_SVC,
                              controller=controller, fast=fast,
                              faults=None if faults is None else to_ref(faults), **ref_kw)
    return ours, theirs


class TestSimulateWithController:
    @pytest.mark.parametrize("fast", [True, False])
    @pytest.mark.parametrize("preset", PRESETS)
    def test_equals_reference(self, preset, fast):
        ours, theirs = both(preset, CONGESTED, fast=fast)
        assert_same(ours, theirs)
        assert ours.telemetry["counts"]["epochs"] > 0

    @pytest.mark.parametrize("preset", PRESETS)
    def test_with_a_crash_equals_reference(self, preset):
        crash = FaultSpec(node_outages=(NodeOutage("node", 1.0, 1.6),))
        ours, theirs = both(preset, CONGESTED, faults=crash)
        assert_same(ours, theirs)
        assert ours.telemetry["counts"]["faults"] == 2

    def test_presets_act_under_congestion(self):
        plain = simulator.simulate(simulator.SCHEMES["icc"], simulator.SimConfig(**CONGESTED),
                                   SVC)
        for preset, reason in (("reactive", "quota"), ("slack_aware_joint", "quota")):
            res = both(preset, CONGESTED)[0]
            assert (res.drop_reasons or {}).get(reason, 0) > 0, preset
            assert res.satisfaction > plain.satisfaction, preset

    @pytest.mark.parametrize("fast", [True, False])
    @pytest.mark.parametrize("sim", [PLAIN, CONGESTED], ids=["plain", "congested"])
    def test_static_controller_is_noop(self, sim, fast):
        cfg = simulator.SimConfig(**sim)
        plain = simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC, fast=fast)
        static = simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC, fast=fast,
                                    controller="static")
        assert_same(plain, static)

    def test_no_preset_acts_at_table_one_prompts(self):
        """At 15-token prompts the air interface is never congested, so the
        presets, which act on the uplink, leave the run as it is."""
        cfg = simulator.SimConfig(**PLAIN)
        plain = simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC)
        for preset in PRESETS:
            assert_same(plain, simulator.simulate(simulator.SCHEMES["icc"], cfg, SVC,
                                                  controller=preset))

    def test_epochs_fire_across_idle_fast_forward(self):
        """At near-zero load the engine skips idle slots, yet every epoch of
        the controller still fires on schedule."""
        rec = EventRecorder()
        sim = simulator.SimConfig(n_ues=2, sim_time=4.0, warmup=0.5, seed=1)
        simulator.simulate(simulator.SCHEMES["icc"], sim, SVC, controller="static",
                           recorder=rec)
        epoch_slots = max(1, int(round(get_controller("static").epoch_s / sim.channel.slot_s)))
        n_slots = int(round(sim.sim_time / sim.channel.slot_s))
        epochs = rec.to_telemetry()["epochs"]
        assert len(epochs) == (n_slots - 1) // epoch_slots
        assert [e["epoch"] for e in epochs] == list(range(1, len(epochs) + 1))


def _observation(mod, rng, n_cells=3, down=()):
    cells = [mod.CellObs(cell=c, uplink_jobs=int(rng.integers(0, 50)),
                         uplink_drain_s=float(rng.uniform(0, 0.08)),
                         uplink_rate=float(rng.uniform(20, 200)),
                         min_slack_s=float(rng.uniform(-0.01, 0.08)),
                         generated=int(rng.integers(0, 20)), admitted=int(rng.integers(0, 20)),
                         comm_floor_s=float(rng.uniform(0.005, 0.03)))
             for c in range(n_cells)]
    names = ["mec", "ran:cell0"]
    nodes = [mod.NodeObs(name=n, queue_depth=int(rng.integers(0, 30)),
                         est_wait_s=float(rng.uniform(-0.01, 0.2)),
                         in_transit=int(rng.integers(0, 5)), down=n in down) for n in names]
    return mod.Observation(t=float(rng.uniform(0, 10)), b_total=0.08, cells=cells,
                           nodes=nodes, svc_s={n: float(rng.uniform(0.005, 0.02))
                                               for n in names})


class TestControllers:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_actions_equal_reference(self, preset):
        """Fifty epochs of random observations (some with a crashed node):
        the same Actions, hysteresis state carried across epochs."""
        ours, theirs = get_controller(preset), ref_control.get_controller(preset)
        rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
        for i in range(50):
            down = ("mec",) if i % 7 == 3 else ()
            a = ours.on_epoch(_observation(control, rng_a, down=down))
            b = theirs.on_epoch(_observation(ref_control, rng_b, down=down))
            assert dataclasses.asdict(a) == dataclasses.asdict(b)

    def test_defaults_equal_reference(self):
        for name in PRESETS:
            ours, theirs = get_controller(name), ref_control.get_controller(name)
            assert type(ours).__name__ == type(theirs).__name__
            assert vars(ours) == vars(theirs)

    def test_admission_gate_counts_and_marks(self):
        state = ControlState(n_cells=2)
        j0 = scheduler.Job(0, 0, 0.0, 1, 1, 0.1, cell=0)
        j1 = scheduler.Job(1, 0, 0.0, 1, 1, 0.1, cell=1)
        state.quota[0] = 1.0
        assert state.gate(j0, 0.0) is True
        assert state.gate(j0, 0.0) is False  # quota spent
        state.admit[1] = False
        assert state.gate(j1, 0.0) is False
        assert state.total_generated == 3 and state.total_rejected == 2

    def test_gate_equals_reference(self):
        ours, theirs = ControlState(n_cells=3), ref_control.ControlState(n_cells=3)
        rng = np.random.default_rng(0)
        for i in range(200):
            if i % 20 == 0:
                quota = [float(q) for q in rng.integers(0, 6, 3)]
                admit = [bool(a) for a in rng.integers(0, 2, 3)]
                ours.quota, theirs.quota = list(quota), list(quota)
                ours.admit, theirs.admit = list(admit), list(admit)
            c = int(rng.integers(0, 3))
            assert ours.gate(scheduler.Job(i, 0, 0.0, 1, 1, 0.1, cell=c), 0.0) == \
                theirs.gate(ref_sched.Job(i, 0, 0.0, 1, 1, 0.1, cell=c), 0.0)
        assert vars(ours) == vars(theirs)


class TestMobility:
    @pytest.mark.parametrize("cfg", [
        MobilityConfig(),
        MobilityConfig(n_roamers=6, dwell_mean_s=0.25, salt=3),
        MobilityConfig(n_roamers=3, dwell_mean_s=0.5, xn_handover_s=0.002),
    ], ids=["default", "busy", "xn"])
    @pytest.mark.parametrize("seed", [0, 4])
    def test_draws_equal_reference(self, cfg, seed):
        kw = dict(n_cells=3, slot_s=2.5e-4, n_slots=16000, seed=seed,
                  static_ues=[10, 12, 8], xn_s=0.005)
        ours = MobilityModel(cfg, **kw)
        theirs = ref_control.MobilityModel(ref_control.MobilityConfig(**dataclasses.asdict(cfg)),
                                           **kw)
        assert [dataclasses.astuple(e) for e in ours.events] == \
            [dataclasses.astuple(e) for e in theirs.events]
        assert ours.xn_s == theirs.xn_s
        for cell in range(3):
            assert ours.presence_for_cell(cell) == theirs.presence_for_cell(cell)
            for k in range(cfg.n_roamers):
                assert ours.ue_index(cell, k) == theirs.ue_index(cell, k)

    def test_trajectories_conserve_roamers(self):
        """Every handover leaves the cell the roamer is in, and each roamer
        is present in exactly one cell at any slot."""
        m = MobilityModel(MobilityConfig(n_roamers=6, dwell_mean_s=0.25), n_cells=3,
                          slot_s=2.5e-4, n_slots=16000, seed=4, static_ues=[10, 12, 8],
                          xn_s=0.005)
        assert m.events
        where = {k: k % 3 for k in range(6)}
        for e in m.events:
            assert e.frm == where[e.roamer] and e.to != e.frm
            where[e.roamer] = e.to
        for s in (0, 4000, 9999, 15999):
            for k in range(6):
                homes = [c for c in range(3) for (a, b) in
                         m.presence_for_cell(c)[m.ue_index(c, k)] if a <= s < b]
                assert len(homes) == 1

    def test_single_cell_has_no_handovers(self):
        m = MobilityModel(MobilityConfig(n_roamers=2), n_cells=1, slot_s=1e-3, n_slots=100,
                          seed=0, static_ues=[5], xn_s=0.0)
        assert m.events == [] and m.presence_for_cell(0) == {5: ((0, 100),), 6: ((0, 100),)}


class TestRegistries:
    def test_controller_registry(self):
        assert list_controllers() == ["reactive", "slack_aware_joint", "static"]
        assert list_controllers() == ref_control.list_controllers()
        with pytest.raises(KeyError, match="unknown controller"):
            get_controller("nope")
        # fresh instance per resolve (controllers hold hysteresis state)
        assert get_controller("reactive") is not get_controller("reactive")
        ctl = control.ReactiveController(hi_backlog=5)
        assert get_controller(ctl) is ctl

    def test_validate_controller(self):
        validate_controller(None)
        validate_controller("static")
        validate_controller(control.StaticController())
        with pytest.raises(KeyError, match="unknown controller"):
            validate_controller("nope")
        with pytest.raises(TypeError):
            validate_controller(3)
        with pytest.raises(KeyError):
            simulator.simulate(simulator.SCHEMES["icc"], simulator.SimConfig(**PLAIN), SVC,
                               controller="nope")

    def test_exports_equal_reference(self):
        assert sorted(control.__all__) == sorted(ref_control.__all__)
        assert math.isinf(ControlState(1).quota[0])
