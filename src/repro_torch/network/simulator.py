"""Multi-cell slot-stepped simulation (Fig. 5 pipeline, N cells, one fleet;
the port's copy of `repro/network/simulator.py`, draw for draw).

Each gNB site runs its own `SlotEngine` (own UE population, own uplink
channel, own Poisson stream); the routing policy is consulted as each job
clears the air interface, the job rides the chosen wireline/backhaul link,
and the whole fleet of compute nodes advances in lock-step with the slot
clock. Satisfaction is the paper's Def. 1 under joint management (the
network layer is ICC-native: one operator owns RAN + compute).

The control subsystem (`repro_torch.control`) plugs in three optional layers:

  * a non-stationary **arrival process** per cell (the scenario's
    ``arrival`` spec, or a `NetSimConfig.arrival` override);
  * **mobility** — roaming UEs whose generation rate follows them between
    cells and whose in-flight uplink bursts are re-homed over Xn at each
    handover;
  * an online **controller** on a fixed epoch, observing per-cell backlog
    and per-node queue pressure and acting on admission, uplink PRB
    weights, and (with the ``controlled`` policy) routing bias.

The idle-slot fast-forward is clamped at driver events (handovers, burst
re-injections) and controller epochs, so none can be skipped over.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
from time import perf_counter
from typing import Dict, List, Optional, Union

import numpy as np

from ..control import (
    ControllerLike,
    MobilityConfig,
    MobilityModel,
    bind_arrivals,
    validate_controller,
)
from ..control.arrivals import ArrivalProcess
from ..core.latency_model import LLAMA2_7B, ModelProfile
from ..core.scheduler import Job
from ..core.simulator import SimConfig, SimResult, SlotEngine, score_jobs
from ..faults import FaultSpec, bind_faults
from ..faults.schedule import NODE_FAIL, NODE_RECOVER
from ..telemetry.profile import active_profiler
from ..telemetry.recorder import active as _active_recorder
from .routing import RoutingPolicy, get_policy
from .scenarios import SCENARIOS, Scenario
from .topology import Topology, TopologyConfig

__all__ = ["NetSimConfig", "NetResult", "config_for_load", "simulate_network"]


@dataclasses.dataclass(frozen=True)
class NetSimConfig:
    topology: TopologyConfig
    scenario: Scenario = SCENARIOS["ar_translation"]
    model: ModelProfile = LLAMA2_7B
    sim_time: float = 10.0
    warmup: float = 2.0
    seed: int = 0
    # compute-fleet node type: "classic" (paper, whole-job) or "batched"
    # (repro_torch.batching token-granular continuous batching)
    node_kind: str = "classic"
    max_batch: int = 8
    # --- control subsystem (all default-off: results bit-identical) ------
    # arrival-process override; None = the scenario's own spec (which is
    # None = stationary Poisson for the pre-control scenarios)
    arrival: Optional[ArrivalProcess] = None
    mobility: Optional[MobilityConfig] = None
    # controller preset name or instance (repro_torch.control.ControllerLike);
    # None = uncontrolled. Preset names are validated at construction —
    # a typo fails here, not deep inside the run.
    controller: Optional[ControllerLike] = None
    # transient-metric window length for score_jobs (None = off)
    window_s: Optional[float] = None
    # fault-injection scenario (repro_torch.faults.FaultSpec); None (or an
    # empty spec) keeps every fixed-seed result bit-identical to the
    # fault-free simulator — the repo's master contract
    faults: Optional[FaultSpec] = None

    def __post_init__(self):
        validate_controller(self.controller)


@dataclasses.dataclass
class NetResult:
    policy: str
    total: SimResult  # Def.-1 scoring over every cell's jobs
    per_cell: Dict[str, SimResult]  # keyed by site name
    route_share: Dict[str, float]  # fraction of routed jobs per fleet node
    controller: Optional[str] = None  # preset name when a control loop ran
    n_epochs: int = 0  # controller epochs evaluated
    n_rejected: int = 0  # jobs rejected by admission control
    n_handovers: int = 0  # mobility handovers executed
    n_rehomed: int = 0  # in-flight bursts re-homed across Xn
    # fault-injection accounting (zero on fault-free runs)
    n_node_failures: int = 0  # node crash events executed
    n_redispatched: int = 0  # jobs re-dispatched after a crash / dead door
    n_fault_drops: int = 0  # jobs lost to node_failure

    @property
    def satisfaction(self) -> float:
        return self.total.satisfaction

    @property
    def n_jobs(self) -> int:
        return self.total.n_jobs

    def row(self) -> str:
        share = " ".join(
            f"{k}={v:.2f}" for k, v in sorted(self.route_share.items())
        )
        s = f"{self.total.row()}  routes: {share}"
        if self.controller:
            s += f"  ctl={self.controller} rej={self.n_rejected}"
        if self.n_handovers:
            s += f"  ho={self.n_handovers}"
        return s


def config_for_load(
    topology: TopologyConfig,
    scenario: Scenario,
    load: float,
    sim_time: float = 10.0,
    warmup: float = 2.0,
    seed: int = 0,
    **kwargs,
) -> NetSimConfig:
    """NetSimConfig generating `load` aggregate jobs/s: the single place
    that maps a nominal rate to a UE population (capacity sweeps, fixed-load
    benchmark passes, and examples all scale load through here). For
    non-stationary scenarios the load is whatever rate the scenario's
    `lam_per_ue` provisions for (diurnal: the time-average; flash crowd:
    the pre-spike base). Extra kwargs (controller=, mobility=, window_s=,
    ...) pass through."""
    total_ues = max(len(topology.sites), int(round(load / scenario.lam_per_ue)))
    return NetSimConfig(
        topology=topology.scaled_ues(total_ues),
        scenario=scenario,
        sim_time=sim_time,
        warmup=warmup,
        seed=seed,
        **kwargs,
    )


def simulate_network(
    cfg: NetSimConfig,
    policy: Union[str, RoutingPolicy],
    fast: bool = True,
    recorder=None,
    profiler=None,
    _debug_engines: Optional[list] = None,
) -> NetResult:
    """Run one multi-cell simulation under `policy` and score Def. 1.

    ``fast=False`` selects the reference draw-per-slot engines (identical
    fixed-seed results; kept for equivalence testing). `recorder` (a
    `repro_torch.telemetry` TraceRecorder) captures lifecycle events and probe
    series across every cell and fleet node; an `EventRecorder`'s columnar
    export attaches as ``result.total.telemetry``. The default
    (None / NullRecorder) is free — traced and untraced runs are
    bit-identical apart from the attachment. `_debug_engines`,
    when a list, receives the per-cell SlotEngines after the run (tests
    assert job-conservation invariants on the raw timelines).

    `profiler` (a `repro_torch.telemetry.profile.PhaseProfiler`) attributes the
    run's host wall-clock to engine phases across every cell and node;
    the rollup attaches as ``result.total.profile``. Free when off,
    non-perturbing when on (fixed-seed bit-identity)."""
    prof = active_profiler(profiler)
    t_enter = perf_counter() if prof is not None else 0.0
    rec = _active_recorder(recorder)
    sc = cfg.scenario
    topo = Topology(
        cfg.topology, model=cfg.model,
        node_kind=cfg.node_kind, max_batch=cfg.max_batch,
    )
    if rec is not None:
        for fname, fn in topo.nodes.items():
            fn.node.recorder = rec
            fn.node.telemetry_name = fname
    pol = get_policy(policy).bind(topo)
    uid = itertools.count()  # fleet-wide unique job ids
    sites = cfg.topology.sites

    slots = {s.channel.slot_s for s in sites}
    if len(slots) != 1:
        raise ValueError(f"sites must share one slot duration, got {slots}")
    slot = slots.pop()
    n_slots = int(math.ceil(cfg.sim_time / slot))

    # driver event queue: mobility handovers + burst re-injections, fault
    # crash/recover instants, and crash-recovery retries/re-deliveries;
    # the idle fast-forward clamps at the head. Created before the
    # engines so the wireline/deliver closures can push into it.
    events: list = []
    eseq = itertools.count()

    def push_event(t: float, kind: str, payload) -> None:
        heapq.heappush(
            events, (int(math.ceil(t / slot - 1e-9)), next(eseq), kind, payload)
        )

    # ------------------------------------------------- fault injection
    # Strictly opt-in: `sched is None` (no spec, or an empty one) keeps
    # every code path below bit-identical to the fault-free simulator.
    sched = None
    if cfg.faults is not None and not cfg.faults.empty:
        sched = bind_faults(cfg.faults, slot, cfg.sim_time, cfg.seed,
                            node_names=list(topo.nodes))
        topo.fault_sched = sched  # routing + latency lookups go health-aware
        for fname, fn in topo.nodes.items():
            if sched.has_brownouts(fname):
                fn.node.speed_scale = (
                    lambda t, _n=fname: sched.slow_factor(_n, t)
                )
        for t_ev, kind, name in sched.node_events():
            push_event(t_ev, kind, (t_ev, name))
    n_node_failures = n_redispatched = n_fault_drops = 0
    retry_counts: Dict[int, int] = {}  # job uid -> dead-door retries used

    def fault_drop(job: Job, t: float) -> None:
        nonlocal n_fault_drops
        job.dropped = True
        job.drop_reason = "node_failure"
        n_fault_drops += 1
        if rec is not None:
            rec.job_event("drop", job.uid, t, stage="node",
                          reason="node_failure")

    def fault_redispatch(job: Job, t: float, avoid: Optional[str]) -> bool:
        """Re-route `job` from its cell at time t; False = no way out."""
        nonlocal n_redispatched
        route = pol.route(job, job.cell, t)
        if sched.node_down(route, t) or (avoid is not None and route == avoid):
            return False  # the policy insists on a dead/just-failed node
        job.route = route
        topo.nodes[route].commit(job)
        t_arr = t + topo.wireline_latency(job.cell, route, now=t)
        job.t_compute_arrival = t_arr
        n_redispatched += 1
        if rec is not None:
            # the recorder resets the job's stage attribution: the lost
            # attempt's prefill/decode becomes stall, the final attempt's
            # service books normally, and the sums still telescope to e2e
            rec.job_event("redispatch", job.uid, t, route=route,
                          t_arrival=t_arr)
        push_event(t_arr, "fault_deliver", (t_arr, job))
        return True

    def node_submit(job: Job, t: float) -> None:
        """Hand `job` to its routed node, or retry/fail over while the
        node is down: bounded exponential backoff at the door, then one
        policy re-route (if `redispatch`), then a node_failure drop."""
        name = job.route
        if sched is not None and sched.node_down(name, t):
            n = retry_counts.get(job.uid, 0)
            if n < sched.max_retries:
                retry_counts[job.uid] = n + 1
                t_next = t + sched.retry_backoff_s * (2 ** n)
                push_event(t_next, "fault_retry", (t_next, job))
                return
            if sched.redispatch and fault_redispatch(job, t, avoid=name):
                return
            fault_drop(job, t)
            return
        job.t_compute_arrival = max(job.t_compute_arrival, t)
        topo.nodes[name].node.submit(job)

    def handle_fault_event(kind: str, ev) -> bool:
        """Process one fault-machinery event; False = not ours."""
        nonlocal n_node_failures
        if kind == NODE_FAIL:
            t_ev, name = ev
            fn = topo.nodes[name]
            fn.node.run_until(t_ev)
            until = sched.down_until(name, t_ev) or t_ev
            affected = fn.node.crash(t_ev, until)
            n_node_failures += 1
            fe = getattr(rec, "fault_event", None)
            if fe is not None:
                fe(t_ev, NODE_FAIL, name, n_affected=len(affected))
            for job in affected:
                # lost queue + in-flight batch: drop, or re-dispatch via
                # routing with full re-prefill on the new node
                if not (sched.redispatch
                        and fault_redispatch(job, t_ev, avoid=None)):
                    fault_drop(job, t_ev)
        elif kind == NODE_RECOVER:
            t_ev, name = ev
            fe = getattr(rec, "fault_event", None)
            if fe is not None:
                fe(t_ev, NODE_RECOVER, name)
        elif kind == "fault_deliver":
            t_arr, job = ev
            topo.nodes[job.route].settle(job)
            node_submit(job, t_arr)
        elif kind == "fault_retry":
            t_next, job = ev
            node_submit(job, t_next)
        else:
            return False
        return True

    arrival_spec = cfg.arrival if cfg.arrival is not None else sc.arrival
    mob = None
    if cfg.mobility is not None and cfg.mobility.n_roamers > 0:
        mob = MobilityModel(
            cfg.mobility,
            n_cells=len(sites),
            slot_s=slot,
            n_slots=n_slots,
            seed=cfg.seed,
            static_ues=[s.n_ues for s in sites],
            xn_s=cfg.topology.t_inter_site,
        )
    ctl = state = None
    if cfg.controller is not None:
        from ..control import ControlState, control_epoch, get_controller

        ctl = get_controller(cfg.controller)
        state = ControlState(n_cells=len(sites))
        if hasattr(pol, "bind_state"):
            pol.bind_state(state)

    engines: List[SlotEngine] = []
    for i, site in enumerate(sites):
        n_ues = site.n_ues + (mob.n_roamers if mob else 0)
        sim = SimConfig(
            n_ues=n_ues,
            lam_per_ue=sc.lam_per_ue,
            n_input=sc.n_input,
            n_output=sc.n_output,
            b_total=sc.b_total,
            sim_time=cfg.sim_time,
            warmup=cfg.warmup,
            seed=cfg.seed,
            channel=dataclasses.replace(
                site.channel, bytes_per_token=sc.bytes_per_token
            ),
            arrivals=arrival_spec,
            window_s=cfg.window_s,
        )

        def wireline(job: Job, t: float, _site: int = i) -> float:
            job.route = pol.route(job, _site, t)
            topo.nodes[job.route].commit(job)  # visible while in transit
            if sched is None:
                return topo.wireline_latency(_site, job.route)
            # fault-aware: degraded links inflate, down links buffer the
            # job at the gNB until recovery (store-and-forward)
            return topo.wireline_latency(_site, job.route, now=t)

        def deliver(job: Job) -> None:
            fn = topo.nodes[job.route]
            fn.settle(job)
            if sched is None:
                fn.node.submit(job)
            else:
                node_submit(job, job.t_compute_arrival)

        seed_i = cfg.seed + 7919 * i
        engines.append(
            SlotEngine(
                sim,
                np.random.default_rng(seed_i),
                packet_priority=True,  # ICC-native network (§IV-B)
                wireline=wireline,
                deliver=deliver,
                cell=i,
                uid_iter=uid,
                fast=fast,
                arrivals=bind_arrivals(
                    arrival_spec,
                    n_ues=n_ues,
                    lam_per_ue=sc.lam_per_ue,
                    slot_s=slot,
                    n_slots=n_slots,
                    seed=seed_i,
                    presence=mob.presence_for_cell(i) if mob else None,
                ),
                gate=state.gate if state is not None else None,
                recorder=rec,
                profiler=prof,
            )
        )
    assert all(e.n_slots == n_slots for e in engines)
    if prof is not None:
        for fn in topo.nodes.values():
            if hasattr(fn.node, "profiler"):
                fn.node.profiler = prof  # batched admission self-timing

    roamer_cell: Dict[int, int] = {}
    if mob is not None:
        roamer_cell = {k: k % len(sites) for k in range(mob.n_roamers)}
        for ev in mob.events:
            heapq.heappush(events, (ev.slot, next(eseq), "handover", ev))
    n_handovers = n_rehomed = 0

    nodes = list(topo.nodes.values())
    if ctl is not None:
        epoch_slots = max(1, int(round(ctl.epoch_s / slot)))
        next_epoch = epoch_slots
        # effective per-job service per node for the controller's
        # throughput math (batched nodes amortize across the batch width)
        svc_s = {
            fn.name: fn.lm.job_latency(sc.n_input, sc.n_output)
            / max(getattr(fn.node, "max_batch", 1), 1)
            for fn in nodes
        }

    sample_stride = next_sample = 0
    if rec is not None:
        sample_stride = max(
            1, int(round(getattr(rec, "sample_every_s", 0.01) / slot))
        )
    s = 0
    # phase laps chain through one carried mark (see core.simulate): each
    # lap starts where the previous ended, so attribution telescopes
    tm = prof.lap("setup", t_enter) if prof is not None else 0.0
    while s < n_slots:
        had_events = prof is not None and bool(events) and events[0][0] <= s
        while events and events[0][0] <= s:
            _, _, kind, ev = heapq.heappop(events)
            now = s * slot
            if kind == "handover":
                frm_e = engines[ev.frm]
                bursts = frm_e.evict_ue(mob.ue_index(ev.frm, ev.roamer))
                roamer_cell[ev.roamer] = ev.to
                n_handovers += 1
                if bursts:
                    # re-home in-flight uplink state over Xn: the bursts
                    # resume at the roamer's cell after the transfer latency
                    t_inj = now + mob.xn_s
                    s_inj = min(n_slots - 1, int(math.ceil(t_inj / slot)))
                    for job, bits in bursts:
                        heapq.heappush(
                            events,
                            (s_inj, next(eseq), "inject",
                             (ev.roamer, job, bits, t_inj)),
                        )
                    n_rehomed += len(bursts)
            elif kind == "inject":
                roamer, job, bits, t_inj = ev
                # target the roamer's cell *now*, not at eviction time — a
                # dwell shorter than the Xn transfer moved the UE again (a
                # burst landing on its old cell would be stranded there);
                # a same-slot later handover simply re-evicts and re-homes
                to = roamer_cell[roamer]
                job.cell = to
                engines[to].inject_burst(
                    mob.ue_index(to, roamer), job, bits, t_inj
                )
            else:  # fault machinery (crash/recover/retry/re-deliver)
                handle_fault_event(kind, ev)
        if had_events:
            tm = prof.lap("events", tm)
        if ctl is not None and s >= next_epoch:
            now_ep = s * slot
            control_epoch(
                ctl, state, now_ep, sc.b_total, engines,
                [(fn.name, fn.node, fn.in_transit) for fn in nodes], svc_s,
                recorder=rec,
                down_nodes=(
                    {n for n in topo.nodes if sched.node_down(n, now_ep)}
                    if sched is not None else None
                ),
            )
            next_epoch += epoch_slots
            if prof is not None:
                tm = prof.lap("controller", tm)
        if all(e.can_skip() for e in engines):
            # every cell idle: fast-forward to the earliest arrival-process
            # event anywhere, clamped at driver events and controller
            # epochs (compute nodes advance by run_until)
            nxt = min(e.next_event_at_or_after(s) for e in engines)
            if events:
                nxt = min(nxt, events[0][0])
            if ctl is not None:
                nxt = min(nxt, next_epoch)
            if rec is not None:
                # keep probe cadence across idle spans (see core.simulate)
                nxt = min(nxt, next_sample)
            if nxt > s:
                for e in engines:
                    e.skip_slots(s, min(nxt, n_slots))
                s = nxt
                if prof is not None:
                    tm = prof.lap("fast_forward", tm)
                continue
        if prof is not None:
            # skip-decision + loop bookkeeping since the previous lap
            tm = prof.lap("driver", tm)
        t_slot_end = 0.0
        for e in engines:
            t_slot_end = e.step(s)
        if prof is not None:
            tm = prof.lap("uplink_step", tm)
        for fn in nodes:
            fn.node.run_until(t_slot_end)
        if prof is not None:
            tm = prof.lap("compute", tm)
        if rec is not None and s >= next_sample:
            for i, e in enumerate(engines):
                rec.sample(f"cell{i}.uplink", t_slot_end, {
                    "backlog_s": e.uplink_drain_s(),
                    "in_flight": float(e._n_in_flight),
                    "active_ues": float(e.channel.active_ues()),
                })
            for fn in nodes:
                rec.sample(f"{fn.name}.queue", t_slot_end, {
                    "depth": float(len(fn.node)),
                    "in_transit": float(fn.in_transit),
                })
            next_sample = s + sample_stride
            if prof is not None:
                tm = prof.lap("probes", tm)
        s += 1
    # drain fault-machinery events scheduled past the last slot (late
    # recoveries, retries/re-deliveries near sim end) so every job still
    # in the pipeline reaches a terminal state exactly once; retries the
    # drain itself schedules land back on this heap in time order
    while events:
        _, _, kind, ev = heapq.heappop(events)
        handle_fault_event(kind, ev)
    for fn in nodes:
        fn.node.run_until(float("inf"))
    if prof is not None:
        tm = prof.lap("compute", tm)  # final drain (+ post-loop events)

    # ------------------------------------------------------------- scoring
    if _debug_engines is not None:
        _debug_engines.extend(engines)
    all_jobs = [j for e in engines for j in e.jobs]
    total = score_jobs(all_jobs, engines[0].sim, pol.name, management="joint")
    per_cell = {
        site.name: score_jobs(
            engines[i].jobs, engines[i].sim, f"{pol.name}/{site.name}",
            management="joint",
        )
        for i, site in enumerate(sites)
    }
    counts = collections.Counter(j.route for j in all_jobs if j.route)
    n_routed = max(sum(counts.values()), 1)
    share = {k: v / n_routed for k, v in counts.items()}
    if prof is not None:
        tm = prof.lap("scoring", tm)
    if rec is not None and hasattr(rec, "to_telemetry"):
        total.telemetry = rec.to_telemetry(meta={
            "kind": "network",
            "policy": pol.name,
            "scenario": sc.name,
            "seed": cfg.seed,
            "sim_time": cfg.sim_time,
            "n_cells": len(sites),
            "nodes": [fn.name for fn in nodes],
            "controller": ctl.name if ctl is not None else None,
        })
        if prof is not None:
            tm = prof.lap("telemetry_export", tm)
    if prof is not None:
        prof.count("cells", len(engines))
        prof.count("slots", n_slots)
        prof.count("slots_skipped", sum(e.slots_skipped for e in engines))
        prof.count(
            "slots_stepped",
            n_slots * len(engines) - sum(e.slots_skipped for e in engines),
        )
        prof.count("arrival_chunks", sum(e.chunks_drawn for e in engines))
        prof.count(
            "uplink_scalar_slots",
            sum(e.channel.scalar_slots for e in engines),
        )
        prof.count(
            "uplink_array_slots",
            sum(e.channel.array_slots for e in engines),
        )
        prof.count(
            "uplink_mode_switches",
            sum(e.channel.array_mode_switches for e in engines),
        )
        for fn in nodes:
            st = getattr(fn.node, "stats", None)
            if st is not None:  # batched fleet nodes
                prof.count("batch_iterations", st.n_iterations)
                prof.count("kv_blocked_iterations",
                           st.kv_blocked_iterations)
        total.profile = prof.to_profile(perf_counter() - t_enter)
    return NetResult(
        policy=pol.name,
        total=total,
        per_cell=per_cell,
        route_share=share,
        controller=ctl.name if ctl is not None else None,
        n_epochs=state.n_epochs if state is not None else 0,
        n_rejected=state.total_rejected if state is not None else 0,
        n_handovers=n_handovers,
        n_rehomed=n_rehomed,
        n_node_failures=n_node_failures,
        n_redispatched=n_redispatched,
        n_fault_drops=n_fault_drops,
    )
