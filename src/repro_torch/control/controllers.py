"""Online joint bandwidth-compute controllers (the ICC control loop; the
port's copy of `repro/control/controllers.py`).

The paper's core claim is that RAN nodes manage bandwidth and computing
*jointly*; a static split leaves both fixed. This module closes the loop: a
controller runs on a fixed epoch, observes per-cell uplink backlog and
deadline slack plus per-node queue pressure, and emits `Actions` on the
three knobs a joint RAN owner holds:

  (a) **uplink bandwidth partition** — re-weight the PRB split across
      slack classes (UEs whose head job is near its deadline get a larger
      carrier share; `UplinkChannel.set_job_weights`),
  (b) **threshold admission control** — close a cell (or meter it with a
      per-epoch token quota) while the system cannot meet deadlines, so
      admitted jobs keep a clean uplink instead of everyone finishing late,
  (c) **routing retargets** — per-node bias (seconds) added to the
      `controlled` routing policy's completion estimates, shifting load
      RAN <-> MEC as compute pressure moves.

Controllers are deliberately simulator-agnostic: they see an `Observation`
and return `Actions`; the driver (`core.simulator` / `network.simulator`)
builds the former and applies the latter via `control_epoch`. A controller
that returns empty `Actions` (the `static` preset) leaves every knob
untouched — such a run is bit-identical to an uncontrolled one
(tests/test_torch_control.py pins this invariant).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CellObs",
    "NodeObs",
    "Observation",
    "Actions",
    "Controller",
    "StaticController",
    "ReactiveController",
    "SlackAwareJointController",
    "control_epoch",
]


# ------------------------------------------------------------ observation
@dataclasses.dataclass
class CellObs:
    cell: int
    uplink_jobs: int  # job bursts still in the air
    uplink_drain_s: float  # queued job bits / carrier rate: air backlog
    uplink_rate: float  # jobs/s one clean carrier can move for this shape
    min_slack_s: float  # tightest in-flight deadline minus now (inf if none)
    generated: int  # jobs generated since the last epoch
    admitted: int  # of which passed admission
    comm_floor_s: float  # uncontended uplink latency for this cell's jobs


@dataclasses.dataclass
class NodeObs:
    name: str
    queue_depth: int
    est_wait_s: float  # estimated_free_at(now) - now
    in_transit: int  # routed, still on the wireline
    # node health (repro_torch.faults): True while the node is crashed; fault-free
    # runs always observe False, so controllers branching on it stay
    # bit-identical when no fault schedule is bound
    down: bool = False


@dataclasses.dataclass
class Observation:
    t: float
    b_total: float
    cells: List[CellObs]
    nodes: List[NodeObs]
    svc_s: Dict[str, float]  # per-node effective per-job service (throughput)


# ----------------------------------------------------------------- actions
@dataclasses.dataclass
class Actions:
    """Knob settings for the coming epoch. ``None`` fields leave the knob
    exactly as-is (the static controller returns all-None and the run stays
    bit-identical); a dict reconciles every cell/node it mentions and
    resets the ones it omits."""

    admit: Optional[Dict[int, bool]] = None  # per-cell open/closed
    quota: Optional[Dict[int, float]] = None  # per-cell tokens this epoch
    node_bias: Optional[Dict[str, float]] = None  # seconds, controlled routing
    # cell -> (slack threshold s, PRB weight): UEs with a head job inside
    # the threshold get `weight`x carrier share this epoch
    urgent_boost: Optional[Dict[int, Tuple[float, float]]] = None


# ------------------------------------------------------------- controllers
class Controller:
    """Base: a named control law evaluated every `epoch_s` seconds."""

    name = "base"

    def __init__(self, epoch_s: float = 0.05):
        self.epoch_s = float(epoch_s)

    def on_epoch(self, obs: Observation) -> Actions:
        raise NotImplementedError


class StaticController(Controller):
    """The no-op preset: observes, touches nothing. Exists so "controlled
    pipeline, uncontrolled policy" is a first-class arm in benchmarks and
    the epoch plumbing itself is provably result-neutral."""

    name = "static"

    def on_epoch(self, obs: Observation) -> Actions:
        return Actions()


class ReactiveController(Controller):
    """Threshold admission with hysteresis + urgent-class PRB boost.

    Pure backlog reaction: a cell closes when its uplink holds more than
    `hi_backlog` bursts, reopens below `lo_backlog`, and while busy the
    near-deadline UEs get `boost`x carrier weight. Routing is untouched —
    this is the "bandwidth-only" half of joint management."""

    name = "reactive"

    def __init__(
        self,
        epoch_s: float = 0.05,
        hi_backlog: int = 30,
        lo_backlog: int = 10,
        boost: float = 4.0,
    ):
        super().__init__(epoch_s)
        self.hi_backlog = hi_backlog
        self.lo_backlog = lo_backlog
        self.boost = boost
        self._open: Dict[int, bool] = {}

    def on_epoch(self, obs: Observation) -> Actions:
        admit: Dict[int, bool] = {}
        boosts: Dict[int, Tuple[float, float]] = {}
        for c in obs.cells:
            open_ = self._open.get(c.cell, True)
            if open_ and c.uplink_jobs > self.hi_backlog:
                open_ = False
            elif not open_ and c.uplink_jobs < self.lo_backlog:
                open_ = True
            self._open[c.cell] = open_
            admit[c.cell] = open_
            if c.uplink_jobs > self.lo_backlog:
                boosts[c.cell] = (0.5 * obs.b_total, self.boost)
        return Actions(admit=admit, urgent_boost=boosts)


class SlackAwareJointController(Controller):
    """The joint preset: all three knobs, driven by deadline slack.

    * **Admission** is a token quota, not a binary gate, and it targets
      the one resource the static pipeline actually wastes: the air
      interface. The compute side already sheds overload for free (doomed
      jobs are dropped at dispatch before consuming service), but every
      doomed job still burns its full uplink payload, and equal-share PRB
      scheduling under overload makes *everyone* finish late. So the quota
      engages per cell when the air backlog would take more than
      `admit_margin` of the budget slack to drain, or when offered load
      exceeds `trigger_overload`x the cell's clean-carrier rate (the
      predictive trigger that catches a flash-crowd onset within one
      epoch). While engaged, a cell admits `headroom`x the smaller of its
      uplink rate and its demand share of fleet compute throughput —
      admitted jobs ride a clean carrier and finish inside the budget.
    * **Routing bias** re-targets the `controlled` policy by the nodes'
      observed queue pressure, held for a whole epoch — this damps the
      decide-time thundering that per-job estimates alone cannot see.
    * **Bandwidth** gets the same urgent-class PRB boost as `reactive`.
    """

    name = "slack_aware_joint"

    def __init__(
        self,
        epoch_s: float = 0.05,
        admit_margin: float = 0.5,
        bias_gamma: float = 1.0,
        boost: float = 4.0,
        headroom: float = 0.95,
        trigger_overload: float = 1.2,
        boost_backlog: int = 8,
    ):
        super().__init__(epoch_s)
        self.admit_margin = admit_margin
        self.bias_gamma = bias_gamma
        self.boost = boost
        self.headroom = headroom
        self.trigger_overload = trigger_overload
        self.boost_backlog = boost_backlog

    def on_epoch(self, obs: Observation) -> Actions:
        waits = {
            n.name: max(n.est_wait_s, 0.0) + n.in_transit * obs.svc_s[n.name]
            for n in obs.nodes
        }
        bias = {name: self.bias_gamma * w for name, w in waits.items()}
        for n in obs.nodes:
            if n.down:
                # shed load off a crashed node outright: its est_wait
                # already spans the outage, the extra bias makes the
                # retarget unconditional rather than marginal
                bias[n.name] = bias.get(n.name, 0.0) + 10.0 * obs.b_total

        comm_floor = max(c.comm_floor_s for c in obs.cells)
        slack = max(obs.b_total - comm_floor, 1e-3)
        # a crashed node contributes no throughput while it is down, so
        # the admission quota provisions for the surviving fleet only
        fleet_rate = sum(
            1.0 / obs.svc_s[n.name] for n in obs.nodes if not n.down
        )
        demand = max(sum(c.generated for c in obs.cells), 1)
        quota: Optional[Dict[int, float]] = None
        for c in obs.cells:
            cell_rate = max(c.generated, 1) / self.epoch_s
            congested = (
                c.uplink_drain_s > self.admit_margin * slack
                or cell_rate > self.trigger_overload * c.uplink_rate
            )
            if not congested:
                continue
            if quota is None:
                quota = {}
            compute_share = fleet_rate * max(c.generated, 1) / demand
            # while the pre-trigger flood is still in the air, admit less:
            # new admissions queue behind it and would miss anyway
            drain_damp = max(0.0, 1.0 - c.uplink_drain_s / slack)
            quota[c.cell] = (
                self.headroom * drain_damp
                * min(c.uplink_rate, compute_share) * self.epoch_s
            )
        boosts = {
            c.cell: (0.5 * obs.b_total, self.boost)
            for c in obs.cells
            if c.uplink_jobs > self.boost_backlog
        }
        return Actions(quota=quota, node_bias=bias, urgent_boost=boosts)


# ------------------------------------------------------------ epoch driver
def urgent_weights(engine, now: float, slack_s: float, boost: float):
    """Per-UE PRB weights boosting UEs whose head in-flight job is within
    `slack_s` of its deadline; None when no UE qualifies (restores the
    channel's unweighted fast path)."""
    urgent = engine.urgent_ues(now, slack_s)
    if not urgent:
        return None
    w = np.ones(engine.sim.n_ues)
    w[urgent] = boost
    return w


def control_epoch(
    ctl: Controller,
    state,
    now: float,
    b_total: float,
    engines: Sequence,
    node_items: Sequence[Tuple[str, object, int]],
    svc_s: Dict[str, float],
    recorder=None,
    down_nodes=None,
) -> Actions:
    """One control-loop turn: advance the nodes to `now` (observations must
    not lag the slot clock across a fast-forward), build the Observation,
    evaluate the controller, apply its Actions to the `ControlState` and
    the engines' channels. `node_items` is ``(name, node, in_transit)``.
    `down_nodes` (a set of node names, from the driver's fault schedule)
    marks crashed nodes in the observation; None = all healthy.

    `recorder` (an *active* `repro_torch.telemetry` recorder, or None) gets one
    epoch record per turn: the Observation numbers and the Actions taken
    (JSON-safe — infinities become None)."""
    for _, node, _ in node_items:
        node.run_until(now)
    cells = [
        CellObs(
            cell=e.cell,
            uplink_jobs=e._n_in_flight,
            uplink_drain_s=e.uplink_drain_s(),
            uplink_rate=e.uplink_rate,
            min_slack_s=e.min_inflight_slack(now),
            generated=state.generated[e.cell],
            admitted=state.admitted[e.cell],
            comm_floor_s=e.uplink_floor_s,
        )
        for e in engines
    ]
    nodes = [
        NodeObs(
            name=name,
            queue_depth=len(node),
            est_wait_s=node.estimated_free_at(now) - now,
            in_transit=in_transit,
            down=(down_nodes is not None and name in down_nodes),
        )
        for name, node, in_transit in node_items
    ]
    obs = Observation(t=now, b_total=b_total, cells=cells, nodes=nodes,
                      svc_s=dict(svc_s))
    actions = ctl.on_epoch(obs)

    n = state.n_cells
    if actions.admit is not None:
        state.admit = [True] * n  # omitted cells reopen (reconcile)
        for c, ok in actions.admit.items():
            state.admit[c] = bool(ok)
    state.quota = [math.inf] * n  # per-epoch token refill
    if actions.quota is not None:
        for c, q in actions.quota.items():
            state.quota[c] = float(q)
    if actions.node_bias is not None:
        state.node_bias = dict(actions.node_bias)
    if actions.urgent_boost is not None:
        for e in engines:
            spec = actions.urgent_boost.get(e.cell)
            e.channel.set_job_weights(
                urgent_weights(e, now, *spec) if spec else None
            )
    state.n_epochs += 1
    state.generated = [0] * n
    state.admitted = [0] * n
    if recorder is not None:
        fin = _finite_or_none
        recorder.epoch(now, {
            "t": now,
            "epoch": state.n_epochs,
            "cells": [
                {
                    "cell": c.cell,
                    "uplink_jobs": c.uplink_jobs,
                    "uplink_drain_s": c.uplink_drain_s,
                    "min_slack_s": fin(c.min_slack_s),
                    "generated": c.generated,
                    "admitted": c.admitted,
                }
                for c in cells
            ],
            "nodes": [
                {
                    "name": nb.name,
                    "queue_depth": nb.queue_depth,
                    "est_wait_s": fin(nb.est_wait_s),
                    "in_transit": nb.in_transit,
                    "down": nb.down,
                }
                for nb in nodes
            ],
            "actions": {
                "admit": (
                    {str(c): bool(v) for c, v in actions.admit.items()}
                    if actions.admit is not None else None
                ),
                "quota": (
                    {str(c): fin(float(v)) for c, v in actions.quota.items()}
                    if actions.quota is not None else None
                ),
                "node_bias": (
                    {k: fin(float(v)) for k, v in actions.node_bias.items()}
                    if actions.node_bias is not None else None
                ),
                "urgent_boost": (
                    {str(c): [float(x) for x in v]
                     for c, v in actions.urgent_boost.items()}
                    if actions.urgent_boost is not None else None
                ),
            },
        })
    return actions


def _finite_or_none(x: float):
    """JSON-safe epoch-record numbers (min-slack/quota may be inf)."""
    return x if math.isfinite(x) else None
