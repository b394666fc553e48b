"""Job routing / offloading policies for the multi-cell deployment (the
port's copy of `repro/network/routing.py`).

A policy is consulted by each site's `SlotEngine` at the instant a job's
last uplink bit lands at the gNB (that is where the RAN first owns the job,
paper Fig. 5), and names the fleet node that will serve it. Policies:

  * ``local_only``    the site's own RAN node (MEC if the site has none):
                      the paper's single-cell ICC deployment, tiled.
  * ``mec_only``      everything to the shared MEC tier: the centralized
                      5G-MEC baseline at network scale.
  * ``least_loaded``  the candidate with the shortest queue (ties prefer
                      cheaper wireline, since candidates are ordered
                      local -> remote RAN -> MEC).
  * ``slack_aware``   the ICC-native policy: predict each candidate's
                      completion (backhaul arrival + queue drain + service,
                      via the node's own LatencyModel) and keep the job
                      local whenever the local node meets the deadline;
                      otherwise offload to the earliest-finishing node,
                      preferring deadline-feasible ones.
  * ``controlled``    slack_aware plus the control loop's routing action:
                      per-node bias (seconds) from the bound ControlState
                      is added to each completion estimate, so a controller
                      can shift load RAN <-> MEC on its epoch. Without a
                      bound state it decides exactly like slack_aware.

Health awareness (repro_torch.faults): when the driver binds a fault schedule
to the topology, `least_loaded`/`slack_aware`/`controlled` draw their
candidates from `Topology.healthy_candidates` — crashed nodes, nodes
inside the recovery hysteresis window, and nodes behind a down link are
filtered out (failover). `local_only` and `mec_only` stay deliberately
naive: their blindness to failures *is* the baseline the survivability
study measures ICC against.
"""

from __future__ import annotations

from typing import Dict, Type, Union

from ..core.scheduler import Job
from .topology import Topology

__all__ = ["RoutingPolicy", "POLICIES", "get_policy"]


class RoutingPolicy:
    name = "base"

    def __init__(self) -> None:
        self.topo: Topology = None  # set by bind()

    def bind(self, topo: Topology) -> "RoutingPolicy":
        self.topo = topo
        return self

    def route(self, job: Job, site: int, now: float) -> str:
        """Return the fleet-node name that will serve `job` from `site`."""
        raise NotImplementedError


class LocalOnly(RoutingPolicy):
    name = "local_only"

    def route(self, job: Job, site: int, now: float) -> str:
        return self.topo.local_node(site)


class MecOnly(RoutingPolicy):
    name = "mec_only"

    def route(self, job: Job, site: int, now: float) -> str:
        return Topology.MEC


class LeastLoaded(RoutingPolicy):
    name = "least_loaded"

    def route(self, job: Job, site: int, now: float) -> str:
        def depth(name: str) -> int:
            fn = self.topo.nodes[name]
            return len(fn.node) + fn.in_transit + int(fn.node.busy_until > now)

        return min(self.topo.healthy_candidates(site, now), key=depth)


class SlackAware(RoutingPolicy):
    name = "slack_aware"

    def _bias(self, name: str) -> float:
        return 0.0  # the controlled subclass injects controller retargets

    def route(self, job: Job, site: int, now: float) -> str:
        topo = self.topo
        finish: Dict[str, float] = {}
        for name in topo.healthy_candidates(site, now):
            arrival = now + topo.wireline_latency(site, name, now=now)
            finish[name] = (
                topo.nodes[name].predict_finish(job, arrival, now)
                + self._bias(name)
            )

        local = topo.local_node(site)
        if local in finish and finish[local] <= job.deadline:
            return local  # keep RAN-resident whenever the deadline holds
        feasible = {n: f for n, f in finish.items() if f <= job.deadline}
        pool = feasible or finish
        return min(pool, key=pool.get)


class Controlled(SlackAware):
    """slack_aware with the controller's per-node retargeting bias mixed
    into every completion estimate. The network simulator binds the run's
    `ControlState` via `bind_state`; unbound (or with an empty bias map,
    e.g. under the static preset) the decisions equal slack_aware's."""

    name = "controlled"

    def __init__(self) -> None:
        super().__init__()
        self.state = None

    def bind_state(self, state) -> "Controlled":
        self.state = state
        return self

    def _bias(self, name: str) -> float:
        if self.state is None:
            return 0.0
        return self.state.node_bias.get(name, 0.0)


POLICIES: Dict[str, Type[RoutingPolicy]] = {
    p.name: p for p in (LocalOnly, MecOnly, LeastLoaded, SlackAware, Controlled)
}


def get_policy(policy: Union[str, RoutingPolicy]) -> RoutingPolicy:
    if isinstance(policy, RoutingPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise KeyError(
            f"unknown routing policy {policy!r}; known: {sorted(POLICIES)}"
        ) from None
