"""repro_torch.network — multi-cell ICC edge network (the port's copy of
`repro/network`; beyond-paper: §IV at network scale).

The paper evaluates one gNB with one co-located compute node. This package
scales that to a deployment: a `Topology` of N gNB sites (each with an
optional RAN compute node, its own uplink channel and UE population),
backhaul links with configurable latency, and a shared MEC tier — with
pluggable job-routing policies and a heterogeneous GPU fleet.

Layout:
  scenarios.py  workload registry (Table-I AR translation, chatbot, vision)
  fleet.py      GPU spec registry + compute nodes wrapping LatencyModel
  topology.py   site / deployment configs and the runtime Topology
  routing.py    local_only / mec_only / least_loaded / slack_aware policies
  simulator.py  the multi-cell slot loop built on core.simulator.SlotEngine
"""

from .fleet import GPU_SPECS, FleetNode, build_fleet_node
from .routing import POLICIES, RoutingPolicy, get_policy
from .scenarios import (
    SCENARIOS,
    Scenario,
    get_scenario,
    list_scenarios,
    register_scenario,
)
from .simulator import NetResult, NetSimConfig, config_for_load, simulate_network
from .topology import SiteConfig, Topology, TopologyConfig, three_cell_hetero

__all__ = [
    "GPU_SPECS",
    "FleetNode",
    "build_fleet_node",
    "POLICIES",
    "RoutingPolicy",
    "get_policy",
    "SCENARIOS",
    "Scenario",
    "get_scenario",
    "list_scenarios",
    "register_scenario",
    "NetResult",
    "NetSimConfig",
    "config_for_load",
    "simulate_network",
    "SiteConfig",
    "Topology",
    "TopologyConfig",
    "three_cell_hetero",
]
