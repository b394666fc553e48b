"""Heterogeneous compute fleet: each node wraps a LatencyModel for its GPU
(the port's copy of `repro/network/fleet.py`).

A deployment mixes accelerator tiers — a power-constrained L4 at a far-edge
cell site, an H100 at an aggregation site, pooled GH200s in the MEC — so
per-node service times differ by an order of magnitude. `FleetNode` pairs a
`ComputeNode` queue with the analytic `LatencyModel` for its hardware; the
same model drives both actual service times and the routing policies'
completion predictions (slack_aware routes on what the node itself would
predict, the ICC joint-management stance).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from ..core.latency_model import (
    A100,
    GH200_NVL2,
    H100,
    L4,
    LLAMA2_7B,
    TPU_V5E,
    HardwareSpec,
    LatencyModel,
    ModelProfile,
)
from ..core.scheduler import ComputeNode, ComputeNodeProtocol, Job

__all__ = ["GPU_SPECS", "FleetNode", "build_fleet_node"]

GPU_SPECS: Dict[str, HardwareSpec] = {
    spec.name: spec for spec in (TPU_V5E, A100, H100, L4, GH200_NVL2)
}


@dataclasses.dataclass
class FleetNode:
    """One compute node in the deployment (RAN site or MEC tier)."""

    name: str  # unique within the topology, e.g. "ran:cell0" or "mec"
    kind: str  # "ran" | "mec"
    site: Optional[int]  # owning cell index for RAN nodes, None for MEC
    lm: LatencyModel
    node: ComputeNodeProtocol  # classic ComputeNode or BatchedComputeNode
    # jobs routed here but still riding the wireline/backhaul: invisible to
    # the ComputeNode queue, so routing tracks them explicitly — otherwise
    # every job deciding during a node's backhaul window sees the same
    # stale queue and piles on (thundering herd).
    in_transit: int = 0
    in_transit_s: float = 0.0  # their predicted service total

    def service_time(self, job: Job) -> float:
        return self.lm.job_latency(job.n_input, job.n_output)

    def commit(self, job: Job) -> None:
        """Record a routed job that has not reached the queue yet."""
        self.in_transit += 1
        self.in_transit_s += self.service_time(job)

    def settle(self, job: Job) -> None:
        """The committed job arrived (it is now visible in the queue)."""
        self.in_transit -= 1
        self.in_transit_s = max(self.in_transit_s - self.service_time(job), 0.0)

    def predict_finish(self, job: Job, t_arrival: float, now: float) -> float:
        """Predicted completion if `job` were routed here, arriving at
        `t_arrival`: queue drain + in-transit commitments + its own service.

        Batched nodes (`repro_torch.batching.BatchedComputeNode`) expose
        `predicted_service` and serve up to `max_batch` sequences per
        iteration, so both the job's own service and the in-transit backlog
        amortize across the batch width; classic whole-job nodes keep the
        single-server estimate."""
        node = self.node
        predicted = getattr(node, "predicted_service", None)
        if predicted is not None:
            svc = predicted(job)
            transit = self.in_transit_s / getattr(node, "max_batch", 1)
        else:
            svc = self.service_time(job)
            transit = self.in_transit_s
        start = max(node.estimated_free_at(now) + transit, t_arrival)
        return start + svc


def build_fleet_node(
    name: str,
    kind: str,
    gpu: Union[str, HardwareSpec],
    n_devices: int = 1,
    site: Optional[int] = None,
    model: ModelProfile = LLAMA2_7B,
    policy: str = "priority",
    drop_infeasible: bool = True,
    node_kind: str = "classic",
    max_batch: int = 8,
) -> FleetNode:
    """Wire a compute node to the LatencyModel of `n_devices` x `gpu`.

    Defaults are the ICC joint-management stance: least-slack-first queue
    with deadline dropping (paper §IV-B) at every node in the fleet.
    `node_kind="classic"` is the paper's whole-job single server (paper
    fidelity, Eq. 7/8); `node_kind="batched"` is the token-granular
    continuous-batching server (`repro_torch.batching`), which needs the
    extended-fidelity model for its batch/context-dependent iterations.
    """
    spec = GPU_SPECS[gpu] if isinstance(gpu, str) else gpu
    hw = spec.scaled(n_devices) if n_devices > 1 else spec
    if node_kind == "classic":
        lm = LatencyModel(hw, model, fidelity="paper")
        node = ComputeNode(
            lambda j: lm.job_latency(j.n_input, j.n_output),
            policy=policy,
            drop_infeasible=drop_infeasible,
            deterministic_service=True,  # analytic model: O(1) routing queries
        )
    elif node_kind == "batched":
        from ..batching import BatchedComputeNode

        lm = LatencyModel(hw, model, fidelity="extended")
        node = BatchedComputeNode(
            lm,
            max_batch=max_batch,
            policy=policy,
            drop_infeasible=drop_infeasible,
        )
    else:
        raise ValueError(f"unknown node_kind {node_kind!r}")
    return FleetNode(name=name, kind=kind, site=site, lm=lm, node=node)
