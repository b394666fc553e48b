"""Multi-cell deployment description and its runtime form (the port's copy
of `repro/network/topology.py`).

`SiteConfig` is one gNB: its UE population, uplink channel, an optional
co-located RAN compute node (GPU tier + count), and the wireline latencies
out of the site — fronthaul to its own node, backhaul to the shared MEC.
`TopologyConfig` is the deployment: the sites, the MEC tier, and the
inter-site (Xn) latency for RAN-to-RAN offloading.

`Topology` instantiates the compute fleet and answers the two questions a
router asks: which nodes can serve a job from site i (`candidates`), and
what wireline latency does each choice cost (`wireline_latency`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.channel import ChannelConfig
from ..core.latency_model import LLAMA2_7B, ModelProfile
from .fleet import FleetNode, build_fleet_node

__all__ = ["SiteConfig", "TopologyConfig", "Topology", "three_cell_hetero"]


@dataclasses.dataclass(frozen=True)
class SiteConfig:
    name: str
    n_ues: int = 20
    ran_gpu: Optional[str] = "h100"  # GPU_SPECS key; None = no RAN compute
    ran_gpu_count: int = 1
    t_fronthaul: float = 0.005  # gNB -> co-located RAN node (paper: 5 ms)
    t_backhaul_mec: float = 0.020  # gNB -> MEC tier (paper: 20 ms)
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    sites: Tuple[SiteConfig, ...]
    mec_gpu: str = "gh200-nvl2"
    mec_gpu_count: int = 2  # paper: two GH200-NVL2 at the compute node
    t_inter_site: float = 0.010  # gNB -> another site's RAN node (Xn)

    def scaled_ues(self, total_ues: int) -> "TopologyConfig":
        """Redistribute `total_ues` across sites proportionally to their
        configured populations (capacity sweeps scale load this way).

        Exact: the new populations sum to max(total_ues, n_sites) — every
        site keeps >= 1 UE and the remainder goes largest-fraction-first —
        so a sweep's nominal rate matches the load actually generated."""
        n = len(self.sites)
        total = max(total_ues, n)
        weights = [s.n_ues for s in self.sites]
        if not any(weights):  # all-zero template: split equally
            weights = [1] * n
        weight = sum(weights)
        extra = total - n  # each site gets 1 base UE
        quotas = [extra * w / weight for w in weights]
        counts = [int(q) for q in quotas]
        leftover = extra - sum(counts)
        for i in sorted(range(n), key=lambda k: quotas[k] - counts[k],
                        reverse=True)[:leftover]:
            counts[i] += 1
        sites = tuple(
            dataclasses.replace(s, n_ues=1 + c)
            for s, c in zip(self.sites, counts)
        )
        return dataclasses.replace(self, sites=sites)


class Topology:
    """Runtime deployment: the compute fleet plus backhaul latency lookups."""

    MEC = "mec"

    def __init__(
        self,
        cfg: TopologyConfig,
        model: ModelProfile = LLAMA2_7B,
        node_kind: str = "classic",
        max_batch: int = 8,
    ):
        names = [s.name for s in cfg.sites]
        if len(set(names)) != len(names):
            raise ValueError(
                f"site names must be unique (node names and per-cell scores "
                f"key on them), got {names}"
            )
        self.cfg = cfg
        # bound fault timeline (repro_torch.faults.FaultSchedule); the network
        # driver attaches it so routing and latency lookups become
        # health-aware. None = fault-free, every query short-circuits.
        self.fault_sched = None
        self.nodes: Dict[str, FleetNode] = {
            self.MEC: build_fleet_node(
                self.MEC, "mec", cfg.mec_gpu, cfg.mec_gpu_count, model=model,
                node_kind=node_kind, max_batch=max_batch,
            )
        }
        # ran_of[i] = name of site i's RAN node, or None
        self.ran_of: List[Optional[str]] = []
        for i, site in enumerate(cfg.sites):
            if site.ran_gpu is None:
                self.ran_of.append(None)
                continue
            name = f"ran:{site.name}"
            self.nodes[name] = build_fleet_node(
                name, "ran", site.ran_gpu, site.ran_gpu_count, site=i,
                model=model, node_kind=node_kind, max_batch=max_batch,
            )
            self.ran_of.append(name)

    def local_node(self, site: int) -> str:
        """The site's own RAN node, falling back to the MEC tier."""
        return self.ran_of[site] or self.MEC

    def candidates(self, site: int) -> List[str]:
        """Every node a job from `site` could be routed to, local first."""
        local = self.ran_of[site]
        out = [local] if local else []
        out += [n for n in self.ran_of if n and n != local]
        out.append(self.MEC)
        return out

    def healthy_candidates(self, site: int, now: float) -> List[str]:
        """`candidates` filtered through the bound fault schedule: nodes
        that are up (with recovery hysteresis, so flapping nodes don't
        thrash load-aware policies) and reachable over an up link.

        Degrades gracefully: if the filter empties the pool, fall back to
        nodes that are merely up (ignoring hysteresis and link state),
        then to the full candidate list — routing must always return
        *something*; undeliverable dispatches are the retry machinery's
        problem, not the router's."""
        cands = self.candidates(site)
        sched = self.fault_sched
        if sched is None:
            return cands
        up = [n for n in cands
              if sched.routable(n, now) and not sched.link_down(site, n, now)]
        if up:
            return up
        up = [n for n in cands if not sched.node_down(n, now)]
        return up or cands

    def wireline_latency(self, site: int, node_name: str,
                         now: Optional[float] = None) -> float:
        """gNB-of-`site` -> `node_name` wireline latency (s).

        With a bound fault schedule and a dispatch time `now`, link
        degradation windows inflate the latency and a *down* link buffers
        the job at the gNB until the link recovers (store-and-forward).
        Without `now` (or fault-free) this is the static lookup."""
        s = self.cfg.sites[site]
        if node_name == self.MEC:
            base = s.t_backhaul_mec
        elif node_name == self.ran_of[site]:
            base = s.t_fronthaul
        else:
            base = self.cfg.t_inter_site
        if now is None or self.fault_sched is None:
            return base
        return self.fault_sched.link_latency(site, node_name, base, now)


def three_cell_hetero(
    n_ues_per_cell: int = 20,
    mec_gpu_count: int = 2,
) -> TopologyConfig:
    """The default study deployment: three cells with unequal compute — a
    2xH100 aggregation site, a single-GH200 site, and a compute-less small
    cell — sharing a pooled GH200 MEC tier. Under `local_only` the small
    cell leans on the MEC and the H100 site saturates first; routing
    policies decide whether that imbalance costs capacity."""
    return TopologyConfig(
        sites=(
            SiteConfig("cell0", n_ues=n_ues_per_cell, ran_gpu="h100",
                       ran_gpu_count=2),
            SiteConfig("cell1", n_ues=n_ues_per_cell, ran_gpu="gh200-nvl2"),
            SiteConfig("cell2", n_ues=n_ues_per_cell, ran_gpu=None),
        ),
        mec_gpu_count=mec_gpu_count,
    )
