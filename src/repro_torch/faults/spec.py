"""Declarative fault specifications (the port's copy of
`repro/faults/spec.py`, field for field).

Faults are described as frozen, serializable dataclasses so a fault
scenario can live on an experiment spec and round-trip through JSON
exactly like the rest of the spec tree. Nothing here draws randomness or
touches simulation state — binding a spec to a concrete seeded timeline
happens in :mod:`repro_torch.faults.schedule`.

Faults are strictly opt-in: an absent (``None``) FaultSpec and an empty
``FaultSpec()`` must both leave every fixed-seed result bit-identical
to the fault-free simulator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = [
    "NodeOutage",
    "NodeCrashProcess",
    "LinkOutage",
    "Brownout",
    "FaultSpec",
]


@dataclass(frozen=True)
class NodeOutage:
    """Explicit crash/recovery window for one compute node.

    ``node`` names a fleet node ("mec", "ran:cell0", ...) in network
    sims, or is ignored in single-cell sims (the single node crashes).
    """

    node: str
    t_fail: float
    t_recover: float

    def __post_init__(self):
        if not self.t_fail >= 0.0:
            raise ValueError("t_fail must be >= 0")
        if not self.t_recover > self.t_fail:
            raise ValueError("t_recover must be > t_fail")


@dataclass(frozen=True)
class NodeCrashProcess:
    """Renewal crash process: alternating Exp(mtbf) up / Exp(mttr) down.

    Draws come from a dedicated salted RNG stream at bind time (same
    pattern as the MMPP chains), so the timeline depends only on
    (seed, spec salt, process salt) — never on simulation progress.
    """

    node: str
    mtbf_s: float
    mttr_s: float
    salt: int = 0

    def __post_init__(self):
        if not self.mtbf_s > 0.0:
            raise ValueError("mtbf_s must be > 0")
        if not self.mttr_s > 0.0:
            raise ValueError("mttr_s must be > 0")


@dataclass(frozen=True)
class LinkOutage:
    """Wireline outage or degradation window.

    ``site`` / ``node`` select which (source site, destination node)
    links are affected; ``None`` is a wildcard. With ``down=True`` the
    link is unusable (dispatches are retried/re-routed); otherwise the
    latency is inflated: ``lat * latency_factor + latency_add_s``.
    """

    t_fail: float
    t_recover: float
    site: Optional[int] = None
    node: Optional[str] = None
    down: bool = True
    latency_factor: float = 1.0
    latency_add_s: float = 0.0

    def __post_init__(self):
        if not self.t_fail >= 0.0:
            raise ValueError("t_fail must be >= 0")
        if not self.t_recover > self.t_fail:
            raise ValueError("t_recover must be > t_fail")
        if not self.latency_factor >= 1.0:
            raise ValueError("latency_factor must be >= 1")
        if not self.latency_add_s >= 0.0:
            raise ValueError("latency_add_s must be >= 0")


@dataclass(frozen=True)
class Brownout:
    """Per-node GPU slowdown window: service time × slow_factor."""

    node: str
    t_start: float
    t_end: float
    slow_factor: float

    def __post_init__(self):
        if not self.t_end > self.t_start >= 0.0:
            raise ValueError("need 0 <= t_start < t_end")
        if not self.slow_factor >= 1.0:
            raise ValueError("slow_factor must be >= 1")


@dataclass(frozen=True)
class FaultSpec:
    """The full fault scenario for one simulation.

    Recovery knobs:

    - ``redispatch``: jobs lost in a crash (queued or in-flight) are
      re-dispatched via routing with full re-prefill cost; when False
      they are dropped with reason ``node_failure``.
    - ``max_retries`` / ``retry_backoff_s``: bounded exponential
      backoff when a dispatch arrives at a down node.
    - ``hysteresis_s``: a recovered node is not routable again until
      it has been up this long (flap damping for health-aware routing).
    """

    node_outages: Tuple[NodeOutage, ...] = ()
    crash_processes: Tuple[NodeCrashProcess, ...] = ()
    link_outages: Tuple[LinkOutage, ...] = ()
    brownouts: Tuple[Brownout, ...] = ()
    redispatch: bool = True
    max_retries: int = 2
    retry_backoff_s: float = 0.02
    hysteresis_s: float = 0.25
    salt: int = 0

    def __post_init__(self):
        object.__setattr__(self, "node_outages", tuple(self.node_outages))
        object.__setattr__(self, "crash_processes",
                           tuple(self.crash_processes))
        object.__setattr__(self, "link_outages", tuple(self.link_outages))
        object.__setattr__(self, "brownouts", tuple(self.brownouts))
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff_s < 0.0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.hysteresis_s < 0.0:
            raise ValueError("hysteresis_s must be >= 0")

    @property
    def empty(self) -> bool:
        """True when the spec injects nothing (pure default knobs)."""
        return not (self.node_outages or self.crash_processes
                    or self.link_outages or self.brownouts)
