"""Bind a :class:`FaultSpec` to a concrete seeded fault timeline (the
port's copy of `repro/faults/schedule.py`, draw for draw).

All randomness is pre-drawn here from a dedicated salted RNG stream
(the MMPP-chain pattern in :mod:`repro_torch.control.arrivals`), so the
fault timeline depends only on ``(seed, spec.salt, process.salt)`` and
never on simulation progress — fast and reference engines see the
exact same schedule. Every fault time is snapped up to the slot grid
so continuous-time queries agree with the slot-stepped drivers.

The bound :class:`FaultSchedule` is a pure, read-only query object:
drivers consult it (``node_down`` / ``slow_factor`` / ``link_*`` /
``routable``) and feed ``node_events()`` into their event heaps; it
holds no mutable health state, which keeps replays deterministic.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .spec import FaultSpec

__all__ = ["FaultSchedule", "bind_faults", "NODE_FAIL", "NODE_RECOVER"]

# Dedicated RNG stream id for fault schedules ("FAUL"), alongside the
# MMPP stream in control.arrivals — keeps fault draws independent of
# every other consumer of the base seed.
_FAULT_STREAM = 0x4641554C

NODE_FAIL = "node_fail"
NODE_RECOVER = "node_recover"


def _merge(ivals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge overlapping/adjacent [t0, t1) intervals."""
    out: List[Tuple[float, float]] = []
    for t0, t1 in sorted(ivals):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


class FaultSchedule:
    """Immutable seeded fault timeline with pure point-in-time queries."""

    def __init__(self, spec: FaultSpec, slot_s: float, horizon_s: float,
                 down: Dict[str, List[Tuple[float, float]]],
                 brownouts: Dict[str, List[Tuple[float, float, float]]],
                 links: List[dict]):
        self.spec = spec
        self.slot_s = float(slot_s)
        self.horizon_s = float(horizon_s)
        self._down = {k: _merge(v) for k, v in down.items()}
        self._brown = {k: sorted(v) for k, v in brownouts.items()}
        self._links = sorted(links, key=lambda d: d["t_fail"])
        self.redispatch = spec.redispatch
        self.max_retries = spec.max_retries
        self.retry_backoff_s = spec.retry_backoff_s
        self.hysteresis_s = spec.hysteresis_s

    # -- node health ---------------------------------------------------

    def _node_ivals(self, node: Optional[str]) -> List[Tuple[float, float]]:
        if node is None:
            merged: List[Tuple[float, float]] = []
            for ivals in self._down.values():
                merged.extend(ivals)
            return _merge(merged)
        return self._down.get(node, [])

    def node_down(self, node: Optional[str], t: float) -> bool:
        """True when ``node`` (or any node, if None) is crashed at t."""
        for t0, t1 in self._node_ivals(node):
            if t0 <= t < t1:
                return True
            if t0 > t:
                break
        return False

    def down_until(self, node: Optional[str], t: float) -> Optional[float]:
        """Recovery time of the outage covering t, else None."""
        for t0, t1 in self._node_ivals(node):
            if t0 <= t < t1:
                return t1
            if t0 > t:
                break
        return None

    def routable(self, node: str, t: float,
                 hysteresis_s: Optional[float] = None) -> bool:
        """Health gate for routing: up, and up for >= hysteresis.

        A node inside an outage is not routable; a node that recovered
        less than ``hysteresis_s`` ago is still held out so flapping
        nodes don't thrash load-aware policies.
        """
        h = self.hysteresis_s if hysteresis_s is None else hysteresis_s
        for t0, t1 in self._node_ivals(node):
            if t0 <= t < t1 + h:
                return False
            if t0 > t:
                break
        return True

    def slow_factor(self, node: Optional[str], t: float) -> float:
        """Combined brownout slowdown multiplier at t (1.0 = nominal)."""
        f = 1.0
        if node is None:
            items = [iv for ivs in self._brown.values() for iv in ivs]
        else:
            items = self._brown.get(node, [])
        for t0, t1, factor in items:
            if t0 <= t < t1:
                f *= factor
        return f

    def has_node_faults(self, node: Optional[str] = None) -> bool:
        if node is None:
            return bool(self._down) or bool(self._brown)
        return bool(self._down.get(node)) or bool(self._brown.get(node))

    # -- links ---------------------------------------------------------

    def _link_matches(self, lk: dict, site: int, node: str) -> bool:
        return ((lk["site"] is None or lk["site"] == site)
                and (lk["node"] is None or lk["node"] == node))

    def link_down(self, site: int, node: str, t: float) -> bool:
        """True when the site->node wireline path is unusable at t."""
        for lk in self._links:
            if lk["t_fail"] > t:
                break
            if (lk["down"] and lk["t_fail"] <= t < lk["t_recover"]
                    and self._link_matches(lk, site, node)):
                return True
        return False

    def link_latency(self, site: int, node: str, base_s: float,
                     t: float) -> float:
        """Effective wireline latency for a dispatch at time t.

        Degradation windows inflate the base latency; a *down* window
        buffers the job at the gNB until the link recovers
        (store-and-forward), so the latency grows by the remaining
        outage. Naive policies (``mec_only``) pay this in full — the
        backhaul-outage survivability headline.
        """
        lat = base_s
        wait = 0.0
        for lk in self._links:
            if lk["t_fail"] > t:
                break
            if (lk["t_fail"] <= t < lk["t_recover"]
                    and self._link_matches(lk, site, node)):
                if lk["down"]:
                    wait = max(wait, lk["t_recover"] - t)
                else:
                    lat = lat * lk["latency_factor"] + lk["latency_add_s"]
        return wait + lat

    def has_brownouts(self, node: Optional[str] = None) -> bool:
        if node is None:
            return bool(self._brown)
        return bool(self._brown.get(node))

    # -- driver feed ---------------------------------------------------

    def node_events(self) -> List[Tuple[float, str, str]]:
        """All (t, kind, node) crash/recover instants, time-sorted."""
        ev: List[Tuple[float, str, str]] = []
        for node, ivals in sorted(self._down.items()):
            for t0, t1 in ivals:
                ev.append((t0, NODE_FAIL, node))
                ev.append((t1, NODE_RECOVER, node))
        ev.sort(key=lambda e: (e[0], e[1], e[2]))
        return ev

    def next_change_after(self, t: float) -> float:
        """Earliest fault boundary (node or brownout) strictly > t.

        Pure query used by idle fast-forward clamps; returns +inf when
        nothing changes after t.
        """
        best = math.inf
        for ivals in self._down.values():
            for t0, t1 in ivals:
                for x in (t0, t1):
                    if t < x < best:
                        best = x
        for ivals in self._brown.values():
            for t0, t1, _f in ivals:
                for x in (t0, t1):
                    if t < x < best:
                        best = x
        return best

    @property
    def empty(self) -> bool:
        return not (self._down or self._brown or self._links)


def bind_faults(spec: FaultSpec, slot_s: float, horizon_s: float,
                seed: int,
                node_names: Optional[Sequence[str]] = None) -> FaultSchedule:
    """Pre-draw the full fault timeline for one simulation.

    ``node_names``, when given, validates that every node-targeted
    fault names a real fleet node (typo guard); single-cell drivers
    pass None and query with ``node=None`` wildcards.
    """
    def snap(t: float) -> float:
        # snap up to the slot grid so fault instants coincide with the
        # slot-stepped drivers (keeps fast == reference engines)
        return int(math.ceil(float(t) / slot_s - 1e-9)) * slot_s

    known = set(node_names) if node_names is not None else None

    def check(node: str, what: str) -> None:
        if known is not None and node not in known:
            raise ValueError(
                f"{what} targets unknown node {node!r}; "
                f"fleet has {sorted(known)}")

    down: Dict[str, List[Tuple[float, float]]] = {}
    for o in spec.node_outages:
        check(o.node, "NodeOutage")
        t0, t1 = snap(o.t_fail), snap(o.t_recover)
        if t1 <= t0:
            t1 = t0 + slot_s
        if t0 < horizon_s:
            down.setdefault(o.node, []).append((t0, t1))

    for i, proc in enumerate(spec.crash_processes):
        check(proc.node, "NodeCrashProcess")
        rng = np.random.default_rng([
            int(seed) % (2 ** 32), _FAULT_STREAM,
            int(spec.salt) % (2 ** 32), int(i),
            int(proc.salt) % (2 ** 32)])
        t = 0.0
        while True:
            t += float(rng.exponential(proc.mtbf_s))
            if t >= horizon_s:
                break
            t_fail = snap(t)
            t += float(rng.exponential(proc.mttr_s))
            t_rec = snap(t)
            if t_rec <= t_fail:
                t_rec = t_fail + slot_s
            if t_fail < horizon_s:
                down.setdefault(proc.node, []).append((t_fail, t_rec))

    brown: Dict[str, List[Tuple[float, float, float]]] = {}
    for b in spec.brownouts:
        check(b.node, "Brownout")
        t0, t1 = snap(b.t_start), snap(b.t_end)
        if t1 <= t0:
            t1 = t0 + slot_s
        if t0 < horizon_s:
            brown.setdefault(b.node, []).append((t0, t1, b.slow_factor))

    links: List[dict] = []
    for lk in spec.link_outages:
        if lk.node is not None:
            check(lk.node, "LinkOutage")
        t0, t1 = snap(lk.t_fail), snap(lk.t_recover)
        if t1 <= t0:
            t1 = t0 + slot_s
        if t0 < horizon_s:
            links.append({"t_fail": t0, "t_recover": t1, "site": lk.site,
                          "node": lk.node, "down": lk.down,
                          "latency_factor": lk.latency_factor,
                          "latency_add_s": lk.latency_add_s})

    return FaultSchedule(spec, slot_s, horizon_s, down, brown, links)
