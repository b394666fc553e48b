"""ICC-scheduled serving: the paper's §IV-B priority scheme driving a REAL
inference engine (beyond-paper: the compute node is not an analytic box).

Requests arrive with an observed communication latency T_comm (from the
SLS channel model or a trace) and a deadline t_gen + b_total. Admission
into the engine's decode slots follows the paper's priority
    T_gen + b_total - T_comm        (least slack first)
with infeasibility dropping: a request predicted (via the engine's own
calibrated latency) to finish past its deadline is dropped at dequeue, as
in §IV-B. `policy="fifo"` gives the 5G-MEC baseline.

Time base: a virtual clock driven by *measured* engine latencies, so the
scheduling dynamics are real compute dynamics. The engine synchronises the
device before it returns from `submit` and `step`, so the clock advances by
device time, not by kernel-enqueue time.

The port's copy of `repro/serving/icc.py`, with the same semantics.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Literal, Optional, Tuple

from .engine import GenRequest, GenResult, InferenceEngine

__all__ = ["ICCRequest", "ServeStats", "ICCServer"]


@dataclasses.dataclass
class ICCRequest:
    req: GenRequest
    t_gen: float  # generation time at the UE
    t_comm: float  # observed UE->compute latency (air + wireline)
    b_total: float  # end-to-end latency budget
    route: str = "local"  # fleet node the network layer routed this job to

    @property
    def arrival(self) -> float:  # arrival at the compute queue
        return self.t_gen + self.t_comm

    @property
    def deadline(self) -> float:
        return self.t_gen + self.b_total

    @property
    def priority(self) -> float:  # paper §IV-B
        return self.t_gen + self.b_total - self.t_comm


@dataclasses.dataclass
class ServeStats:
    n_total: int = 0
    n_satisfied: int = 0
    n_dropped: int = 0
    e2e: List[float] = dataclasses.field(default_factory=list)
    # per-route breakdown (multi-cell traces tag requests with the fleet
    # node that served them; single-node serving is all "local")
    route_total: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter
    )
    route_satisfied: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter
    )

    @property
    def satisfaction(self) -> float:
        return self.n_satisfied / max(self.n_total, 1)

    def route_satisfaction(self, route: str) -> float:
        return self.route_satisfied.get(route, 0) / max(
            self.route_total.get(route, 0), 1
        )


class ICCServer:
    def __init__(
        self,
        engine: InferenceEngine,
        policy: Literal["priority", "fifo"] = "priority",
        drop_infeasible: bool = True,
        est_latency: Optional[float] = None,  # predicted service time (s)
    ):
        self.engine = engine
        self.policy = policy
        self.drop_infeasible = drop_infeasible
        self.est_latency = est_latency
        self._queue: List[Tuple[float, int, ICCRequest]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.stats = ServeStats()
        self._inflight: Dict[int, ICCRequest] = {}

    def offer(self, r: ICCRequest) -> None:
        key = r.priority if self.policy == "priority" else r.arrival
        heapq.heappush(self._queue, (key, next(self._seq), r))
        self.stats.n_total += 1
        self.stats.route_total[r.route] += 1

    def _admit(self) -> None:
        while self._queue and self.engine.free_slots():
            _, _, r = heapq.heappop(self._queue)
            if self.drop_infeasible and self.est_latency is not None:
                if self.now + self.est_latency > r.deadline:
                    self.stats.n_dropped += 1
                    continue
            t0 = time.perf_counter()
            self.engine.submit(r.req)
            self.now += time.perf_counter() - t0  # prefill advances the clock
            self._inflight[r.req.uid] = r

    def _reap(self) -> None:
        active = set(self.engine.active_uids())
        done = [uid for uid in self._inflight if uid not in active]
        for uid in done:
            r = self._inflight.pop(uid)
            e2e = self.now - r.t_gen  # virtual clock shares t_gen's timeline
            self.stats.e2e.append(e2e)
            if e2e <= r.b_total:
                self.stats.n_satisfied += 1
                self.stats.route_satisfied[r.route] += 1

    def run(self, requests: List[ICCRequest]) -> ServeStats:
        """Drive the event loop over a pre-generated arrival trace."""
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        while i < len(pending) or self._queue or self.engine.n_active:
            # deliver arrivals up to the virtual clock
            while i < len(pending) and pending[i].arrival <= self.now:
                self.offer(pending[i])
                i += 1
            self._admit()
            if self.engine.n_active:
                t0 = time.perf_counter()
                self.engine.step()
                self.now += time.perf_counter() - t0
            elif i < len(pending):
                self.now = max(self.now, pending[i].arrival)  # idle-skip
            self._reap()
        return self.stats
