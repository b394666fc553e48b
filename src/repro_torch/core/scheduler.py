"""Compute-node job scheduling (paper §IV-B "Priority-Based Job Queueing").

The computing node keeps a queue of inference jobs. Two disciplines:

  * ``fifo``      — the 5G-MEC baseline: jobs served in arrival order.
  * ``priority``  — the ICC scheme: the queue is ordered by the value
        T_gen + b_total - T_comm^{UE-BS}
    (paper's exact priority), i.e. jobs whose remaining slack after the
    communication stage is smallest are served first. Any job whose
    *predicted* completion would exceed its deadline T_gen + b_total is
    dropped on dequeue (paper: "Any job expected to leave the computing
    node's queue after T_gen + b_total is dropped").

Latency-management mode decides the *drop horizon* under disjoint
management: a job is additionally infeasible once the computing sub-budget
b_comp would be exceeded (the paper's disjoint success criterion, Eq. 4).

The scheduler is engine-agnostic: service times come from a callable
(analytic `LatencyModel.job_latency`, a measured table from the real JAX
engine, or an Exp sampler for the queueing-theory cross-check).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Literal, Optional, Protocol, Tuple, runtime_checkable

__all__ = ["Job", "ComputeNode", "ComputeNodeProtocol"]


@dataclasses.dataclass
class Job:
    uid: int
    ue: int
    t_gen: float  # generation time at the UE
    n_input: int
    n_output: int
    b_total: float  # end-to-end latency budget
    bits: float = 0.0  # uplink payload
    cell: int = 0  # originating gNB site (multi-cell topologies)
    route: str = ""  # compute node the router chose ("" = single-node sim)
    # filled in as the job moves through the system
    t_compute_arrival: float = float("nan")  # arrival at compute queue
    t_complete: float = float("nan")
    # first decode token's emission time (token-granular nodes only; the
    # whole-job ComputeNode leaves it NaN and score_jobs skips TTFT/TBT)
    t_first_token: float = float("nan")
    dropped: bool = False
    # False when an admission controller rejected the job at generation
    # (it never entered the uplink; also marked dropped)
    admitted: bool = True
    # structured loss attribution, set wherever `dropped` is set:
    #   queue_drop        infeasible at dispatch/admission (deadline math)
    #   deadline_preempt  running job preempted mid-generation (batched)
    #   kv_reject         KV reservation can never fit the cache
    #   quota             admission controller rejected at generation
    #   node_failure      lost to a node crash / undeliverable while down
    # None for completed jobs and for jobs still in-system at sim end
    # (score_jobs books those as "unfinished")
    drop_reason: Optional[str] = None

    @property
    def t_comm(self) -> float:
        """T_comm^{UE-BS} + wireline, as observed by the compute node."""
        return self.t_compute_arrival - self.t_gen

    @property
    def deadline(self) -> float:
        return self.t_gen + self.b_total

    @property
    def priority(self) -> float:
        # Paper §IV-B: priority value = T_gen + b_total - T_comm^{UE-BS}.
        # Smaller value = less slack = served first.
        return self.t_gen + self.b_total - self.t_comm

    @property
    def e2e(self) -> float:
        return self.t_complete - self.t_gen


@runtime_checkable
class ComputeNodeProtocol(Protocol):
    """What `SlotEngine`/`simulate()`, the fleet, and the routing policies
    need from a compute node. Implemented by the whole-job `ComputeNode`
    below and the token-granular `repro.batching.BatchedComputeNode`.

    * ``busy_until`` — time up to which the node's timeline is committed.
    * ``completed`` / ``dropped`` — terminal job lists.
    * ``submit(job)`` — enqueue a delivered job (``t_compute_arrival`` set).
    * ``run_until(now)`` — advance the node's clock to the slot boundary.
    * ``pending_jobs()`` — queued-but-not-started jobs (undefined order).
    * ``estimated_free_at(now)`` — routing's load estimate: earliest time a
      job arriving now could start.
    * ``__len__`` — queue-depth proxy for least-loaded routing.
    """

    busy_until: float
    completed: List[Job]
    dropped: List[Job]

    def submit(self, job: Job) -> None: ...

    def run_until(self, now: float) -> None: ...

    def pending_jobs(self) -> List[Job]: ...

    def estimated_free_at(self, now: float) -> float: ...

    def __len__(self) -> int: ...


class ComputeNode:
    """Single-server (optionally batched) compute node with pluggable policy."""

    def __init__(
        self,
        service_time: Callable[[Job], float],
        policy: Literal["fifo", "priority"] = "fifo",
        drop_infeasible: bool = False,
        comp_budget: Optional[float] = None,  # disjoint-mode b_comp drop horizon
        deterministic_service: bool = False,
    ):
        self.service_time = service_time
        self.policy = policy
        self.drop_infeasible = drop_infeasible
        self.comp_budget = comp_budget
        # Deterministic service times (an analytic LatencyModel) may be drawn
        # once at submit and cached: `estimated_free_at` becomes O(1) via a
        # running queued-work sum instead of re-invoking service_time per
        # queued job per routing query. Stochastic samplers must keep the
        # default (False): drawing at submit would consume RNG at a different
        # point in the stream than the dispatch-time draw (queueing
        # Monte-Carlo cross-check), so they keep the dispatch-time call and
        # the O(queue) estimate path.
        self.deterministic_service = deterministic_service
        self._svc_cache: dict[int, float] = {}  # id(job) -> predicted service
        self._queued_work = 0.0  # sum of cached service over queued jobs
        self._heap: List[Tuple[float, int, Job]] = []
        self._seq = itertools.count()
        self.busy_until = 0.0
        self.completed: List[Job] = []
        self.dropped: List[Job] = []
        # telemetry (repro.telemetry): drivers wire an *active* recorder
        # here (never a NullRecorder — they normalize via telemetry.active),
        # so instrumentation costs one None-check when tracing is off
        self.recorder = None
        self.telemetry_name = "node"
        # fault injection (repro.faults): optional brownout hook mapping
        # dispatch time -> service-time multiplier; None = nominal speed
        # (guard keeps the fault-free path bit-identical by construction)
        self.speed_scale: Optional[Callable[[float], float]] = None

    def __len__(self) -> int:
        return len(self._heap)

    def pending_jobs(self) -> List[Job]:
        """Jobs queued but not yet dispatched (undefined order)."""
        return [job for _, _, job in self._heap]

    def estimated_free_at(self, now: float) -> float:
        """Earliest time the server could start a job arriving now: the
        in-service job's finish plus the predicted service of everything
        queued ahead. Routing policies use this; it is an estimate (the
        queue may reorder under `priority`, drops may shorten it).

        With ``deterministic_service`` the queued-work sum is maintained
        incrementally (invalidated on submit/dispatch/drop), so each query
        is O(1). Otherwise each query re-invokes ``service_time`` per
        queued job; a stochastic sampler would both consume extra RNG draws
        (shifting dispatch-time results) and return noise, so keep
        stochastic-service nodes out of load-predictive routing."""
        t = max(self.busy_until, now)
        if self.deterministic_service:
            return t + self._queued_work
        for job in self.pending_jobs():
            t += self.service_time(job)
        return t

    def submit(self, job: Job) -> None:
        key = job.t_compute_arrival if self.policy == "fifo" else job.priority
        heapq.heappush(self._heap, (key, next(self._seq), job))
        if self.deterministic_service:
            svc = self.service_time(job)
            self._svc_cache[id(job)] = svc
            self._queued_work += svc
        if self.recorder is not None:
            self.recorder.job_event(
                "queue_enter", job.uid, job.t_compute_arrival,
                node=self.telemetry_name,
            )

    def _drop_horizon(self, job: Job) -> float:
        if self.comp_budget is not None:
            # Disjoint management: the compute stage has its own sub-budget.
            return min(job.deadline, job.t_compute_arrival + self.comp_budget)
        return job.deadline

    def run_until(self, now: float) -> None:
        """Serve queued jobs while the server can start before `now`.

        Non-preemptive single server: each time the server frees, the
        highest-priority job *then queued* starts. Caller must advance `now`
        in small steps (the simulator's slot loop) so that jobs arriving
        while the server is busy are present for the next dispatch.
        """
        rec = self.recorder
        while self._heap and self.busy_until <= now:
            _, _, job = heapq.heappop(self._heap)
            start = max(self.busy_until, job.t_compute_arrival)
            if self.deterministic_service:
                svc = self._svc_cache.pop(id(job))
                self._queued_work = max(self._queued_work - svc, 0.0)
            else:
                svc = self.service_time(job)
            if self.speed_scale is not None:
                svc *= self.speed_scale(start)
            if self.drop_infeasible and start + svc > self._drop_horizon(job):
                job.dropped = True
                job.drop_reason = "queue_drop"
                self.dropped.append(job)
                if rec is not None:
                    rec.job_event("drop", job.uid, start, stage="queue",
                                  reason="queue_drop")
                continue
            job.t_complete = start + svc
            self.busy_until = job.t_complete
            self.completed.append(job)
            if rec is not None:
                # whole-job node: the entire inference pass books as one
                # dispatch (the recorder attributes `svc` to `decode`)
                rec.job_event("dispatch", job.uid, start, svc=svc)
                rec.job_event("complete", job.uid, job.t_complete)

    def crash(self, t: float, t_recover: float) -> List[Job]:
        """Node failure at ``t``: lose the queue and the in-service job.

        Caller must ``run_until(t)`` first. Returns the affected jobs
        (queued plus the at-most-one job whose completion lay beyond
        ``t``) for the driver to drop with reason ``node_failure`` or
        re-dispatch via routing; the node stays unavailable until
        ``t_recover`` (``busy_until`` pins there).
        """
        affected: List[Job] = []
        # the non-preemptive loop completes jobs eagerly, so at most one
        # entry in `completed` can still lie in the future at time t —
        # that is the in-service job the crash kills mid-inference
        while self.completed and self.completed[-1].t_complete > t:
            job = self.completed.pop()
            job.t_complete = float("nan")
            affected.append(job)
        while self._heap:
            _, _, job = heapq.heappop(self._heap)
            affected.append(job)
        self._svc_cache.clear()
        self._queued_work = 0.0
        self.busy_until = max(t_recover, t)
        return affected
