"""Token-granular continuous-batching compute node (Orca/vLLM-style; the
port's copy of `repro/batching/node.py`, with the same tie-breaks).

`ComputeNode` serves whole jobs one at a time; real LLM serving advances in
*inference iterations*: every resident sequence generates one token per
forward pass, new prompts are chunk-prefilled in the same pass, and the
weights are read from HBM once per iteration rather than once per job — the
sharing that makes batched decode cheap. `BatchedComputeNode` simulates
exactly that loop on top of `LatencyModel.iteration_latency`:

  * **Admission.** Waiting jobs are ordered by the same disciplines as
    `ComputeNode` (``fifo`` arrival order / ``priority`` least slack). A job
    joins the running batch when (a) a batch slot is open (`max_batch`) and
    (b) its full KV reservation fits in HBM (`KVCache`) — head-of-line
    strict, so admission order equals queue order. Jobs that cannot meet
    their drop horizon even starting now are dropped at admission
    (paper §IV-B generalized to the batch setting).
  * **Iterations.** Each iteration decodes one token for every
    prefill-complete sequence and prefills one chunk (`prefill_chunk`
    tokens, or the whole prompt with ``chunked_prefill=False``) of the
    oldest still-prefilling job. Iteration latency is batch- and
    context-dependent via the extended latency model.
  * **Token-granular preemption.** At every iteration boundary a running
    job whose drop horizon has already passed is preempted and dropped,
    releasing its KV reservation immediately — the §IV-B dropping rule
    applied mid-generation instead of only at dispatch.
  * **Metrics.** Each job records `t_first_token` (end of the iteration
    producing its first decode token), from which `score_jobs` derives
    TTFT and TBT distributions.

With ``max_batch=1`` and ``chunked_prefill=False`` the loop degenerates to
the whole-job node: one prefill iteration (== `prefill_latency`) followed by
`n_output` solo decode iterations (summing to `decode_latency`), started in
the same order with the same drop rule — completion times match
`ComputeNode` exactly (see tests/test_torch_batching.py).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from time import perf_counter
from typing import List, Literal, Optional, Tuple

from ..core.latency_model import LatencyModel
from ..core.scheduler import Job
from .kv_cache import KVCache

__all__ = ["BatchedComputeNode", "BatchStats"]


@dataclasses.dataclass
class BatchStats:
    """Aggregate engine counters (benchmarks read these)."""

    n_iterations: int = 0
    decode_token_iterations: int = 0  # sum of decode batch sizes
    peak_batch: int = 0
    peak_kv_bytes: float = 0.0
    kv_blocked_iterations: int = 0  # slot open but head job's KV didn't fit
    preempted: int = 0  # running jobs dropped mid-generation
    kv_requeues: int = 0  # head sent to the back of the queue (kv_requeue)

    def avg_batch(self) -> float:
        return self.decode_token_iterations / max(self.n_iterations, 1)


@dataclasses.dataclass
class _Running:
    job: Job
    prefilled: int = 0
    generated: int = 0

    @property
    def context(self) -> int:
        """Tokens of KV this sequence attends over in a decode step."""
        return self.job.n_input + self.generated


class BatchedComputeNode:
    """Iteration-level batched server satisfying `ComputeNodeProtocol`."""

    def __init__(
        self,
        lm: LatencyModel,
        max_batch: int = 8,
        policy: Literal["fifo", "priority"] = "fifo",
        drop_infeasible: bool = False,
        comp_budget: Optional[float] = None,
        chunked_prefill: bool = True,
        prefill_chunk: int = 256,
        kv_cache: Optional[KVCache] = None,
        kv_requeue: bool = False,
        kv_requeue_max: int = 3,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if chunked_prefill and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 when chunking")
        if kv_requeue_max < 0:
            raise ValueError("kv_requeue_max must be >= 0")
        self.lm = lm
        self.max_batch = max_batch
        self.policy = policy
        self.drop_infeasible = drop_infeasible
        self.comp_budget = comp_budget
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk = prefill_chunk
        # Opt-in relief for head-of-line KV blocking: a head job whose
        # reservation doesn't fit *right now* is re-queued to the back
        # (bounded times, deadline-aware give-up -> kv_reject) instead of
        # stalling admission. Default off: tracked baselines and the
        # bit-identity pins exercise the strict head-of-line discipline.
        self.kv_requeue = kv_requeue
        self.kv_requeue_max = kv_requeue_max
        self._requeues: dict[int, int] = {}  # id(job) -> requeue count
        self.kv = kv_cache if kv_cache is not None else KVCache(lm.hw, lm.model)
        self._heap: List[Tuple[float, int, Job]] = []
        self._seq = itertools.count()
        self._running: List[_Running] = []
        self._waiting_work = 0.0  # sum of solo service over queued jobs
        self.busy_until = 0.0
        self.completed: List[Job] = []
        self.dropped: List[Job] = []
        self.stats = BatchStats()
        # telemetry (repro_torch.telemetry): drivers wire an *active* recorder
        # here; every event site is behind a single None-check
        self.recorder = None
        self.telemetry_name = "node"
        # host phase profiler (repro_torch.telemetry.profile): drivers wire an
        # active profiler here; the admission path self-times through it
        self.profiler = None
        # fault injection (repro_torch.faults): optional brownout hook mapping
        # iteration start time -> latency multiplier; None = nominal speed
        self.speed_scale = None

    # ------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return len(self._heap) + len(self._running)

    def pending_jobs(self) -> List[Job]:
        """Jobs queued but not yet admitted to the batch (undefined order)."""
        return [job for _, _, job in self._heap]

    def submit(self, job: Job) -> None:
        key = job.t_compute_arrival if self.policy == "fifo" else job.priority
        heapq.heappush(self._heap, (key, next(self._seq), job))
        self._waiting_work += self._svc_solo(job)
        if self.recorder is not None:
            self.recorder.job_event(
                "queue_enter", job.uid, job.t_compute_arrival,
                node=self.telemetry_name,
            )

    def estimated_free_at(self, now: float) -> float:
        """Routing's load estimate: earliest time a job arriving now could
        *start generating*. O(1): an open batch slot means (roughly) now;
        a full batch frees a slot when its closest-to-done member drains;
        waiting work is amortized across the batch width."""
        t = max(self.busy_until, now)
        if self._running and len(self._running) >= self.max_batch:
            step = self.lm.iteration_latency(
                0, len(self._running), sum(r.context for r in self._running)
            )
            t += step * min(
                r.job.n_output - r.generated + self._prefill_iters_left(r)
                for r in self._running
            )
        return t + self._waiting_work / self.max_batch

    def _prefill_iters_left(self, r: _Running) -> int:
        rem = r.job.n_input - r.prefilled
        if rem <= 0:
            return 0
        return math.ceil(rem / self.prefill_chunk) if self.chunked_prefill else 1

    def predicted_service(self, job: Job) -> float:
        """Predicted wall-clock from generation start to last token if
        `job` joined the batch in its current composition.

        Routing uses this instead of the solo whole-job latency: a batched
        node serves the job in ``prefill_chunks + n_output`` iterations
        whose cost is shared across the batch, so quoting
        ``LatencyModel.job_latency`` (one sequence, whole pass) would make
        `slack_aware` systematically over-estimate batched fleets and
        misroute (ROADMAP item)."""
        batch = min(len(self._running) + 1, self.max_batch)
        if batch <= 1:
            return self._svc_solo(job)
        context = sum(r.context for r in self._running) + job.n_input
        iters = job.n_output
        if self.chunked_prefill:
            iters += math.ceil(job.n_input / self.prefill_chunk)
        else:
            iters += 1
        return iters * self.lm.iteration_latency(0, batch, context)

    # ------------------------------------------------------------ internals
    def _svc_solo(self, job: Job) -> float:
        return self.lm.job_latency(job.n_input, job.n_output)

    def _drop_horizon(self, job: Job) -> float:
        if self.comp_budget is not None:
            return min(job.deadline, job.t_compute_arrival + self.comp_budget)
        return job.deadline

    def _admit(self, t: float) -> None:
        """Move queue heads into the batch while slots + KV allow (at time t)."""
        rec = self.recorder
        requeued_now: set = set()  # ids sent to the back during this call
        while self._heap and len(self._running) < self.max_batch:
            _, _, job = self._heap[0]
            if job.t_compute_arrival > t:
                break  # not at the node yet (direct-driven tests)
            svc = self._svc_solo(job)
            if self.drop_infeasible and t + svc > self._drop_horizon(job):
                heapq.heappop(self._heap)
                self._waiting_work = max(self._waiting_work - svc, 0.0)
                self._requeues.pop(id(job), None)
                job.dropped = True
                job.drop_reason = "queue_drop"
                self.dropped.append(job)
                if rec is not None:
                    rec.job_event("drop", job.uid, t, stage="queue",
                                  reason="queue_drop")
                continue
            if not self.kv.can_admit(job):
                if self.kv.job_bytes(job) > self.kv.capacity_bytes:
                    # can never fit, even alone: unservable on this node
                    heapq.heappop(self._heap)
                    self._waiting_work = max(self._waiting_work - svc, 0.0)
                    job.dropped = True
                    job.drop_reason = "kv_reject"
                    self.dropped.append(job)
                    if rec is not None:
                        rec.job_event("drop", job.uid, t,
                                      stage="kv_unservable",
                                      reason="kv_reject")
                    continue
                if self.kv_requeue and id(job) not in requeued_now:
                    n = self._requeues.get(id(job), 0)
                    if n >= self.kv_requeue_max or t >= self._drop_horizon(job):
                        # waited long enough (bounded retries, or the drop
                        # horizon already passed): give up as a KV reject
                        heapq.heappop(self._heap)
                        self._waiting_work = max(self._waiting_work - svc, 0.0)
                        self._requeues.pop(id(job), None)
                        job.dropped = True
                        job.drop_reason = "kv_reject"
                        self.dropped.append(job)
                        if rec is not None:
                            rec.job_event("drop", job.uid, t,
                                          stage="kv_wait", reason="kv_reject")
                        continue
                    # send the head to the back so later arrivals with
                    # smaller reservations can use the open slot
                    heapq.heappop(self._heap)
                    key = t if self.policy == "fifo" else job.priority
                    heapq.heappush(self._heap, (key, next(self._seq), job))
                    self._requeues[id(job)] = n + 1
                    requeued_now.add(id(job))
                    self.stats.kv_requeues += 1
                    continue
                # Head-of-line blocking by design: admission is strictly in
                # queue order, the cache is the binding resource.
                self.stats.kv_blocked_iterations += 1
                break
            heapq.heappop(self._heap)
            self._waiting_work = max(self._waiting_work - svc, 0.0)
            self._requeues.pop(id(job), None)
            self.kv.admit(job)
            self._running.append(_Running(job))
            if rec is not None:
                rec.job_event("admit", job.uid, t)

    def _preempt_expired(self, t: float) -> None:
        """§IV-B dropping at token granularity: a running job whose horizon
        has passed cannot deliver its remaining tokens in time — free its
        batch slot and KV reservation now."""
        if not self.drop_infeasible:
            return
        keep: List[_Running] = []
        for r in self._running:
            if t >= self._drop_horizon(r.job) and r.generated < r.job.n_output:
                self.kv.release(r.job)
                r.job.dropped = True
                r.job.drop_reason = "deadline_preempt"
                self.dropped.append(r.job)
                self.stats.preempted += 1
                if self.recorder is not None:
                    self.recorder.job_event("preempt", r.job.uid, t,
                                            reason="deadline_preempt")
            else:
                keep.append(r)
        self._running = keep

    def run_until(self, now: float) -> None:
        """Run inference iterations while one can start at or before `now`.

        Mirrors `ComputeNode.run_until`'s contract: the caller advances
        `now` slot by slot so jobs delivered mid-iteration are present for
        the next iteration boundary.
        """
        rec = self.recorder
        prof = self.profiler
        while self.busy_until <= now and (self._running or self._heap):
            t = self.busy_until
            if not self._running:
                # idle: the next iteration starts when the head job arrives
                t = max(t, self._heap[0][2].t_compute_arrival)
            if prof is not None:
                t0 = perf_counter()
                self._preempt_expired(t)
                self._admit(t)
                prof.add_sub("batch_admission", perf_counter() - t0)
            else:
                self._preempt_expired(t)
                self._admit(t)
            # zero-output jobs are done the moment prefill is (t equals the
            # end of their last prefill iteration): no decode pass, no
            # t_first_token — matching ComputeNode's prefill-only latency
            for r in [r for r in self._running
                      if r.job.n_output <= 0 and r.prefilled >= r.job.n_input]:
                r.job.t_complete = t
                self.kv.release(r.job)
                self._running.remove(r)
                self.completed.append(r.job)
                if rec is not None:
                    rec.job_event("complete", r.job.uid, t)
            if not self._running:
                if not self._heap:
                    break
                continue  # admission dropped jobs; retry from the new head

            decode = [r for r in self._running
                      if r.prefilled >= r.job.n_input
                      and r.generated < r.job.n_output]
            prefiller = next(
                (r for r in self._running if r.prefilled < r.job.n_input), None
            )
            chunk = 0
            if prefiller is not None:
                remaining = prefiller.job.n_input - prefiller.prefilled
                chunk = (
                    min(self.prefill_chunk, remaining)
                    if self.chunked_prefill
                    else remaining
                )
            context = sum(r.context for r in decode)
            if prefiller is not None:
                context += prefiller.prefilled
            dt = self.lm.iteration_latency(chunk, len(decode), context)
            if self.speed_scale is not None:
                dt *= self.speed_scale(t)
            t_end = t + dt
            self.busy_until = t_end

            self.stats.n_iterations += 1
            self.stats.decode_token_iterations += len(decode)
            self.stats.peak_batch = max(self.stats.peak_batch, len(self._running))
            self.stats.peak_kv_bytes = max(
                self.stats.peak_kv_bytes, self.kv.used_bytes
            )

            if prefiller is not None:
                prefiller.prefilled += chunk
                if rec is not None:
                    rec.job_event(
                        "prefill", prefiller.job.uid, t_end, dt=dt, tokens=chunk
                    )
            if rec is not None:
                # every resident decode sequence experiences the full
                # iteration wall-clock (residual iterations — resident but
                # neither prefilling nor decoding — become `stall`)
                for r in decode:
                    rec.job_event("decode", r.job.uid, t_end, dt=dt)
                rec.sample(f"{self.telemetry_name}.batch", t_end, {
                    "batch": float(len(self._running)),
                    "decode": float(len(decode)),
                    "queued": float(len(self._heap)),
                    "kv_bytes": float(self.kv.used_bytes),
                })
            done: List[_Running] = []
            for r in decode:
                r.generated += 1
                if r.generated == 1:
                    r.job.t_first_token = t_end
                    if rec is not None:
                        rec.job_event("first_token", r.job.uid, t_end)
                if r.generated >= r.job.n_output:
                    r.job.t_complete = t_end
                    done.append(r)
            for r in done:
                self.kv.release(r.job)
                self._running.remove(r)
                self.completed.append(r.job)
                if rec is not None:
                    rec.job_event("complete", r.job.uid, t_end)

    def crash(self, t: float, t_recover: float) -> List[Job]:
        """Node failure at ``t``: lose queue, in-flight batch, KV cache.

        Caller must ``run_until(t)`` first. Jobs whose completion the
        iteration loop had already booked beyond ``t`` are un-completed
        (the iteration they rode never finished); resident sequences
        lose their KV reservation and all generated tokens. Returns the
        affected jobs for the driver to drop (``node_failure``) or
        re-dispatch — a re-dispatched job re-enters as a fresh sequence
        and pays full re-prefill. The node stays unavailable until
        ``t_recover``.
        """
        affected: List[Job] = []
        # completions are booked at iteration end, which can lie past the
        # last run_until horizon — those iterations never actually ran
        while self.completed and self.completed[-1].t_complete > t:
            job = self.completed.pop()
            job.t_complete = float("nan")
            job.t_first_token = float("nan")
            affected.append(job)
        for r in self._running:
            self.kv.release(r.job)
            r.job.t_first_token = float("nan")
            affected.append(r.job)
        self._running = []
        while self._heap:
            _, _, job = heapq.heappop(self._heap)
            affected.append(job)
        self._waiting_work = 0.0
        self._requeues.clear()
        self.busy_until = max(t_recover, t)
        return affected
