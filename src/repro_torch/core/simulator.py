"""System-level simulator for ICC vs 5G MEC (paper §IV, Fig. 5).

Pipeline per job (real-time translation on AR glasses, Table I):

  UE generates job (Poisson, rate lambda/UE)
    -> uplink packets over the 5G air interface   (channel.UplinkChannel)
    -> wireline hop gNB -> computing node          (constant, 5 or 20 ms)
    -> compute queue + LLM inference               (scheduler.ComputeNode)

The per-slot pipeline (arrivals -> uplink -> wireline hand-off) lives in
`SlotEngine`, one instance per cell. The single-cell `simulate()` below is
a thin wrapper: one SlotEngine feeding one ComputeNode. The multi-cell
deployment (`repro_torch.network`) instantiates one SlotEngine per gNB site and
routes wireline deliveries across a heterogeneous compute fleet.

Schemes (paper §III-B / §IV-C):

  * ``icc``           joint mgmt, RAN node (5 ms), packet priority,
                      priority queue + deadline drop.
  * ``disjoint_ran``  disjoint mgmt, RAN node (5 ms), no packet priority,
                      FIFO compute, sub-budget drop.
  * ``disjoint_mec``  disjoint mgmt, MEC node (20 ms): the 5G-MEC baseline.

Satisfaction (Def. 1): joint   -> T_E2E <= b_total;
                       disjoint-> T_E2E <= b_total  AND  T_comm <= b_comm
                                  AND T_comp <= b_comp.

This is the port's copy of `repro/core/simulator.py`, draw for draw: fixed
seeds give the same `SimResult`s, with the control loop (`controller=`) and
fault injection (`faults=`). Link faults need the multi-cell simulator,
`repro_torch.network.simulate_network`.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Callable, Dict, Iterator, List, Literal, Optional

import numpy as np

from time import perf_counter

from ..control.arrivals import ArrivalProcess, BoundArrivals, bind_arrivals
from ..telemetry.profile import active_profiler
from ..telemetry.recorder import active as _active_recorder
from .channel import ChannelConfig, UplinkChannel
from .latency_model import LatencyModel
from .scheduler import ComputeNode, ComputeNodeProtocol, Job

__all__ = [
    "SchemeConfig",
    "SimConfig",
    "SimResult",
    "SCHEMES",
    "SlotEngine",
    "score_jobs",
    "simulate",
]


@dataclasses.dataclass(frozen=True)
class SchemeConfig:
    name: str
    t_wireline: float
    packet_priority: bool
    compute_policy: Literal["fifo", "priority"]
    management: Literal["joint", "disjoint"]
    b_comm: float = 0.024  # paper §III-B split
    b_comp: float = 0.056
    drop_infeasible: bool = True


# Deadline-aware dropping is part of ICC's joint latency management
# (§IV-B "any job expected to leave ... is dropped"); the 5G-MEC disjoint
# baselines have no deadline awareness, so they queue doomed jobs (FIFO).
SCHEMES: Dict[str, SchemeConfig] = {
    "icc": SchemeConfig("icc", 0.005, True, "priority", "joint"),
    "disjoint_ran": SchemeConfig(
        "disjoint_ran", 0.005, False, "fifo", "disjoint", drop_infeasible=False
    ),
    "disjoint_mec": SchemeConfig(
        "disjoint_mec", 0.020, False, "fifo", "disjoint", drop_infeasible=False
    ),
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_ues: int = 60
    lam_per_ue: float = 1.0  # jobs/s/UE (Table I)
    n_input: int = 15
    n_output: int = 15
    b_total: float = 0.080
    sim_time: float = 30.0
    warmup: float = 2.0
    seed: int = 0
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    # arrival-process spec (repro.control.arrivals); None = stationary
    # Poisson at lam_per_ue, bit-identical to the pre-control engine
    arrivals: Optional[ArrivalProcess] = None
    # transient-metric window length: score_jobs additionally reports
    # per-window satisfaction over the scoring span (None = off)
    window_s: Optional[float] = None


@dataclasses.dataclass
class SimResult:
    scheme: str
    n_jobs: int
    satisfaction: float
    drop_rate: float
    avg_comm: float  # mean T_comm (UE->compute-node arrival), satisfied+unsatisfied
    avg_comp: float  # mean T_comp (queue + inference)
    avg_e2e: float
    avg_tokens_per_s: float  # paper Fig. 7 bar metric
    # tail latencies (None when no job completed in the scoring window)
    p95_e2e: Optional[float] = None
    p99_e2e: Optional[float] = None
    # token-granular serving metrics: only token-level nodes (repro.batching)
    # stamp Job.t_first_token; whole-job nodes leave these None.
    avg_ttft: Optional[float] = None  # time to first token, from t_gen
    p95_ttft: Optional[float] = None
    p99_ttft: Optional[float] = None
    avg_tbt: Optional[float] = None  # mean time between output tokens
    p95_tbt: Optional[float] = None
    p99_tbt: Optional[float] = None
    # transient satisfaction: one dict per scoring window (t0/t1/n/
    # satisfaction/drop_rate), present only when window_s was requested
    windows: Optional[List[dict]] = None
    # per-reason loss counts over the scored span (Job.drop_reason
    # glossary plus "unfinished" for jobs still in-system at sim end);
    # None when nothing was lost — sorted keys, so JSON is stable
    drop_reasons: Optional[Dict[str, int]] = None
    # columnar trace (repro.telemetry EventRecorder.to_telemetry), attached
    # only when the run was traced; None on every untraced run
    telemetry: Optional[dict] = None
    # host wall-clock phase attribution (repro.telemetry.profile), attached
    # only when the run was profiled; None on every unprofiled run
    profile: Optional[dict] = None

    def row(self) -> str:
        s = (
            f"{self.scheme:14s} jobs={self.n_jobs:6d} sat={self.satisfaction:6.3f} "
            f"drop={self.drop_rate:5.3f} comm={self.avg_comm*1e3:6.2f}ms "
            f"comp={self.avg_comp*1e3:6.2f}ms e2e={self.avg_e2e*1e3:6.2f}ms "
            f"tok/s={self.avg_tokens_per_s:7.1f}"
        )
        if self.avg_ttft is not None:
            s += (
                f" ttft={self.avg_ttft*1e3:6.1f}ms(p99={self.p99_ttft*1e3:6.1f})"
                f" tbt={self.avg_tbt*1e3:5.1f}ms"
            )
        return s


class _ArrivalChunk:
    """Pre-drawn arrival counts for a span of slots, consumed by cursor."""

    __slots__ = ("start", "end", "jrows", "jues", "jcnts", "jptr",
                 "brows", "bues", "bcnts", "bptr", "any_arrival")


class SlotEngine:
    """One cell's slot-stepped pipeline: UE arrivals -> uplink -> wireline.

    Owns the Poisson job generator, the per-UE burst queues, the uplink
    channel, and the wireline pipe. Compute is pluggable:

      * ``wireline(job, t_uplink_done)`` is called the instant a job's last
        uplink bit lands at the gNB and returns the gNB -> compute-node
        latency for that job. A multi-cell router makes its offload decision
        here (tagging ``job.route``) since this is where the gNB first owns
        the job.
      * ``deliver(job)`` is called once the wireline hop completes
        (``job.t_compute_arrival`` is already set); typically
        ``ComputeNode.submit``.

    The caller drives time: ``step(s)`` advances one slot and returns the
    slot-end timestamp, after which the caller runs its compute node(s) up
    to that time. This keeps compute ordering identical whether one engine
    feeds one node (single cell) or many engines share a fleet.

    Fast path (``fast=True``, the default): arrival counts for job bursts
    and background packets are pre-drawn in chunked ``(slots, 2, n_ues)``
    Poisson calls — NumPy's `Generator` fills C-order, so the bit stream
    consumed is identical to the original per-slot draws — and the slot body
    short-circuits the uplink step whenever the channel is idle. When the
    whole engine is idle (``is_idle``), the driver may skip straight to the
    next pre-drawn arrival with ``next_arrival_at_or_after`` +
    ``skip_slots`` (a pure fast-forward: compute nodes advance by
    `run_until`, so nothing else ticks per slot). ``fast=False`` keeps the
    original draw-per-slot reference path for equivalence testing; both
    produce bit-identical job timelines (tests/test_fast_sim.py).
    """

    def __init__(
        self,
        sim: SimConfig,
        rng: np.random.Generator,
        packet_priority: bool,
        wireline: Callable[[Job, float], float],
        deliver: Callable[[Job], None],
        cell: int = 0,
        uid_iter: Optional[Iterator[int]] = None,
        fast: bool = True,
        fast_forward: bool = True,
        chunk_slots: int = 4096,
        arrivals: Optional[BoundArrivals] = None,
        gate: Optional[Callable[[Job, float], bool]] = None,
        recorder=None,
        profiler=None,
    ):
        self.sim = sim
        # lifecycle-event recorder (repro.telemetry); normalized so the
        # disabled default costs one None-check at each event site
        self.recorder = _active_recorder(recorder)
        # host wall-clock phase profiler (repro.telemetry.profile); same
        # normalized-to-None discipline, read at the sub-phase hook sites
        self.profiler = active_profiler(profiler)
        self.rng = rng
        self.packet_priority = packet_priority
        self.wireline = wireline
        self.deliver = deliver
        self.cell = cell
        self.uid_iter = uid_iter if uid_iter is not None else itertools.count()
        self.channel = UplinkChannel(sim.channel, sim.n_ues, rng)
        self.slot = sim.channel.slot_s
        self.n_slots = int(math.ceil(sim.sim_time / self.slot))
        self.bits_per_job = sim.n_input * sim.channel.bytes_per_token * 8.0
        # arrival process: a pre-bound object (multi-cell driver, which
        # layers mobility presence on top) or the SimConfig's spec
        self.arrivals = arrivals if arrivals is not None else bind_arrivals(
            sim.arrivals, n_ues=sim.n_ues, lam_per_ue=sim.lam_per_ue,
            slot_s=self.slot, n_slots=self.n_slots, seed=sim.seed,
        )
        if (self.arrivals.n_ues, self.arrivals.n_slots) != (sim.n_ues, self.n_slots):
            raise ValueError("bound arrivals do not match the engine geometry")
        # constant per-slot rate on the stationary path (None otherwise:
        # the chunk fill / per-slot draws go through self.arrivals)
        self._lam_slot = (
            self.arrivals.rate_slot if self.arrivals.stationary else None
        )
        # admission gate (controller hook): called per generated job; a
        # False return drops the job before it enters the uplink
        self.gate = gate
        # mean uncontended uplink latency for one job burst (SR maturation
        # plus solo transmission): the controllers' per-cell comm floor
        mean_full = float(np.mean(self.channel._full_arr))
        self._carrier_bps = mean_full / self.slot
        self.uplink_floor_s = (
            sim.channel.sr_cycle_s + self.bits_per_job / self._carrier_bps
        )
        # jobs/s a clean carrier moves for this cell's job shape
        self.uplink_rate = self._carrier_bps / self.bits_per_job
        # per-UE FIFO of (job, remaining_bits) bursts awaiting uplink
        self._in_flight: Dict[int, collections.deque] = {
            u: collections.deque() for u in range(sim.n_ues)
        }
        self._n_in_flight = 0
        self.jobs: List[Job] = []
        self._wire_queue: List[Job] = []  # jobs in the wireline pipe
        self._wire_next = math.inf  # earliest t_compute_arrival in the pipe
        self.fast = fast
        self.fast_forward = fast and fast_forward
        self.slots_skipped = 0
        self.chunks_drawn = 0  # arrival chunk refills (profiler diagnostic)
        # chunked pre-draw state (fast path)
        self._chunk_slots = max(1, chunk_slots)
        self._chunks: collections.deque = collections.deque()
        self._drawn = 0  # slots of arrivals drawn so far
        self._lam_buf: Optional[np.ndarray] = None

    # ------------------------------------------------- pre-drawn arrivals
    def _draw_chunk(self) -> None:
        """Draw the next chunk of (job, background) arrival counts.

        One Poisson call over a ``(L, 2, n_ues)`` rate array consumes the
        generator exactly like L consecutive slots of the legacy
        ``poisson(lam_job, n_ues)`` + ``poisson(lam_bg, n_ues)`` pair.
        """
        prof = self.profiler
        t0 = perf_counter() if prof is not None else 0.0
        start = self._drawn
        length = min(self._chunk_slots, self.n_slots - start)
        if length <= 0:
            raise RuntimeError("arrival stream exhausted")
        if self._lam_buf is None:
            self._lam_buf = np.empty((self._chunk_slots, 2, self.sim.n_ues))
            if self.arrivals.stationary:
                self._lam_buf[:, 0, :] = self._lam_slot
            self._lam_buf[:, 1, :] = self.channel._bg_pkt_per_slot
        if not self.arrivals.stationary:
            # non-stationary process: this chunk's per-slot per-UE rates
            # (stationary keeps the one-time constant fill above, so the
            # buffer — and therefore the Poisson draw — is bit-identical
            # to the pre-abstraction engine)
            self.arrivals.fill(self._lam_buf[:length, 0, :], start)
        counts = self.rng.poisson(self._lam_buf[:length])
        # nonzero entries as flat row/ue/count lists consumed by a cursor:
        # rows come out of np.nonzero sorted, and the slot loop visits them
        # monotonically, so no per-slot lookup structure is needed
        ck = _ArrivalChunk()
        ck.start, ck.end = start, start + length
        rows, ues = np.nonzero(counts[:, 0, :])
        ck.jrows = rows.tolist()
        ck.jues = ues.tolist()
        ck.jcnts = counts[rows, 0, ues].tolist()
        ck.jptr = 0
        rows, ues = np.nonzero(counts[:, 1, :])
        ck.brows = rows.tolist()
        ck.bues = ues.tolist()
        ck.bcnts = counts[rows, 1, ues].tolist()
        ck.bptr = 0
        ck.any_arrival = counts.any(axis=(1, 2))
        self._chunks.append(ck)
        self._drawn = ck.end
        self.chunks_drawn += 1
        if prof is not None:
            prof.add_sub("arrival_draw", perf_counter() - t0)

    def _chunk_for(self, s: int) -> "_ArrivalChunk":
        """The chunk containing slot `s` (slots are consumed monotonically)."""
        while self._drawn <= s:
            self._draw_chunk()
        chunks = self._chunks
        while chunks[0].end <= s:
            chunks.popleft()
        return chunks[0]

    # --------------------------------------------------- fast-forward API
    def is_idle(self) -> bool:
        """Nothing in the air, the grant queues, or the wireline pipe."""
        return (
            self._n_in_flight == 0
            and not self._wire_queue
            and not self.channel.needs_step
        )

    def can_skip(self) -> bool:
        return self.fast_forward and self.is_idle()

    def next_arrival_at_or_after(self, s: int) -> int:
        """Smallest slot >= `s` with any pre-drawn arrival (or `n_slots`).

        Pure query: unlike the stepping path's `_chunk_for`, the search
        never discards chunks, because drivers may clamp the returned
        jump (controller epochs, probe cadence) and then step slots
        *before* the slot found here — the chunks in between must still
        hold their unconsumed arrivals. Chunk draws stay in strict order,
        so the RNG stream is identical either way.
        """
        while s < self.n_slots:
            while self._drawn <= s:
                self._draw_chunk()
            for ck in self._chunks:
                if ck.end <= s:
                    continue
                lo = s - ck.start if s > ck.start else 0
                hits = np.flatnonzero(ck.any_arrival[lo:])
                if hits.size:
                    return ck.start + lo + int(hits[0])
            s = self._drawn  # every drawn chunk past `s` is arrival-free
        return self.n_slots

    def next_event_at_or_after(self, s: int) -> int:
        """Smallest slot >= `s` the driver must actually execute: the next
        pre-drawn arrival *or* the arrival process's next forced wake (a
        rate-regime edge such as a flash-crowd onset). Drivers skip to this
        instead of the raw arrival cursor so a non-stationary source's
        regime changes — and, via the drivers' own clamps, controller
        epochs and mobility events — can't be fast-forwarded over."""
        return min(self.next_arrival_at_or_after(s), self.arrivals.next_wake(s))

    def skip_slots(self, s_from: int, s_to: int) -> None:
        """Fast-forward an idle engine across ``[s_from, s_to)``.

        The only per-slot state change on an idle engine is PDCCH credit
        accrual; replayed as repeated additions so the float trajectory
        matches the stepped engine exactly.
        """
        ch = self.channel
        for _ in range(s_to - s_from):
            ch.skip_slot()
        self.slots_skipped += s_to - s_from

    # -------------------------------------------------------------- step
    def step(self, s: int) -> float:
        """Advance one slot (index `s`); returns the slot-end time."""
        if not self.fast:
            return self._step_legacy(s)
        sim, ch = self.sim, self.channel
        now = s * self.slot
        ck = self._chunk_for(s)
        rel = s - ck.start
        # 1. arrivals at UEs (cursor over the chunk's nonzero entries)
        jrows = ck.jrows
        p = ck.jptr
        if p < len(jrows) and jrows[p] == rel:
            while p < len(jrows) and jrows[p] == rel:
                for _ in range(ck.jcnts[p]):
                    self._new_job(ck.jues[p], now)
                p += 1
            ck.jptr = p
        brows = ck.brows
        q = ck.bptr
        if q < len(brows) and brows[q] == rel:
            end = q + 1
            while end < len(brows) and brows[end] == rel:
                end += 1
            ck.bptr = end
            ch.apply_background_range(ck.bues, ck.bcnts, q, end, now)

        # 2. one slot of uplink (step_drain short-circuits an idle channel
        # to credit accrual on its own)
        t_slot_end = now + self.slot
        drained = ch.step_drain(now, self.packet_priority)
        if drained:
            for ue, bits in drained:
                self._complete_bursts(ue, bits, t_slot_end)

        # 3. hand over due wireline deliveries
        if self._wire_next <= t_slot_end:
            self._deliver_due(t_slot_end)
        return t_slot_end

    def _step_legacy(self, s: int) -> float:
        """Reference slot body: per-slot draws + whole-array channel step."""
        sim, ch = self.sim, self.channel
        now = s * self.slot
        if self._lam_slot is not None:  # stationary: the original call
            counts = self.rng.poisson(self._lam_slot, sim.n_ues)
        else:
            counts = self.rng.poisson(self.arrivals.rates_at(s))
        for ue in np.nonzero(counts)[0]:
            for _ in range(int(counts[ue])):
                self._new_job(int(ue), now)
        ch.add_background(now)

        drained = ch.step(now, prioritize_jobs=self.packet_priority)
        t_slot_end = now + self.slot
        for ue in np.nonzero(drained > 0)[0]:
            self._complete_bursts(int(ue), float(drained[ue]), t_slot_end)

        self._deliver_due(t_slot_end)
        return t_slot_end

    # ----------------------------------------------------------- helpers
    def _new_job(self, ue: int, now: float) -> None:
        sim = self.sim
        j = Job(next(self.uid_iter), ue, now, sim.n_input,
                sim.n_output, sim.b_total, bits=self.bits_per_job,
                cell=self.cell)
        self.jobs.append(j)
        rec = self.recorder
        if rec is not None:
            rec.job_event("generated", j.uid, now, cell=self.cell, ue=ue)
        if self.gate is not None and not self.gate(j, now):
            # admission control rejected the job at generation: it never
            # touches the uplink but still counts against satisfaction
            j.dropped = True
            j.admitted = False
            j.drop_reason = "quota"
            if rec is not None:
                rec.job_event("rejected", j.uid, now, reason="quota")
            return
        self._in_flight[ue].append([j, j.bits])
        self._n_in_flight += 1
        self.channel.add_job_bits(ue, j.bits, now)

    # ------------------------------------------------- handover / control
    def evict_ue(self, ue: int) -> List[list]:
        """Pull `ue`'s in-flight uplink bursts out of this cell (mobility
        handover): returns ``[[job, remaining_bits], ...]`` for the driver
        to re-inject at the target cell. Jobs already past the air
        interface (wireline, compute queue) are untouched."""
        queue = self._in_flight[ue]
        bursts = [list(entry) for entry in queue]
        if bursts:
            self._n_in_flight -= len(bursts)
            queue.clear()
        self.channel.evict_ue(ue)
        return bursts

    def inject_burst(self, ue: int, job: Job, remaining_bits: float,
                     now: float) -> None:
        """Resume an evicted burst on this cell's uplink (the Xn transfer
        has completed); the job keeps its identity and deadline."""
        self._in_flight[ue].append([job, remaining_bits])
        self._n_in_flight += 1
        self.channel.add_job_bits(ue, remaining_bits, now)
        if self.recorder is not None:
            self.recorder.job_event("rehomed", job.uid, now, cell=self.cell)

    def urgent_ues(self, now: float, slack_s: float) -> List[int]:
        """UEs whose head in-flight job is within `slack_s` of its
        deadline (the controllers' urgent bandwidth class)."""
        return [
            ue for ue, q in self._in_flight.items()
            if q and q[0][0].deadline - now < slack_s
        ]

    def min_inflight_slack(self, now: float) -> float:
        """Tightest deadline slack across in-flight bursts (inf if none)."""
        slack = math.inf
        for q in self._in_flight.values():
            for job, _ in q:
                slack = min(slack, job.deadline - now)
        return slack

    def uplink_drain_s(self) -> float:
        """Time the mean carrier would need to drain the queued job bits —
        the controllers' measure of air-interface congestion."""
        bits = 0.0
        for q in self._in_flight.values():
            for _, rem in q:
                bits += rem
        return bits / self._carrier_bps

    def _complete_bursts(self, ue: int, bits: float, t_slot_end: float) -> None:
        # complete jobs FIFO within the UE's burst queue
        queue = self._in_flight[ue]
        while bits > 1e-9 and queue:
            entry = queue[0]
            use = min(bits, entry[1])
            entry[1] -= use
            bits -= use
            if entry[1] <= 1e-9:
                queue.popleft()
                self._n_in_flight -= 1
                j = entry[0]
                prof = self.profiler
                if prof is not None:
                    t0 = perf_counter()
                    j.t_compute_arrival = (
                        t_slot_end + self.wireline(j, t_slot_end)
                    )
                    prof.add_sub("routing", perf_counter() - t0)
                else:
                    j.t_compute_arrival = (
                        t_slot_end + self.wireline(j, t_slot_end)
                    )
                if self.recorder is not None:
                    # route is set by wireline() (the router owns the job
                    # here), so the event carries the routing decision
                    self.recorder.job_event(
                        "uplink_done", j.uid, t_slot_end,
                        route=j.route, t_arrival=j.t_compute_arrival,
                    )
                self._wire_queue.append(j)
                if j.t_compute_arrival < self._wire_next:
                    self._wire_next = j.t_compute_arrival
            else:
                break

    def _deliver_due(self, t_slot_end: float) -> None:
        if not self._wire_queue:
            return
        prof = self.profiler
        t0 = perf_counter() if prof is not None else 0.0
        still = []
        nxt = math.inf
        for j in self._wire_queue:
            if j.t_compute_arrival <= t_slot_end:
                self.deliver(j)
            else:
                still.append(j)
                if j.t_compute_arrival < nxt:
                    nxt = j.t_compute_arrival
        self._wire_queue = still
        self._wire_next = nxt
        if prof is not None:
            prof.add_sub("wire_dispatch", perf_counter() - t0)


def score_jobs(
    jobs: List[Job],
    sim: SimConfig,
    name: str,
    management: Literal["joint", "disjoint"] = "joint",
    b_comm: Optional[float] = None,
    b_comp: Optional[float] = None,
    window_s: Optional[float] = None,
) -> SimResult:
    """Def.-1 satisfaction scoring over the warmup-trimmed job set.

    Disjoint management needs the stage sub-budgets (take them from the
    SchemeConfig — they are not defaulted here to avoid a second copy of
    the §III-B split); joint management ignores them.

    `window_s` (or ``sim.window_s``) additionally bins the scoring span
    into fixed windows by generation time and reports per-window
    satisfaction/drops — the transient view a flash crowd needs, where the
    run-level average hides both the collapse and the recovery."""
    if management == "disjoint" and (b_comm is None or b_comp is None):
        raise ValueError("disjoint scoring requires b_comm and b_comp")
    if window_s is None:
        window_s = sim.window_s
    t_lo, t_hi = sim.warmup, sim.sim_time - 2 * sim.b_total
    scored = [j for j in jobs if t_lo <= j.t_gen <= t_hi]
    n = len(scored)
    if n == 0:
        return SimResult(name, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    n_win = (
        max(1, int(math.ceil((t_hi - t_lo) / window_s)))
        if window_s and t_hi > t_lo else 0
    )
    win_n = [0] * n_win
    win_sat = [0] * n_win
    win_drop = [0] * n_win

    sat = 0
    comm, comp, e2e, tps = [], [], [], []
    ttft, tbt = [], []
    for j in scored:
        failed = j.dropped or math.isnan(j.t_complete)
        ok = False
        if not failed:
            t_comm = j.t_comm
            t_comp = j.t_complete - j.t_compute_arrival
            comm.append(t_comm)
            comp.append(t_comp)
            e2e.append(j.e2e)
            tps.append((j.n_input + j.n_output) / j.e2e)
            if not math.isnan(j.t_first_token):
                # user-perceived TTFT: generation to first output token (the
                # same clock as e2e, so comm delay counts against it)
                ttft.append(j.t_first_token - j.t_gen)
                tbt.append(
                    (j.t_complete - j.t_first_token) / max(j.n_output - 1, 1)
                )
            if management == "joint":
                ok = j.e2e <= j.b_total
            else:
                ok = (
                    j.e2e <= j.b_total
                    and t_comm <= b_comm
                    and t_comp <= b_comp
                )
            sat += int(ok)
        if n_win:
            w = min(int((j.t_gen - t_lo) / window_s), n_win - 1)
            win_n[w] += 1
            win_sat[w] += int(ok)
            win_drop[w] += int(failed)
    n_dropped = sum(1 for j in scored if j.dropped or math.isnan(j.t_complete))
    reasons: Dict[str, int] = {}
    for j in scored:
        if j.dropped or math.isnan(j.t_complete):
            r = j.drop_reason if j.drop_reason is not None else "unfinished"
            reasons[r] = reasons.get(r, 0) + 1
    windows = None
    if n_win:
        # a window with no generated jobs has no satisfaction to report
        # (None, not a vacuous 1.0 that would inflate transient averages)
        windows = [
            {
                "t0": t_lo + w * window_s,
                "t1": min(t_lo + (w + 1) * window_s, t_hi),
                "n": win_n[w],
                "satisfaction": win_sat[w] / win_n[w] if win_n[w] else None,
                "drop_rate": win_drop[w] / win_n[w] if win_n[w] else None,
            }
            for w in range(n_win)
        ]

    def pct(xs: List[float], q: float) -> Optional[float]:
        return float(np.percentile(xs, q)) if xs else None

    return SimResult(
        scheme=name,
        n_jobs=n,
        satisfaction=sat / n,
        drop_rate=n_dropped / n,
        avg_comm=float(np.mean(comm)) if comm else float("nan"),
        avg_comp=float(np.mean(comp)) if comp else float("nan"),
        avg_e2e=float(np.mean(e2e)) if e2e else float("nan"),
        avg_tokens_per_s=float(np.mean(tps)) if tps else float("nan"),
        p95_e2e=pct(e2e, 95),
        p99_e2e=pct(e2e, 99),
        avg_ttft=float(np.mean(ttft)) if ttft else None,
        p95_ttft=pct(ttft, 95),
        p99_ttft=pct(ttft, 99),
        avg_tbt=float(np.mean(tbt)) if tbt else None,
        p95_tbt=pct(tbt, 95),
        p99_tbt=pct(tbt, 99),
        windows=windows,
        drop_reasons=dict(sorted(reasons.items())) if reasons else None,
    )


def simulate(
    scheme: SchemeConfig,
    sim: SimConfig,
    service_time: Optional[Callable[[Job], float]] = None,
    node_factory: Optional[Callable[[], "ComputeNodeProtocol"]] = None,
    fast: bool = True,
    controller: "Optional[ControllerLike]" = None,
    recorder=None,
    faults=None,
    profiler=None,
) -> SimResult:
    """Run one slot-stepped simulation and score Def.-1 satisfaction.

    `service_time(job)` is the LLM inference latency model — analytic
    (core.latency_model), measured (serving engine calibration), or random
    (queueing-theory cross-check) — and builds the classic whole-job
    `ComputeNode` configured by `scheme`. Alternatively `node_factory`
    supplies any `ComputeNodeProtocol` implementation (e.g. a configured
    `repro.batching.BatchedComputeNode`); exactly one must be given.

    `controller` (a `repro_torch.control` preset name or Controller instance)
    runs the joint bandwidth-compute control loop on its epoch: admission
    gating at generation and urgent-class uplink weights (single-cell runs
    have no routing to retarget). The idle-slot fast-forward is clamped at
    controller epochs so the loop observes on schedule even in idle spans.

    `recorder` (a `repro.telemetry` TraceRecorder) captures per-job
    lifecycle events, stage-latency breakdowns, and sampled probe series;
    an `EventRecorder`'s columnar export is attached as
    ``result.telemetry``. The default (None / NullRecorder) is free: traced
    and untraced runs are bit-identical apart from the attachment.

    `faults` (a `repro_torch.faults.FaultSpec`) injects node crashes and
    brownouts on a seeded, slot-snapped timeline: a crash loses the
    queue and the in-flight work, and the affected jobs are re-submitted
    (served from scratch after recovery) or dropped with reason
    ``node_failure`` per the spec's ``redispatch`` knob. Link faults
    need the multi-cell simulator. None / an empty spec is free —
    fixed-seed results stay bit-identical to the fault-free engine.

    `profiler` (a `repro.telemetry.profile.PhaseProfiler`) attributes the
    run's host wall-clock to engine phases and attaches the rollup as
    ``result.profile``. Like the recorder, it is free when off and
    non-perturbing when on: profiled fixed-seed results are bit-identical
    to unprofiled apart from the attachment.

    ``fast=False`` selects the reference draw-per-slot engine (identical
    fixed-seed results, ~4x slower; kept for equivalence testing).
    """
    prof = active_profiler(profiler)
    t_enter = perf_counter() if prof is not None else 0.0
    if (service_time is None) == (node_factory is None):
        raise ValueError("pass exactly one of service_time / node_factory")
    if controller is not None:
        from ..control import validate_controller

        validate_controller(controller)  # unknown presets fail before setup
    rec = _active_recorder(recorder)
    rng = np.random.default_rng(sim.seed)
    if node_factory is not None:
        node = node_factory()
    else:
        node = ComputeNode(
            service_time,
            policy=scheme.compute_policy,
            drop_infeasible=scheme.drop_infeasible,
            comp_budget=scheme.b_comp if scheme.management == "disjoint" else None,
        )
    ctl = state = None
    if controller is not None:
        from ..control import ControlState, control_epoch, get_controller

        ctl = get_controller(controller)
        state = ControlState(n_cells=1)
    engine = SlotEngine(
        sim,
        rng,
        packet_priority=scheme.packet_priority,
        wireline=lambda job, t: scheme.t_wireline,
        deliver=node.submit,
        fast=fast,
        gate=state.gate if state is not None else None,
        recorder=rec,
        profiler=prof,
    )
    if prof is not None and hasattr(node, "profiler"):
        node.profiler = prof  # batched nodes time their admission path
    s, n_slots = 0, engine.n_slots
    # ---------------------------------------------------- fault injection
    # Opt-in (sched stays None otherwise — the loop below is untouched).
    sched = None
    fevents: collections.deque = collections.deque()
    if faults is not None and not faults.empty:
        if faults.link_outages:
            raise ValueError(
                "link faults need the multi-cell simulator "
                "(repro_torch.network.simulate_network)")
        from ..faults import bind_faults
        from ..faults.schedule import NODE_FAIL

        sched = bind_faults(faults, engine.slot, sim.sim_time, sim.seed)
        if sched.has_brownouts():
            node.speed_scale = lambda t: sched.slow_factor(None, t)
        # (slot, t, kind, name): slot-snapped instants, time-sorted
        fevents = collections.deque(
            (int(round(t / engine.slot)), t, kind, name)
            for t, kind, name in sched.node_events()
        )

        def fault_event(t_ev: float, kind: str, name: str) -> None:
            if kind == NODE_FAIL:
                node.run_until(t_ev)
                until = sched.down_until(None, t_ev) or t_ev
                affected = node.crash(t_ev, until)
                fe = getattr(rec, "fault_event", None)
                if fe is not None:
                    fe(t_ev, kind, name, n_affected=len(affected))
                for job in affected:
                    if sched.redispatch:
                        # single node: re-queue here; service restarts
                        # from scratch once the node recovers
                        if rec is not None:
                            rec.job_event("redispatch", job.uid, t_ev,
                                          route="node")
                        node.submit(job)
                    else:
                        job.dropped = True
                        job.drop_reason = "node_failure"
                        if rec is not None:
                            rec.job_event("drop", job.uid, t_ev,
                                          stage="node",
                                          reason="node_failure")
            else:
                fe = getattr(rec, "fault_event", None)
                if fe is not None:
                    fe(t_ev, kind, name)
    sample_stride = next_sample = 0
    if rec is not None:
        node.recorder = rec
        sample_stride = max(
            1, int(round(getattr(rec, "sample_every_s", 0.01) / engine.slot))
        )
    if ctl is not None:
        epoch_slots = max(1, int(round(ctl.epoch_s / engine.slot)))
        next_epoch = epoch_slots
        # effective per-job service for the controller's throughput math;
        # a protocol-conforming node without a latency model falls back to
        # the scheme's compute sub-budget as a coarse estimate
        proto = Job(-1, -1, 0.0, sim.n_input, sim.n_output, sim.b_total)
        if service_time is not None:
            svc = service_time(proto)
        else:
            lm = getattr(node, "lm", None)
            svc = (
                lm.job_latency(sim.n_input, sim.n_output)
                if lm is not None else scheme.b_comp
            )
        svc_s = {"node": svc / max(getattr(node, "max_batch", 1), 1)}
    # phase attribution: laps chain through one carried mark (`tm`), so
    # consecutive phases tile the loop's timeline with no gaps — loop
    # bookkeeping lands in the adjacent phase and coverage stays ~100%
    tm = prof.lap("setup", t_enter) if prof is not None else 0.0
    while s < n_slots:
        if fevents and fevents[0][0] <= s:
            while fevents and fevents[0][0] <= s:
                _, t_ev, kind, name = fevents.popleft()
                fault_event(t_ev, kind, name)
            if prof is not None:
                tm = prof.lap("faults", tm)
        if ctl is not None and s >= next_epoch:
            now_ep = s * engine.slot
            control_epoch(
                ctl, state, now_ep, sim.b_total, [engine],
                [("node", node, 0)], svc_s, recorder=rec,
                down_nodes=(
                    {"node"} if sched is not None
                    and sched.node_down(None, now_ep) else None
                ),
            )
            next_epoch += epoch_slots
            if prof is not None:
                tm = prof.lap("controller", tm)
        if engine.can_skip():
            # idle-slot fast-forward: jump to the next arrival-process
            # event, clamped at the next controller epoch — and, when
            # tracing, at the next probe sample, so the time-series keep
            # their cadence across idle air-interface spans (the compute
            # node may still be draining; Little's-law checks need the
            # queue-depth series to cover those spans). Results are
            # unaffected: skipping is a pure performance path.
            nxt = engine.next_event_at_or_after(s)
            if fevents:
                # never skip over a crash/recover instant: the crash must
                # execute at its scheduled slot, not late
                nxt = min(nxt, fevents[0][0])
            if ctl is not None:
                nxt = min(nxt, next_epoch)
            if rec is not None:
                nxt = min(nxt, next_sample)
            if nxt > s:
                engine.skip_slots(s, min(nxt, n_slots))
                s = nxt
                if prof is not None:
                    tm = prof.lap("fast_forward", tm)
                continue
        if prof is not None:
            # skip-decision + loop bookkeeping since the previous lap
            tm = prof.lap("driver", tm)
        t_slot_end = engine.step(s)
        if prof is not None:
            tm = prof.lap("uplink_step", tm)
        node.run_until(t_slot_end)
        if prof is not None:
            tm = prof.lap("compute", tm)
        if rec is not None and s >= next_sample:
            rec.sample("cell0.uplink", t_slot_end, {
                "backlog_s": engine.uplink_drain_s(),
                "in_flight": float(engine._n_in_flight),
                "active_ues": float(engine.channel.active_ues()),
            })
            rec.sample(
                f"{getattr(node, 'telemetry_name', 'node')}.queue",
                t_slot_end, {"depth": float(len(node))},
            )
            next_sample = s + sample_stride
            if prof is not None:
                tm = prof.lap("probes", tm)
        s += 1
    while fevents:  # recoveries snapped past the last slot (telemetry)
        _, t_ev, kind, name = fevents.popleft()
        fault_event(t_ev, kind, name)
    node.run_until(float("inf"))
    if prof is not None:
        tm = prof.lap("compute", tm)  # final drain (+ post-loop recoveries)
    result = score_jobs(
        engine.jobs,
        sim,
        scheme.name,
        management=scheme.management,
        b_comm=scheme.b_comm,
        b_comp=scheme.b_comp,
    )
    if prof is not None:
        tm = prof.lap("scoring", tm)
    if rec is not None and hasattr(rec, "to_telemetry"):
        result.telemetry = rec.to_telemetry(meta={
            "kind": "single_cell",
            "scheme": scheme.name,
            "seed": sim.seed,
            "sim_time": sim.sim_time,
            "n_ues": sim.n_ues,
        })
        if prof is not None:
            tm = prof.lap("telemetry_export", tm)
    if prof is not None:
        prof.count("slots", n_slots)
        prof.count("slots_skipped", engine.slots_skipped)
        prof.count("slots_stepped", n_slots - engine.slots_skipped)
        prof.count("arrival_chunks", engine.chunks_drawn)
        ch = engine.channel
        prof.count("uplink_scalar_slots", ch.scalar_slots)
        prof.count("uplink_array_slots", ch.array_slots)
        prof.count("uplink_mode_switches", ch.array_mode_switches)
        st = getattr(node, "stats", None)
        if st is not None:  # batched nodes: iteration-level diagnostics
            prof.count("batch_iterations", st.n_iterations)
            prof.count("kv_blocked_iterations", st.kv_blocked_iterations)
        result.profile = prof.to_profile(perf_counter() - t_enter)
    return result
