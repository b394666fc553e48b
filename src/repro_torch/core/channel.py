"""SLS-lite 5G uplink model (paper §IV-A "Communication Latency").

The paper measures T_comm^{UE-BS} with a system-level simulator (FikoRE-style
[15]): prompts are packetized into RLC PDUs and transmitted over the 5G air
interface, so each packet sees transmission + queueing delay, competing with
background traffic.

We reproduce that at slot granularity (Table I numerology: 60 kHz SCS ->
0.25 ms slots, 100 MHz at 3.7 GHz), with the two mechanisms that actually
set small-packet uplink latency in a loaded cell:

  1. **Grant acquisition.** A UE whose queue goes empty -> backlogged sends a
     scheduling request and waits for an uplink grant. The gNB can issue a
     bounded number of grants per slot (PDCCH capacity); requests queue.
     This is the load-dependent term: as UEs scale up, grant-queue delay
     climbs steeply near the PDCCH saturation point.
  2. **PRB sharing.** Granted, backlogged UEs share the carrier equally each
     slot; per-UE rate follows 3GPP UMa pathloss -> SINR -> Shannon SE
     (floored: HARQ/link adaptation keeps cell-edge UEs out of deep outage).

ICC's "job-aware packet prioritization" (§IV-B) enters in both places: job
scheduling requests pre-empt background requests in the grant queue, and job
bytes drain before background bytes. The 5G-MEC baseline is strictly FIFO:
grant requests served in arrival order, and per-UE job bytes queue behind
earlier background bytes.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["ChannelConfig", "UplinkChannel"]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    # Table I
    carrier_ghz: float = 3.7
    bandwidth_hz: float = 100e6
    scs_hz: float = 60e3
    background_bps: float = 0.5e6  # per UE
    # Urban macrocell geometry / radio
    cell_radius_m: float = 250.0
    min_dist_m: float = 25.0
    ue_tx_dbm: float = 23.0
    noise_figure_db: float = 5.0
    interference_margin_db: float = 6.0  # inter-cell interference (UMa)
    gnb_height_m: float = 25.0
    ue_height_m: float = 1.5
    shadowing_std_db: float = 6.0
    se_cap_bps_hz: float = 7.4  # 256QAM ceiling
    # Link-adaptation floor: HARQ/repetition keeps cell-edge UEs above this
    # effective SE instead of deep outage (calibration, see EXPERIMENTS.md).
    se_floor_bps_hz: float = 1.0
    phy_overhead: float = 0.75  # DMRS/control/guard overhead factor
    # Uplink control plane: SR -> grant pipeline latency for an uncontended
    # request, plus the PDCCH grant issue capacity per slot.
    sr_cycle_s: float = 1.0e-3
    grants_per_slot: float = 1.5  # ~6000 grants/s at 60 kHz SCS (calibrated)
    # Background traffic packetization (mixed small-packet traffic).
    bg_pdu_bytes: int = 400
    # Payload model: bytes carried per prompt token (AR-glasses speech/text
    # offload payload incl. RLC/PDCP/app headers). Calibration knob.
    bytes_per_token: float = 256.0

    @property
    def slot_s(self) -> float:
        # slot duration = 1 ms / (scs / 15 kHz)
        return 1e-3 / (self.scs_hz / 15e3)


class UplinkChannel:
    """Slot-stepped uplink state for `n_ues` UEs.

    Two equivalent execution paths share the same state:

      * ``step()`` — the reference whole-array implementation (every per-UE
        quantity is a length-``n_ues`` NumPy op per slot).
      * ``step_drain()`` — the fast path the simulator drives: it keeps an
        index of *active* UEs (queued bits or a held grant) and, while that
        set stays under ``scalar_cutoff``, does the identical arithmetic in
        scalar Python, which beats NumPy-call overhead by ~3x at typical
        cell occupancy (even ~40 active UEs at the top of the tracked
        sweeps stay below the scalar/array crossover). Above the cutoff it
        falls back to the array path. Both paths produce bit-identical
        state trajectories (tests/test_fast_sim).

    When the channel is completely idle (no bits, no grant requests), a slot
    is a pure no-op except for PDCCH credit accrual — callers can detect that
    via ``needs_step`` and replace the whole slot with ``skip_slot()``.
    """

    def __init__(
        self,
        cfg: ChannelConfig,
        n_ues: int,
        rng: np.random.Generator,
        scalar_cutoff: int = 64,
    ):
        self.cfg = cfg
        self.n = n_ues
        self.rng = rng
        # --- static per-UE link budget -------------------------------------
        r = np.sqrt(rng.uniform(cfg.min_dist_m**2, cfg.cell_radius_m**2, n_ues))
        d3d = np.sqrt(r**2 + (cfg.gnb_height_m - cfg.ue_height_m) ** 2)
        # 3GPP TR 38.901 UMa NLOS pathloss.
        pl_db = (
            13.54
            + 39.08 * np.log10(d3d)
            + 20.0 * np.log10(cfg.carrier_ghz)
            - 0.6 * (cfg.ue_height_m - 1.5)
        )
        pl_db += rng.normal(0.0, cfg.shadowing_std_db, n_ues)
        noise_dbm = -174.0 + 10.0 * np.log10(cfg.bandwidth_hz) + cfg.noise_figure_db
        snr_db = cfg.ue_tx_dbm - pl_db - noise_dbm - cfg.interference_margin_db
        se = np.clip(
            np.log2(1.0 + 10.0 ** (snr_db / 10.0)),
            cfg.se_floor_bps_hz,
            cfg.se_cap_bps_hz,
        )
        # bits a UE moves in one slot if given the whole carrier
        full = se * cfg.bandwidth_hz * cfg.phy_overhead * cfg.slot_s
        self._full_arr = full
        self._full_list = full.tolist()
        self.full_carrier_bits_per_slot = self._full_list
        # --- per-UE state (queues in bits + grant flags) ---------------------
        # Two canonical representations, switched with hysteresis:
        #   * list mode (calm cell): plain Python lists — the scalar path
        #     reads/writes them at ~4x less overhead than ndarray item
        #     access.
        #   * array mode (busy cell, > scalar_cutoff grant holders): float64
        #     ndarrays — the original whole-array math runs natively with no
        #     per-slot conversions.
        # list <-> array conversion is value-exact for float64/bool, so the
        # trajectory is bit-identical whichever mode a slot executes in.
        self.bg_bits = [0.0] * n_ues
        self.job_bits = [0.0] * n_ues
        # MEC FIFO coupling: background bits queued ahead of the job burst.
        self.bg_ahead_of_job = [0.0] * n_ues
        self.job_granted = [False] * n_ues
        self.bg_granted = [False] * n_ues
        self._seq = itertools.count()
        self._job_reqs: deque = deque()  # (seq, ue, ready_time)
        self._bg_reqs: deque = deque()
        self._grant_credit = 0.0
        # background packet arrivals
        self._bg_pkt_bits = cfg.bg_pdu_bytes * 8.0
        self._bg_pkt_per_slot = cfg.background_bps * cfg.slot_s / self._bg_pkt_bits
        # list-mode index, split by transmit eligibility (None in array
        # mode, where per-slot masks replace it):
        #   _ready  — UEs holding >= 1 grant flag (the only UEs that can
        #             move bits this slot: every *_ready condition in the
        #             array math requires a grant),
        #   _parked — UEs with queued bits but no grant (waiting for their
        #             scheduling request to mature; nothing to scan until
        #             `_issue_grants` promotes them).
        # Most busy slots are SR-wait slots with an empty ready set, so the
        # scalar path returns immediately instead of scanning the cell.
        self._ready: Optional[set] = set()
        self._parked: Optional[set] = set()
        self._scalar_cutoff = scalar_cutoff
        self._scalar_resume = max(1, scalar_cutoff // 2)  # hysteresis
        self._resume_check = 0  # slots until the next switch-down check
        self.array_mode_switches = 0  # diagnostics (tests assert coverage)
        # per-mode stepped-slot counts (phase-profiler diagnostics: how
        # many draining slots ran the scalar replica vs the array path)
        self.scalar_slots = 0
        self.array_slots = 0
        # controller-set per-UE PRB weights for the prioritized job split
        # (None = the original equal split, the bit-exact default path)
        self._job_w: Optional[np.ndarray] = None

    # ------------------------------------------------------- mode switching
    def _to_array_mode(self) -> None:
        self.array_mode_switches += 1
        self.job_bits = np.array(self.job_bits)
        self.bg_bits = np.array(self.bg_bits)
        self.bg_ahead_of_job = np.array(self.bg_ahead_of_job)
        self.job_granted = np.array(self.job_granted)
        self.bg_granted = np.array(self.bg_granted)
        self.full_carrier_bits_per_slot = self._full_arr
        self._ready = self._parked = None

    def _to_list_mode(self) -> None:
        granted = self.job_granted | self.bg_granted
        queued = (self.job_bits > 0.0) | (self.bg_bits > 0.0)
        self._ready = set(np.flatnonzero(granted).tolist())
        self._parked = set(np.flatnonzero(queued & ~granted).tolist())
        self.job_bits = self.job_bits.tolist()
        self.bg_bits = self.bg_bits.tolist()
        self.bg_ahead_of_job = self.bg_ahead_of_job.tolist()
        self.job_granted = self.job_granted.tolist()
        self.bg_granted = self.bg_granted.tolist()
        self.full_carrier_bits_per_slot = self._full_list

    @property
    def needs_step(self) -> bool:
        """False when a slot would be a no-op apart from credit accrual."""
        if self._ready is None:
            # array mode is only entered/held while > scalar_resume UEs
            # hold grants, so the cell is never idle here
            return True
        return bool(
            self._ready or self._parked or self._job_reqs or self._bg_reqs
        )

    def set_job_weights(self, weights: Optional[np.ndarray]) -> None:
        """Set (or clear) per-UE PRB weights for the prioritized job split.

        The joint controller's bandwidth action: transmitting job UEs share
        the carrier proportionally to their weight instead of equally, so
        near-deadline jobs can be pushed across the air first. ``None``
        restores the exact default split. While weights are set the channel
        runs its single (array-mode) implementation — the scalar replica is
        only maintained for the unweighted math."""
        if weights is None:
            self._job_w = None
            return
        w = np.asarray(weights, dtype=float)
        if w.shape != (self.n,) or np.any(w <= 0.0):
            raise ValueError("weights must be positive with one entry per UE")
        self._job_w = w
        if self._ready is not None:
            self._to_array_mode()

    def active_ues(self) -> int:
        """UEs currently occupying the air interface — queued bits or a
        held grant. The telemetry layer's PRB-occupancy proxy (read-only:
        works in both list and array mode without touching state)."""
        if self._ready is not None:
            return len(self._ready) + len(self._parked)
        queued = (self.job_bits > 0.0) | (self.bg_bits > 0.0)
        return int(np.count_nonzero(queued | self.job_granted | self.bg_granted))

    def evict_ue(self, ue: int) -> None:
        """Erase `ue`'s uplink state (mobility handover re-homing): queued
        bits, grant flags, and pending scheduling requests. The caller
        re-injects any evicted job bursts at the target cell."""
        if self._job_reqs:
            self._job_reqs = deque(r for r in self._job_reqs if r[1] != ue)
        if self._bg_reqs:
            self._bg_reqs = deque(r for r in self._bg_reqs if r[1] != ue)
        self.job_bits[ue] = 0.0
        self.bg_bits[ue] = 0.0
        self.bg_ahead_of_job[ue] = 0.0
        self.job_granted[ue] = False
        self.bg_granted[ue] = False
        if self._ready is not None:
            self._ready.discard(ue)
            self._parked.discard(ue)

    def skip_slot(self) -> None:
        """Accrue one slot of PDCCH grant credit without stepping.

        Exactly what ``step()`` does on an idle channel: `_issue_grants`
        adds the per-slot credit and, with no pending requests, issues
        nothing; every other array op is the identity on empty queues.
        """
        self._grant_credit += self.cfg.grants_per_slot

    # -------------------------------------------------------------- arrivals
    def _track_arrival(self, ue: int) -> None:
        # grant holders are already in _ready; everyone else waits parked
        # (array mode recomputes eligibility from masks instead)
        if self._parked is not None and not (
            self.job_granted[ue] or self.bg_granted[ue]
        ):
            self._parked.add(ue)

    def add_background(self, now: float) -> None:
        pkts = self.rng.poisson(self._bg_pkt_per_slot, self.n)
        for ue in np.nonzero(pkts)[0]:
            ue = int(ue)
            if self.bg_bits[ue] <= 0.0 and not self.bg_granted[ue]:
                self._bg_reqs.append((next(self._seq), ue, now + self.cfg.sr_cycle_s))
            self.bg_bits[ue] += int(pkts[ue]) * self._bg_pkt_bits
            self._track_arrival(ue)

    def apply_background_range(self, ues, cnts, lo, hi, now: float) -> None:
        """`add_background` with pre-drawn packet counts.

        ``ues[lo:hi]`` / ``cnts[lo:hi]`` are the nonzero UEs (ascending) and
        packet counts of the same Poisson draw ``add_background`` would have
        made — the simulator pre-draws them in bulk, which leaves the RNG
        stream bit-identical, and its chunk cursor passes the slot's range
        here without building a pair list."""
        bb = self.bg_bits
        jg, bgr = self.job_granted, self.bg_granted
        parked = self._parked
        pkt_bits = self._bg_pkt_bits
        sr_at = now + self.cfg.sr_cycle_s
        for i in range(lo, hi):
            ue = ues[i]
            if bb[ue] <= 0.0 and not bgr[ue]:
                self._bg_reqs.append((next(self._seq), ue, sr_at))
            bb[ue] += cnts[i] * pkt_bits
            # inlined _track_arrival (hot loop)
            if parked is not None and not (jg[ue] or bgr[ue]):
                parked.add(ue)

    def add_job_bits(self, ue: int, bits: float, now: float) -> None:
        if self.job_bits[ue] <= 0.0 and not self.job_granted[ue]:
            self._job_reqs.append((next(self._seq), ue, now + self.cfg.sr_cycle_s))
        self.job_bits[ue] += bits
        # MEC FIFO: background queued now is ahead of this burst.
        self.bg_ahead_of_job[ue] = self.bg_bits[ue]
        self._track_arrival(ue)

    # ------------------------------------------------------------ grant loop
    def _issue_grants(self, now: float, prioritize_jobs: bool) -> None:
        self._grant_credit += self.cfg.grants_per_slot
        if self._job_reqs or self._bg_reqs:
            self._issue_queued_grants(now, prioritize_jobs)

    def _issue_queued_grants(self, now: float, prioritize_jobs: bool) -> None:
        while self._grant_credit >= 1.0:
            job_ok = bool(self._job_reqs) and self._job_reqs[0][2] <= now
            bg_ok = bool(self._bg_reqs) and self._bg_reqs[0][2] <= now
            if not job_ok and not bg_ok:
                break
            if prioritize_jobs:
                take_job = job_ok
            else:  # strict FIFO by request sequence number
                if job_ok and bg_ok:
                    take_job = self._job_reqs[0][0] < self._bg_reqs[0][0]
                else:
                    take_job = job_ok
            if take_job:
                _, ue, _ = self._job_reqs.popleft()
                self.job_granted[ue] = True
            else:
                _, ue, _ = self._bg_reqs.popleft()
                self.bg_granted[ue] = True
            if self._ready is not None:
                self._ready.add(ue)
                self._parked.discard(ue)
            self._grant_credit -= 1.0

    # ------------------------------------------------------------------ slot
    def step(self, now: float, prioritize_jobs: bool) -> np.ndarray:
        """Advance one slot; returns per-UE job bits drained this slot.

        Reference whole-array path (the fast path `step_drain` is
        equivalence-tested against it). Flips the channel into array mode
        and leaves it there — callers of `step()` (the reference engine,
        direct channel tests) run the pre-PR array-native code throughout."""
        self._issue_grants(now, prioritize_jobs)
        if self._ready is not None:
            self._to_array_mode()
        return self._step_arrays(now, prioritize_jobs)

    def step_drain(self, now: float, prioritize_jobs: bool) -> list:
        """Advance one slot; returns ``[(ue, job_bits_drained), ...]`` in
        ascending UE order — only UEs that drained job bits this slot.

        Same state trajectory as ``step()``: scalar arithmetic over the
        grant-holding UEs while they are few, the native whole-array path
        while the cell is busy (mode switches carry hysteresis so a loaded
        cell stays in array mode instead of converting every slot)."""
        self._grant_credit += self.cfg.grants_per_slot
        jr, br = self._job_reqs, self._bg_reqs
        # inline maturity peek: most slots have only unripe SRs queued, and
        # `_issue_queued_grants` would do nothing but break immediately
        if (jr and jr[0][2] <= now) or (br and br[0][2] <= now):
            self._issue_queued_grants(now, prioritize_jobs)
        ready = self._ready
        if ready is not None:
            if not ready:
                return _NO_DRAIN
            if self._job_w is None and len(ready) <= self._scalar_cutoff:
                self.scalar_slots += 1
                return self._step_scalar(now, prioritize_jobs)
            self._to_array_mode()
            self._resume_check = 16
        self.array_slots += 1
        drained = self._step_arrays(now, prioritize_jobs)
        # switch-down probe every 16 slots: the check costs two array
        # reductions, and hysteresis makes its timing a pure perf knob
        self._resume_check -= 1
        if self._resume_check <= 0:
            self._resume_check = 16
            # upper bound on grant holders (double-counts dual grants);
            # only steers the mode choice — both modes are bit-identical
            n_granted = int(np.count_nonzero(self.job_granted)) + int(
                np.count_nonzero(self.bg_granted)
            )
            if self._job_w is None and n_granted <= self._scalar_resume:
                self._to_list_mode()
        nz = np.nonzero(drained > 0.0)[0]
        return [(int(u), float(drained[u])) for u in nz]

    def _step_arrays(self, now: float, prioritize_jobs: bool) -> np.ndarray:
        """Whole-array slot math (array mode: every per-UE attr is ndarray)."""
        job_ready = (self.job_bits > 0.0) & self.job_granted
        # In the FIFO baseline a UE's single RLC queue drains in order, so a
        # grant of either kind serves the head of the queue.
        any_grant = self.job_granted | self.bg_granted
        if not prioritize_jobs:
            job_ready = (self.job_bits > 0.0) & any_grant
        bg_ready = (self.bg_bits > 0.0) & any_grant
        active = job_ready | bg_ready
        n_active = int(np.count_nonzero(active))
        job_tx = np.zeros(self.n)
        if n_active == 0:
            return job_tx

        cap = np.zeros(self.n)
        if prioritize_jobs:
            # ICC: UEs with job traffic split the carrier first.
            n_job = int(np.count_nonzero(job_ready))
            if n_job > 0:
                if self._job_w is None:
                    cap[job_ready] = self._full_arr[job_ready] / n_job
                else:
                    # controller bandwidth action: PRB share proportional
                    # to the per-UE weight (equal weights == 1/n_job)
                    w = self._job_w[job_ready]
                    cap[job_ready] = self._full_arr[job_ready] * (w / w.sum())
                job_tx = np.minimum(self.job_bits, cap)
                leftover = cap - job_tx
                bg_tx = np.minimum(self.bg_bits, np.where(bg_ready, leftover, 0.0))
            else:
                cap[active] = self._full_arr[active] / n_active
                bg_tx = np.minimum(self.bg_bits, np.where(bg_ready, cap, 0.0))
        else:
            # 5G MEC: equal share among granted backlogged UEs, per-UE FIFO.
            cap[active] = self._full_arr[active] / n_active
            bg_first = np.minimum(self.bg_ahead_of_job, cap)
            rem = cap - bg_first
            job_tx = np.minimum(np.where(job_ready, self.job_bits, 0.0), rem)
            rem = rem - job_tx
            bg_rest = np.minimum(self.bg_bits - bg_first, np.where(bg_ready, rem, 0.0))
            bg_tx = bg_first + bg_rest
            self.bg_ahead_of_job = np.maximum(self.bg_ahead_of_job - bg_first, 0.0)

        self.bg_bits = np.maximum(self.bg_bits - bg_tx, 0.0)
        self.job_bits = np.maximum(self.job_bits - job_tx, 0.0)
        self.job_granted &= self.job_bits > 1e-9
        self.bg_granted &= self.bg_bits > 1e-9
        return job_tx

    def _step_scalar(self, now: float, prioritize_jobs: bool) -> list:
        """Scalar replica of `_step_arrays` over the grant-holding UEs.

        Every arithmetic step mirrors one array op on the same float64
        values (min/max/+-*/ are elementwise IEEE in both), so the state
        after this call is bit-identical to the array path's. Only
        `_ready` UEs are scanned: every *_ready condition in the array
        math requires a grant flag, and parked UEs (bits, no grant) cannot
        change state during the slot.
        """
        jb, bb = self.job_bits, self.bg_bits
        jg, bgr = self.job_granted, self.bg_granted
        full = self.full_carrier_bits_per_slot
        job_ready, bg_ready = [], []
        ready = self._ready
        live = list(ready) if len(ready) == 1 else sorted(ready)
        for ue in live:
            if prioritize_jobs:
                if jg[ue] and jb[ue] > 0.0:
                    job_ready.append(ue)
            else:
                if jb[ue] > 0.0:  # any grant serves the head of the queue
                    job_ready.append(ue)
            if bb[ue] > 0.0:
                bg_ready.append(ue)
        if not job_ready and not bg_ready:
            # no transmitting UE: the array path returns before its global
            # grant-clear, so empty-handed grant holders keep their flags
            return _NO_DRAIN

        drains: list = []
        if prioritize_jobs:
            n_job = len(job_ready)
            if n_job:
                # ICC: UEs with job traffic split the carrier first.
                leftover = {}
                for ue in job_ready:
                    cap = full[ue] / n_job
                    tx = jb[ue] if jb[ue] < cap else cap
                    leftover[ue] = cap - tx
                    if tx > 0.0:
                        drains.append((ue, float(tx)))
                    t = jb[ue] - tx
                    jb[ue] = t if t > 0.0 else 0.0
                for ue in bg_ready:
                    lo = leftover.get(ue, 0.0)
                    btx = bb[ue] if bb[ue] < lo else lo
                    t = bb[ue] - btx
                    bb[ue] = t if t > 0.0 else 0.0
            else:
                # active = bg_ready when no UE has granted job traffic
                n_active = len(bg_ready)
                for ue in bg_ready:
                    cap = full[ue] / n_active
                    btx = bb[ue] if bb[ue] < cap else cap
                    t = bb[ue] - btx
                    bb[ue] = t if t > 0.0 else 0.0
        else:
            # 5G MEC: equal share among granted backlogged UEs, per-UE FIFO.
            job_set = set(job_ready)
            bg_set = set(bg_ready)
            n_active = len(job_set | bg_set)
            ahead = self.bg_ahead_of_job
            for ue in sorted(job_set | bg_set):
                cap = full[ue] / n_active
                a = ahead[ue]
                bg_first = a if a < cap else cap
                rem = cap - bg_first
                if ue in job_set:
                    jtx = jb[ue] if jb[ue] < rem else rem
                    if jtx > 0.0:
                        drains.append((ue, float(jtx)))
                    rem = rem - jtx
                    t = jb[ue] - jtx
                    jb[ue] = t if t > 0.0 else 0.0
                lim = rem if ue in bg_set else 0.0
                x = bb[ue] - bg_first
                bg_rest = x if x < lim else lim
                btx = bg_first + bg_rest
                t = bb[ue] - btx
                bb[ue] = t if t > 0.0 else 0.0
                t = a - bg_first
                ahead[ue] = t if t > 0.0 else 0.0

        ready = self._ready
        for ue in live:
            if jg[ue] and not jb[ue] > 1e-9:
                jg[ue] = False
            if bgr[ue] and not bb[ue] > 1e-9:
                bgr[ue] = False
            if not (jg[ue] or bgr[ue]):
                ready.discard(ue)
                if jb[ue] > 0.0 or bb[ue] > 0.0:
                    # lost every grant but still queued (e.g. new bg bits
                    # behind a drained job burst): back to the parked pool
                    self._parked.add(ue)
        return drains


_NO_DRAIN: list = []
