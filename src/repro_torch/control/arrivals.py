"""Arrival-process abstraction for the slot-stepped simulators.

The PR-3 fast core pre-draws Poisson arrival counts in chunked
``(slots, 2, n_ues)`` calls against a *constant* per-slot rate. This module
generalizes the rate to a per-slot (and, via mobility presence masks,
per-UE) profile while preserving two contracts:

  1. **Stationary bit-exactness.** A `PoissonProcess` at the SimConfig's
     own rate produces the exact rate buffer the engine filled before this
     abstraction existed, so the Poisson draws consume the RNG stream
     bit-identically (tests/test_control.py pins this against the default
     path, which tests/test_fast_sim.py pins against the reference engine).
  2. **Fixed-seed determinism.** Processes that need their own randomness
     (the MMPP modulating chain) draw it from a *separate* generator seeded
     from (sim seed, salt) at bind time — the engine's arrival/channel
     stream is never touched, and two runs with the same seed see the same
     rate trajectory.

A *spec* (frozen dataclass: picklable, safe inside `SimConfig`) describes
the process; `bind_arrivals` resolves it against one engine's geometry
(UE count, slot duration, horizon, seed) into a `BoundArrivals` the
`SlotEngine` consults for rate fills, legacy per-slot rates, mobility
presence, and forced-wake slots (regime edges the idle-slot fast-forward
must not jump across blindly).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "PoissonProcess",
    "PiecewiseRate",
    "DiurnalRate",
    "FlashCrowd",
    "MMPP",
    "ArrivalProcess",
    "BoundArrivals",
    "bind_arrivals",
]

_MMPP_STREAM = 0x4D4D5050  # "MMPP": domain-separates the modulating chain


@dataclasses.dataclass(frozen=True)
class PoissonProcess:
    """Stationary Poisson arrivals at `rate_per_ue` jobs/s (None = take the
    SimConfig's `lam_per_ue`). The default process: bit-identical to the
    pre-abstraction engine."""

    rate_per_ue: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PiecewiseRate:
    """Step-function rate profile: `rates[i]` jobs/s/UE on
    ``[t_edges[i], t_edges[i+1])`` (the last segment runs to the horizon).
    `t_edges[0]` must be 0."""

    t_edges: Tuple[float, ...]
    rates: Tuple[float, ...]

    def __post_init__(self):
        if len(self.t_edges) != len(self.rates):
            raise ValueError("t_edges and rates must have equal length")
        if not self.t_edges or self.t_edges[0] != 0.0:
            raise ValueError("t_edges must start at 0.0")
        if list(self.t_edges) != sorted(self.t_edges):
            raise ValueError("t_edges must be ascending")


@dataclasses.dataclass(frozen=True)
class DiurnalRate:
    """Smooth diurnal load curve: a raised cosine swinging between `base`
    and `peak` jobs/s/UE with period `period_s` (time-average is their
    midpoint). `phase` in [0, 1) shifts where in the cycle t=0 falls
    (phase 0 starts at the valley)."""

    base: float
    peak: float
    period_s: float
    phase: float = 0.0


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """Stationary `base` rate with a flash-crowd plateau at `spike`
    jobs/s/UE during ``[t_start, t_end)`` — the scenario static policies
    cannot absorb. The spike edges are forced-wake slots so a fast-forward
    re-enters the slot loop at the regime change."""

    base: float
    spike: float
    t_start: float
    t_end: float

    def __post_init__(self):
        if self.t_end <= self.t_start:
            raise ValueError("t_end must be > t_start")


@dataclasses.dataclass(frozen=True)
class MMPP:
    """Two-state Markov-modulated Poisson process (bursty on/off source):
    exponential dwell times `mean_on_s`/`mean_off_s`, rates
    `rate_on`/`rate_off` jobs/s/UE. The modulating chain is drawn once at
    bind time from its own generator (seed, salt) — deterministic under a
    fixed sim seed and independent of the engine's arrival stream."""

    rate_on: float
    rate_off: float = 0.0
    mean_on_s: float = 1.0
    mean_off_s: float = 1.0
    start_on: bool = True
    salt: int = 0


ArrivalProcess = Union[PoissonProcess, PiecewiseRate, DiurnalRate, FlashCrowd, MMPP]


class BoundArrivals:
    """A process resolved against one engine's geometry.

    * ``stationary`` — True only for a constant rate with no presence mask;
      the engine then keeps its original constant-fill / scalar-draw code
      paths (bit-identical RNG consumption).
    * ``rate_slot`` — per-slot per-UE expected arrivals (stationary only).
    * ``fill(out, start)`` — write the job-rate block of a pre-draw chunk
      (`out` is the ``(L, n_ues)`` view for slots ``[start, start+L)``).
    * ``rates_at(s)`` — per-UE rate vector for the reference per-slot path.
    * ``next_wake(s)`` — smallest forced-wake slot >= `s` (or `n_slots`):
      profile edges the idle-slot fast-forward must stop at, over and above
      the pre-drawn arrival cursor.
    """

    def __init__(
        self,
        n_ues: int,
        n_slots: int,
        rate_slot: Optional[float] = None,
        rate_slots: Optional[np.ndarray] = None,
        presence: Optional[Dict[int, Tuple[Tuple[int, int], ...]]] = None,
        wake_slots: Sequence[int] = (),
    ):
        if (rate_slot is None) == (rate_slots is None):
            raise ValueError("pass exactly one of rate_slot / rate_slots")
        self.n_ues = n_ues
        self.n_slots = n_slots
        self.rate_slot = rate_slot
        self.rate_slots = rate_slots
        # presence: UE index -> sorted (on_slot, off_slot) intervals during
        # which the UE generates jobs in this cell; unlisted UEs are always
        # present (mobility masks only its roamers)
        self.presence = presence or None
        self.stationary = rate_slots is None and self.presence is None
        self._wakes = sorted(
            {int(w) for w in wake_slots if 0 <= int(w) < n_slots}
        )

    # ------------------------------------------------------------- rates
    def fill(self, out: np.ndarray, start: int) -> None:
        """Fill `out[(L, n_ues)]` with per-slot per-UE rates for slots
        ``[start, start+L)`` (only called on non-stationary processes; the
        engine keeps its original one-time constant fill otherwise)."""
        length = out.shape[0]
        if self.rate_slots is None:
            out[:] = self.rate_slot
        else:
            out[:] = self.rate_slots[start:start + length, None]
        if self.presence:
            for ue, intervals in self.presence.items():
                out[:, ue] *= self._active_mask(intervals, start, length)

    def rates_at(self, s: int) -> np.ndarray:
        """Per-UE rate vector for slot `s` (reference draw-per-slot path)."""
        base = (
            self.rate_slot if self.rate_slots is None
            else float(self.rate_slots[s])
        )
        rates = np.full(self.n_ues, base)
        if self.presence:
            for ue, intervals in self.presence.items():
                if not _slot_active(intervals, s):
                    rates[ue] = 0.0
        return rates

    def mean_rate_slot(self) -> float:
        """Horizon-average per-slot per-UE rate (controller sizing aid)."""
        if self.rate_slots is None:
            return float(self.rate_slot)
        return float(np.mean(self.rate_slots))

    # ------------------------------------------------------------- wakes
    def next_wake(self, s: int) -> int:
        """Smallest forced-wake slot >= `s`, or `n_slots` when none."""
        i = bisect.bisect_left(self._wakes, s)
        return self._wakes[i] if i < len(self._wakes) else self.n_slots

    @staticmethod
    def _active_mask(
        intervals: Tuple[Tuple[int, int], ...], start: int, length: int
    ) -> np.ndarray:
        mask = np.zeros(length)
        for s0, s1 in intervals:
            lo, hi = max(s0 - start, 0), min(s1 - start, length)
            if lo < hi:
                mask[lo:hi] = 1.0
        return mask


def _slot_active(intervals: Tuple[Tuple[int, int], ...], s: int) -> bool:
    return any(s0 <= s < s1 for s0, s1 in intervals)


def _slot_times(n_slots: int, slot_s: float) -> np.ndarray:
    return np.arange(n_slots) * slot_s


def _mmpp_rate_slots(
    spec: MMPP, slot_s: float, n_slots: int, seed: int
) -> np.ndarray:
    rng = np.random.default_rng(
        [int(seed) % (2**32), _MMPP_STREAM, int(spec.salt) % (2**32)]
    )
    horizon = n_slots * slot_s
    edges, states = [0.0], [spec.start_on]
    t, on = 0.0, spec.start_on
    while t < horizon:
        t += rng.exponential(spec.mean_on_s if on else spec.mean_off_s)
        on = not on
        edges.append(t)
        states.append(on)
    # state holding at each slot-start time (step function on the chain)
    idx = np.searchsorted(np.asarray(edges), _slot_times(n_slots, slot_s),
                          side="right") - 1
    on_mask = np.asarray(states)[idx]
    return np.where(on_mask, spec.rate_on, spec.rate_off) * slot_s


def bind_arrivals(
    spec: Optional[ArrivalProcess],
    *,
    n_ues: int,
    lam_per_ue: float,
    slot_s: float,
    n_slots: int,
    seed: int = 0,
    presence: Optional[Dict[int, Tuple[Tuple[int, int], ...]]] = None,
) -> BoundArrivals:
    """Resolve a process spec for one engine. `spec=None` is the stationary
    default (`lam_per_ue`); `presence` is the mobility layer's per-UE
    activity mask for this cell (forces the non-stationary paths)."""
    if spec is None:
        spec = PoissonProcess()

    if isinstance(spec, PoissonProcess):
        rate = lam_per_ue if spec.rate_per_ue is None else spec.rate_per_ue
        return BoundArrivals(
            n_ues, n_slots, rate_slot=rate * slot_s, presence=presence
        )

    if isinstance(spec, PiecewiseRate):
        t = _slot_times(n_slots, slot_s)
        idx = np.searchsorted(np.asarray(spec.t_edges), t, side="right") - 1
        rate_slots = np.asarray(spec.rates)[idx] * slot_s
        wakes = [int(math.ceil(e / slot_s)) for e in spec.t_edges[1:]]
        return BoundArrivals(
            n_ues, n_slots, rate_slots=rate_slots, presence=presence,
            wake_slots=wakes,
        )

    if isinstance(spec, DiurnalRate):
        t = _slot_times(n_slots, slot_s)
        swing = 0.5 * (1.0 - np.cos(2.0 * np.pi * (t / spec.period_s + spec.phase)))
        rate_slots = (spec.base + (spec.peak - spec.base) * swing) * slot_s
        return BoundArrivals(
            n_ues, n_slots, rate_slots=rate_slots, presence=presence
        )

    if isinstance(spec, FlashCrowd):
        s0 = int(math.ceil(spec.t_start / slot_s))
        s1 = int(math.ceil(spec.t_end / slot_s))
        rate_slots = np.full(n_slots, spec.base * slot_s)
        rate_slots[s0:s1] = spec.spike * slot_s
        return BoundArrivals(
            n_ues, n_slots, rate_slots=rate_slots, presence=presence,
            wake_slots=(s0, s1),
        )

    if isinstance(spec, MMPP):
        rate_slots = _mmpp_rate_slots(spec, slot_s, n_slots, seed)
        return BoundArrivals(
            n_ues, n_slots, rate_slots=rate_slots, presence=presence
        )

    raise TypeError(f"unknown arrival process spec {type(spec).__name__}")
