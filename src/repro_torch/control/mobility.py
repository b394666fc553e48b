"""UE mobility across cells with Xn-handover re-homing (the port's copy of
`repro/control/mobility.py`, draw for draw; the multi-cell simulator,
`repro_torch.network`, moves the roamers).

A `MobilityConfig` adds `n_roamers` mobile UEs to *every* cell's UE
population (roamer k is UE index ``site.n_ues + k`` in each cell, so a
handover maps to a fixed index on both sides). A roamer is *homed* to one
cell at a time: its arrival rate is masked to zero everywhere else via the
arrival-process presence mask, so pre-drawn Poisson chunks already carry
the roamer's movement and the fast path needs no per-slot checks.

The trajectory — exponential dwell times, uniform next-cell choice — is
drawn once at bind time from a dedicated generator (sim seed, salt), like
the MMPP modulating chain: deterministic under a fixed seed, invisible to
the engines' arrival/channel streams.

What moves at a handover is the roamer's **in-flight uplink state**: bursts
still in the air at the old cell are evicted (queued bits, grant flags and
pending scheduling requests cleared) and re-injected into the new cell's
channel after the Xn transfer latency (`xn_handover_s`, defaulting to the
topology's inter-site latency). Jobs already past the air interface — on
the wireline or in a compute queue — are unaffected; nothing is lost or
double-counted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MobilityConfig", "HandoverEvent", "MobilityModel"]

_MOBILITY_STREAM = 0x6D6F6256  # "mobV": domain-separates trajectory draws


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    n_roamers: int = 4
    dwell_mean_s: float = 2.0
    # Xn context-transfer latency applied to re-homed in-flight bursts;
    # None = the topology's t_inter_site
    xn_handover_s: Optional[float] = None
    salt: int = 0


@dataclasses.dataclass(frozen=True)
class HandoverEvent:
    slot: int
    roamer: int
    frm: int
    to: int


class MobilityModel:
    """A config bound to one deployment's geometry: the pre-drawn handover
    schedule, per-cell presence masks, and the roamer -> UE-index map."""

    def __init__(
        self,
        cfg: MobilityConfig,
        n_cells: int,
        slot_s: float,
        n_slots: int,
        seed: int,
        static_ues: Sequence[int],
        xn_s: float,
    ):
        if len(static_ues) != n_cells:
            raise ValueError("static_ues must have one entry per cell")
        self.cfg = cfg
        self.n_roamers = cfg.n_roamers
        self.n_cells = n_cells
        self.slot_s = slot_s
        self.n_slots = n_slots
        self.static_ues = list(static_ues)
        self.xn_s = xn_s if cfg.xn_handover_s is None else cfg.xn_handover_s
        rng = np.random.default_rng(
            [int(seed) % (2**32), _MOBILITY_STREAM, int(cfg.salt) % (2**32)]
        )
        events: List[HandoverEvent] = []
        # per cell: roamer -> [(on_slot, off_slot), ...]
        ivals: List[Dict[int, List[Tuple[int, int]]]] = [
            {} for _ in range(n_cells)
        ]
        for k in range(cfg.n_roamers):
            cell = k % n_cells
            t, s_from = 0.0, 0
            while n_cells > 1:
                t += rng.exponential(cfg.dwell_mean_s)
                s = int(t / slot_s)
                if s >= n_slots:
                    break
                nxt = int(rng.integers(0, n_cells - 1))
                if nxt >= cell:
                    nxt += 1
                if s > s_from:
                    ivals[cell].setdefault(k, []).append((s_from, s))
                events.append(HandoverEvent(slot=s, roamer=k, frm=cell, to=nxt))
                cell, s_from = nxt, s
            ivals[cell].setdefault(k, []).append((s_from, n_slots))
        self.events = sorted(events, key=lambda e: (e.slot, e.roamer))
        self._ivals = ivals

    def ue_index(self, cell: int, roamer: int) -> int:
        """The roamer's UE index inside `cell`'s engine."""
        return self.static_ues[cell] + roamer

    def presence_for_cell(
        self, cell: int
    ) -> Optional[Dict[int, Tuple[Tuple[int, int], ...]]]:
        """Presence mask for `bind_arrivals`: every roamer UE index mapped
        to the slot intervals it is homed here (absent roamers still get an
        entry with no intervals, so their rate is fully masked)."""
        if self.n_roamers == 0:
            return None
        return {
            self.ue_index(cell, k): tuple(self._ivals[cell].get(k, ()))
            for k in range(self.n_roamers)
        }
