"""Workload scenario registry for the multi-cell simulator (the port's copy
of `repro/network/scenarios.py`, with a registry of its own).

The paper hard-codes one workload (Table I: real-time translation on AR
glasses, 15 in / 15 out tokens, 80 ms budget). Benchmarks and examples
enumerate this registry instead, so new workloads are one entry — not a
fork of the sweep script. Each scenario fixes the job shape (tokens in/out,
uplink payload per token), the per-UE arrival rate, and the E2E budget —
and, since the control subsystem, optionally a non-stationary arrival
process (`repro_torch.control.arrivals`); ``arrival=None`` keeps the stationary
Poisson source at `lam_per_ue`. For non-stationary scenarios `lam_per_ue`
is the rate `config_for_load` provisions the UE population for: the
*time-average* rate for periodic profiles (diurnal), the *base* rate for
transient-event profiles (flash_crowd) — there the nominal load is the
steady state and the spike is the overload on top of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..control.arrivals import ArrivalProcess, DiurnalRate, FlashCrowd

__all__ = [
    "Scenario",
    "SCENARIOS",
    "get_scenario",
    "list_scenarios",
    "register_scenario",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    n_input: int
    n_output: int
    b_total: float  # end-to-end latency budget (s)
    lam_per_ue: float = 1.0  # jobs/s/UE the load scaling provisions for
    # (time-average for periodic profiles, base rate for transient ones)
    bytes_per_token: float = 256.0  # uplink payload per prompt token
    arrival: Optional[ArrivalProcess] = None  # None = stationary Poisson


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="ar_translation",
            description="Table I: real-time speech translation on AR glasses",
            n_input=15,
            n_output=15,
            b_total=0.080,
        ),
        Scenario(
            name="chatbot",
            description="conversational assistant, long decode dominates",
            n_input=48,
            n_output=96,
            b_total=0.600,
            lam_per_ue=0.25,  # a user sends a message every few seconds
        ),
        Scenario(
            name="vision_prompt",
            description="image+text prompt, heavy uplink (patch embeddings)",
            n_input=320,
            n_output=12,
            b_total=0.250,
            lam_per_ue=0.5,
            bytes_per_token=512.0,
        ),
        Scenario(
            name="rag_doc_qa",
            description=(
                "RAG document QA: the retrieved context is edge-resident, so "
                "only the short query rides the uplink, but the full 2k-token "
                "context is prefilled and held in KV cache — the workload "
                "where cache pressure, not compute, caps batched serving"
            ),
            n_input=2048,
            n_output=32,
            b_total=4.0,
            lam_per_ue=0.25,
            bytes_per_token=16.0,  # query text only; context joins at the edge
        ),
        Scenario(
            name="diurnal_chat",
            description=(
                "chatbot traffic under a diurnal load curve: per-UE rate "
                "swings 0.05 -> 0.45 jobs/s over a 20 s cycle (a compressed "
                "day), so provisioning for the mean under-serves the peak"
            ),
            n_input=48,
            n_output=96,
            b_total=0.600,
            lam_per_ue=0.25,  # == (base + peak) / 2
            arrival=DiurnalRate(base=0.05, peak=0.45, period_s=20.0),
        ),
        Scenario(
            name="flash_crowd",
            description=(
                "vision-heavy prompts (320-token patch embeddings, ~1.3 Mbit "
                "uplink each) with a stadium-moment 12x arrival spike over "
                "t in [4, 6) s: the spike oversubscribes every cell's "
                "carrier, so equal-share uplink turns into "
                "everyone-finishes-late — the failure mode online admission "
                "and urgent-first bandwidth control exist for"
            ),
            n_input=320,
            n_output=24,
            b_total=0.120,
            lam_per_ue=0.5,  # base rate; the spike multiplies it by 12
            bytes_per_token=512.0,
            arrival=FlashCrowd(base=0.5, spike=6.0, t_start=4.0, t_end=6.0),
        ),
    )
}


def register_scenario(scenario: Scenario, *, replace: bool = False) -> Scenario:
    """Add `scenario` to the registry (the public path for new workloads —
    benchmarks, experiment specs, and `config_for_load` all look names up
    here). Duplicate names raise unless ``replace=True``: silently
    shadowing a shipped scenario would quietly change what every spec
    referencing that name measures."""
    if not isinstance(scenario, Scenario):
        raise TypeError(f"expected Scenario, got {type(scenario).__name__}")
    if not replace and scenario.name in SCENARIOS:
        raise ValueError(
            f"scenario {scenario.name!r} is already registered; pass "
            "replace=True to override it deliberately"
        )
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)
