"""Named-experiment registry + the shipped benchmark grids as specs.

The port's copy of `repro/experiments/registry.py` (imports and docstrings
rewritten only).

`register_experiment` guards against silent duplicate registration (a
name is an identity: two specs under one name means one of them silently
stops being run). The tracked capacity benchmarks are registered here as
declarative specs — `benchmarks/network_capacity.py` and friends are now
formatting layers over ``run(get_experiment(...))`` — together with the
reduced ``*_quick`` variants CI drives. Grid settings (rate grids, seeds,
horizons) are the exact values the tracked ``BENCH_*.json`` baselines
were produced under; the spec builders take overrides so reduced runs are
`dataclasses.replace`-style variations of the same definition, not forks.

The quick grids mirror ``benchmarks/perf_speedup.py``'s
``QUICK_NETWORK_KW`` / ``QUICK_BATCHING_KW`` (the configs the CI perf
regression gate times); the reference's tests pin the two against each
other, and tests/test_torch_experiments.py holds these specs equal to the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..control import MobilityConfig
from ..core.simulator import SchemeConfig
from ..faults import FaultSpec, LinkOutage, NodeOutage
from ..network.routing import POLICIES
from .spec import (
    ControlSpec,
    ExperimentSpec,
    SweepSpec,
    SystemSpec,
    VariantSpec,
    WorkloadSpec,
)

__all__ = [
    "register_experiment",
    "get_experiment",
    "list_experiments",
    "network_capacity_spec",
    "network_scenarios_spec",
    "batching_capacity_spec",
    "control_capacity_spec",
    "resilience_spec",
    "CONTROL_ARMS",
    "CONTROL_STATIC_ARMS",
    "RESILIENCE_ARMS",
    "RESILIENCE_FAULT_CASES",
]

_EXPERIMENTS: Dict[str, ExperimentSpec] = {}


def register_experiment(
    spec: ExperimentSpec, *, replace: bool = False
) -> ExperimentSpec:
    """Validate and register `spec` under its name. Duplicate names raise
    unless ``replace=True`` — re-registering silently would make one of
    the two definitions unrunnable by name."""
    if not isinstance(spec, ExperimentSpec):
        raise TypeError(f"expected ExperimentSpec, got {type(spec).__name__}")
    if not replace and spec.name in _EXPERIMENTS:
        raise ValueError(
            f"experiment {spec.name!r} is already registered; pass "
            "replace=True to override it deliberately"
        )
    spec.validate()
    _EXPERIMENTS[spec.name] = spec
    return spec


def get_experiment(name: str) -> ExperimentSpec:
    try:
        return _EXPERIMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown experiment {name!r}; known: {sorted(_EXPERIMENTS)}"
        ) from None


def list_experiments() -> List[str]:
    return sorted(_EXPERIMENTS)


# ----------------------------------------------------------- spec builders
def _swept_policies() -> List[str]:
    # "controlled" without a bound controller decides exactly like
    # slack_aware — it is exercised by control_capacity, not the raw sweep
    return sorted(p for p in POLICIES if p != "controlled")


def network_capacity_spec(
    rates: Optional[Sequence[float]] = None,
    sim_time: float = 6.0,
    warmup: float = 1.0,
    n_seeds: int = 3,
    alpha: float = 0.95,
    name: str = "network_capacity",
) -> ExperimentSpec:
    """Aggregate-rate sweep over the 3-cell hetero fleet, one arm per
    routing policy (the BENCH_network.json grid)."""
    system = SystemSpec(kind="multi_cell", topology="three_cell_hetero")
    return ExperimentSpec(
        name=name,
        description=(
            "Def.-2 service capacity per routing policy on the 3-cell "
            "heterogeneous deployment (ar_translation, Table I)"
        ),
        workload=WorkloadSpec(scenario="ar_translation"),
        system=system,
        sweep=SweepSpec(
            rates=tuple(float(r) for r in (rates or range(30, 191, 10))),
            n_seeds=n_seeds,
            sim_time=sim_time,
            warmup=warmup,
            alpha=alpha,
        ),
        variants=tuple(
            VariantSpec(name=p, system=dataclasses.replace(system, policy=p))
            for p in _swept_policies()
        ),
    )


def network_scenarios_spec(
    scenario_loads: Dict[str, float],
    sim_time: float = 6.0,
    warmup: float = 1.0,
    name: str = "network_scenarios",
) -> ExperimentSpec:
    """Fixed-load pass enumerating non-default scenarios x every policy
    (one single-rate arm each), so every registered workload exercises
    the fleet."""
    system = SystemSpec(kind="multi_cell", topology="three_cell_hetero")
    loads = dict(scenario_loads)
    if not loads:
        raise ValueError("scenario_loads must name at least one scenario")
    first = next(iter(loads.values()))
    return ExperimentSpec(
        name=name,
        description="per-scenario satisfaction at a fixed aggregate load",
        workload=WorkloadSpec(scenario="ar_translation"),
        system=system,
        sweep=SweepSpec(
            rates=(float(first),),
            n_seeds=1,
            sim_time=sim_time,
            warmup=warmup,
        ),
        variants=tuple(
            VariantSpec(
                name=f"{sc}/{p}",
                workload=WorkloadSpec(scenario=sc),
                system=dataclasses.replace(system, policy=p),
                rates=(float(load),),
            )
            for sc, load in loads.items()
            for p in _swept_policies()
        ),
    )


# ICC joint-management stance at the batched node: priority queue,
# token-granular deadline dropping, RAN-sited wireline latency.
_BATCHED_SCHEME = SchemeConfig("icc_batched", 0.005, True, "priority", "joint")

# aggregate-rate grids bracketing each GPU's expected capacity range
BATCHING_RATE_GRIDS: Dict[str, Tuple[float, ...]] = {
    "l4": (0.25, 0.5, 1.0, 2.0, 3.0, 4.0, 5.0),
    "a100": (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 13.0, 16.0),
    "h100": (2.0, 4.0, 6.0, 9.0, 12.0, 16.0, 22.0, 28.0, 36.0, 44.0),
}
BATCHING_BATCHES = (1, 4, 8, 16)


def batching_capacity_spec(
    gpus: Sequence[str] = ("a100", "h100", "l4"),
    batches: Sequence[int] = BATCHING_BATCHES,
    rate_grids: Optional[Dict[str, Sequence[float]]] = None,
    sim_time: float = 30.0,
    warmup: float = 2.0,
    n_seeds: int = 3,
    alpha: float = 0.95,
    name: str = "batching_capacity",
) -> ExperimentSpec:
    """Single-cell continuous-batching sweep: one arm per (GPU, max_batch)
    with a per-GPU rate grid (the BENCH_batching.json matrix)."""
    grids = dict(BATCHING_RATE_GRIDS, **(rate_grids or {}))
    system = SystemSpec(
        kind="single_cell",
        scheme=_BATCHED_SCHEME,
        gpu=gpus[0],
        gpu_count=1,
        node_kind="batched",
    )
    return ExperimentSpec(
        name=name,
        description=(
            "Def.-2 capacity of a batched single-cell node across "
            "max_batch x GPU (rag_doc_qa: KV-cache pressure vs compute)"
        ),
        workload=WorkloadSpec(scenario="rag_doc_qa"),
        system=system,
        sweep=SweepSpec(
            rates=tuple(float(r) for r in grids[gpus[0]]),
            n_seeds=n_seeds,
            sim_time=sim_time,
            warmup=warmup,
            alpha=alpha,
        ),
        variants=tuple(
            VariantSpec(
                name=f"{gpu}/mb{mb}",
                system=dataclasses.replace(system, gpu=gpu, max_batch=mb),
                rates=tuple(float(r) for r in grids[gpu]),
            )
            for gpu in gpus
            for mb in batches
        ),
    )


# control arm name -> (routing policy, controller preset)
CONTROL_ARMS: Dict[str, Tuple[str, Optional[str]]] = {
    "local_only": ("local_only", None),
    "mec_only": ("mec_only", None),
    "least_loaded": ("least_loaded", None),
    "slack_aware": ("slack_aware", None),
    "reactive": ("slack_aware", "reactive"),
    "slack_aware_joint": ("controlled", "slack_aware_joint"),
}
CONTROL_STATIC_ARMS = [a for a, (_, c) in CONTROL_ARMS.items() if c is None]
CONTROL_WINDOW_S = 0.5


def control_capacity_spec(
    load: float = 40.0,
    sim_time: float = 10.0,
    warmup: float = 1.0,
    n_seeds: int = 3,
    diurnal_seeds: Optional[int] = None,
    name: str = "control_capacity",
) -> ExperimentSpec:
    """Flash-crowd control arms + diurnal no-harm + mobility exercise
    (the BENCH_control.json grid): fixed-load runs scored on windowed
    transient satisfaction."""
    diurnal_seeds = n_seeds if diurnal_seeds is None else diurnal_seeds
    system = SystemSpec(kind="multi_cell", topology="three_cell_hetero")
    flash = WorkloadSpec(scenario="flash_crowd")
    variants = [
        VariantSpec(
            name=arm,
            workload=flash,
            system=dataclasses.replace(system, policy=pol),
            control=ControlSpec(controller=ctl),
        )
        for arm, (pol, ctl) in CONTROL_ARMS.items()
    ]
    for arm in ("slack_aware", "slack_aware_joint"):
        pol, ctl = CONTROL_ARMS[arm]
        variants.append(
            VariantSpec(
                name=f"diurnal/{arm}",
                workload=WorkloadSpec(scenario="diurnal_chat"),
                system=dataclasses.replace(system, policy=pol),
                control=ControlSpec(controller=ctl),
                sim_time=max(sim_time, 12.0),
                n_seeds=diurnal_seeds,
            )
        )
    mob = MobilityConfig(n_roamers=6, dwell_mean_s=0.5)
    for arm in ("slack_aware", "slack_aware_joint"):
        pol, ctl = CONTROL_ARMS[arm]
        variants.append(
            VariantSpec(
                name=f"mobility/{arm}",
                workload=WorkloadSpec(scenario="flash_crowd", mobility=mob),
                system=dataclasses.replace(system, policy=pol),
                control=ControlSpec(controller=ctl),
                n_seeds=min(n_seeds, 2),
            )
        )
    return ExperimentSpec(
        name=name,
        description=(
            "joint bandwidth-compute control under a flash crowd, plus "
            "diurnal no-harm and mobility passes (windowed Def.-1)"
        ),
        workload=flash,
        system=system,
        sweep=SweepSpec(
            rates=(float(load),),
            n_seeds=n_seeds,
            sim_time=sim_time,
            warmup=warmup,
            window_s=CONTROL_WINDOW_S,
        ),
        variants=tuple(variants),
    )


# survivability arm name -> routing policy: the ICC-native distributed
# stance vs the centralized 5G-MEC baseline (deliberately health-blind)
RESILIENCE_ARMS: Dict[str, str] = {
    "icc": "slack_aware",
    "mec": "mec_only",
}
# fault case names swept per arm; the windows are parameters of
# `resilience_spec` so reduced grids shift them with the horizon
RESILIENCE_FAULT_CASES = ("baseline", "node_crash", "backhaul")
RESILIENCE_WINDOW_S = 1.0


def resilience_spec(
    rates: Optional[Sequence[float]] = None,
    sim_time: float = 8.0,
    warmup: float = 1.0,
    n_seeds: int = 2,
    t_fail: float = 3.0,
    t_recover: float = 6.0,
    alpha: float = 0.95,
    name: str = "resilience",
) -> ExperimentSpec:
    """ICC-vs-MEC survivability grid (the BENCH_resilience.json study).

    {icc=slack_aware, mec=mec_only} x {baseline, node_crash, backhaul} on
    the 3-cell hetero fleet. Both fault cases target the MEC tier — the
    centralized baseline's single point of failure:

      node_crash  the pooled MEC compute node crashes over
                  [t_fail, t_recover): queue, in-flight batch, and KV
                  cache are lost; health-aware ICC routing fails over to
                  the RAN nodes, mec_only keeps dispatching into the hole
      backhaul    every gNB->MEC wireline goes down for the same window
                  (store-and-forward: queued transfers deliver at
                  recovery); ICC keeps jobs RAN-local, mec_only pays the
                  full outage on every job

    The baseline case carries an explicit empty `FaultSpec()` — by the
    opt-in contract it is bit-identical to ``faults=None``, so the
    fault-free curves double as a standing regression check of that
    contract (asserted by the CI quick gate).

    Windowed Def.-1 (``window_s=1.0``) exposes the outage-window
    satisfaction collapse that rate-averaged scoring would smear out.
    """
    if not warmup < t_fail < t_recover < sim_time:
        raise ValueError(
            f"need warmup < t_fail < t_recover < sim_time, got "
            f"{warmup}/{t_fail}/{t_recover}/{sim_time}"
        )
    system = SystemSpec(kind="multi_cell", topology="three_cell_hetero")
    cases: Dict[str, FaultSpec] = {
        "baseline": FaultSpec(),
        "node_crash": FaultSpec(
            node_outages=(NodeOutage("mec", t_fail, t_recover),)
        ),
        "backhaul": FaultSpec(
            link_outages=(LinkOutage(t_fail=t_fail, t_recover=t_recover,
                                     node="mec"),)
        ),
    }
    assert tuple(cases) == RESILIENCE_FAULT_CASES
    return ExperimentSpec(
        name=name,
        description=(
            "ICC vs MEC-only survivability under a MEC node crash and a "
            "backhaul outage (windowed Def.-1, 3-cell hetero fleet)"
        ),
        workload=WorkloadSpec(scenario="ar_translation"),
        system=system,
        sweep=SweepSpec(
            rates=tuple(float(r) for r in (rates or range(30, 191, 20))),
            n_seeds=n_seeds,
            sim_time=sim_time,
            warmup=warmup,
            alpha=alpha,
            window_s=RESILIENCE_WINDOW_S,
        ),
        variants=tuple(
            VariantSpec(
                name=f"{arm}/{case}",
                system=dataclasses.replace(system, policy=pol),
                faults=cases[case],
            )
            for arm, pol in RESILIENCE_ARMS.items()
            for case in RESILIENCE_FAULT_CASES
        ),
    )


# -------------------------------------------------- default registrations
# Full-fidelity grids: the definitions the tracked BENCH_*.json baselines
# are produced from (benchmarks/{network,batching,control}_capacity.py are
# formatting layers over these).
register_experiment(network_capacity_spec())
register_experiment(
    network_scenarios_spec({"chatbot": 20.0, "vision_prompt": 15.0})
)
register_experiment(batching_capacity_spec())
register_experiment(control_capacity_spec())
register_experiment(resilience_spec())

# Reduced CI grids — mirror benchmarks/perf_speedup.py QUICK_*_KW (the
# configs BENCH_perf.json quick_ref_s times); held equal to the
# reference's in tests/test_torch_experiments.py.
register_experiment(
    network_capacity_spec(rates=[40, 80, 120], sim_time=4.0, n_seeds=1,
                          name="network_capacity_quick")
)
register_experiment(
    batching_capacity_spec(
        gpus=("a100", "l4"),
        batches=(1, 8),
        rate_grids={"l4": (0.25, 1.0, 3.0), "a100": (1.0, 3.0, 6.0, 10.0)},
        sim_time=12.0,
        warmup=1.0,
        n_seeds=1,
        name="batching_capacity_quick",
    )
)
register_experiment(
    control_capacity_spec(sim_time=8.0, n_seeds=1,
                          name="control_capacity_quick")
)
register_experiment(
    resilience_spec(rates=(40.0, 100.0), sim_time=6.0, n_seeds=1,
                    t_fail=2.0, t_recover=4.5, name="resilience_quick")
)
