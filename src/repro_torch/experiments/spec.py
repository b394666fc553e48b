"""Declarative experiment specs: one serializable tree per experiment.

The port's copy of `repro/experiments/spec.py` (imports and docstrings
rewritten only).

Every headline number in this repo is produced by the same experiment
shape — (scenario x system x control) swept over a rate grid x seeds —
yet before this layer each benchmark re-implemented the grid/seed/JSON
plumbing and the two simulators took overlapping-but-inconsistent knobs
(``simulate(controller=)`` vs ``NetSimConfig.controller``,
``SimConfig.arrivals`` vs ``NetSimConfig.arrival``). The spec tree is the
single declarative surface over both:

  WorkloadSpec   what the UEs ask for: a scenario (registry name or inline
                 `Scenario`), an optional arrival-process override, and
                 optional UE mobility
  SystemSpec     what serves it: a multi-cell topology + routing policy, or
                 a single-cell scheme + GPU; node kind (classic/batched)
                 and max_batch for either
  ControlSpec    the online controller preset (eagerly validated)
  FaultSpec      (repro_torch.faults, on the root/variant) the fault-injection
                 scenario: node outages / crash processes, link outages,
                 brownouts — strictly opt-in, None = fault-free fast path
  SweepSpec      how to measure: rate grid, seeds (every grid point derives
                 its seed as ``base_seed + 1000 * seed_index``, the
                 convention all tracked baselines were produced under),
                 sim horizon, transient window, Def.-2 alpha, workers
  VariantSpec    a named arm overriding any of the above sub-specs (a grid
                 benchmark is one base spec + one variant per arm)

`ExperimentSpec` composes them and round-trips exactly through
``to_dict``/``from_dict`` and JSON (``from_dict(to_dict(spec)) == spec``,
pinned per registered experiment in tests/test_torch_experiments.py). Nested
frozen dataclasses (scenarios, arrival processes, topologies, schemes,
hardware specs) are encoded with a ``__type__`` tag against an explicit
allow-list, so a spec file names everything it runs. Changing any field of
any spec class changes the emitted JSON: the golden test fails and
`SCHEMA_VERSION` must be bumped with it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple, Union

from ..control import ControllerLike, MobilityConfig, validate_controller
from ..control.arrivals import (
    MMPP,
    ArrivalProcess,
    DiurnalRate,
    FlashCrowd,
    PiecewiseRate,
    PoissonProcess,
)
from ..core.channel import ChannelConfig
from ..core.latency_model import (
    LLAMA2_7B,
    HardwareSpec,
    ModelProfile,
    ModelService,
)
from ..core.simulator import SchemeConfig
from ..faults import (
    Brownout,
    FaultSpec,
    LinkOutage,
    NodeCrashProcess,
    NodeOutage,
)
from ..network.fleet import GPU_SPECS
from ..network.routing import POLICIES
from ..network.scenarios import SCENARIOS, Scenario
from ..network.topology import SiteConfig, TopologyConfig, three_cell_hetero

__all__ = [
    "SCHEMA_VERSION",
    "MODEL_PROFILES",
    "TOPOLOGIES",
    "WorkloadSpec",
    "SystemSpec",
    "ControlSpec",
    "SweepSpec",
    "VariantSpec",
    "ExperimentSpec",
    "ResolvedArm",
]

# Bump whenever the serialized shape of any spec class changes (field
# added/renamed/removed, encoding changed), in step with the reference:
# tests/test_torch_experiments.py holds every spec's JSON equal to its.
# History: 1 = the initial schema; 2 = fault injection (FaultSpec on the
# spec/variant tree, SweepSpec.task_timeout_s). Version-1 files still load:
# every v2 field is additive with a None/absent default (see from_dict).
SCHEMA_VERSION = 2

# older schema versions from_dict still accepts (additive-only changes)
_COMPAT_VERSIONS = (1, SCHEMA_VERSION)

# name -> ModelProfile (the analytic latency model's model registry)
MODEL_PROFILES: Dict[str, ModelProfile] = {LLAMA2_7B.name: LLAMA2_7B}

# name -> TopologyConfig (deployments a spec can reference by name; inline
# TopologyConfig trees serialize too, this is just the shorthand)
TOPOLOGIES: Dict[str, TopologyConfig] = {
    "three_cell_hetero": three_cell_hetero(),
}


# --------------------------------------------------------------- the tree
@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What the UEs generate: scenario + optional arrival/mobility layers."""

    scenario: Union[str, Scenario] = "ar_translation"
    # arrival-process override; None = the scenario's own spec
    arrival: Optional[ArrivalProcess] = None
    mobility: Optional[MobilityConfig] = None


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """What serves the workload.

    ``kind="multi_cell"``: `topology` (registered name or inline
    `TopologyConfig`) + `policy` route jobs across the fleet via
    `repro_torch.network.simulate_network`. ``kind="single_cell"``: `scheme` +
    `gpu_count` x `gpu` runs the paper's one-gNB pipeline via
    `repro_torch.core.simulate`. `node_kind`/`max_batch` select classic whole-job
    or token-granular batched compute for either.
    """

    kind: str = "multi_cell"  # "multi_cell" | "single_cell"
    # multi-cell
    topology: Union[str, TopologyConfig] = "three_cell_hetero"
    policy: str = "slack_aware"
    # single-cell
    scheme: Union[str, SchemeConfig] = "icc"
    gpu: Union[str, HardwareSpec] = "gh200-nvl2"
    gpu_count: int = 2  # paper: two GH200-NVL2 at the compute node
    # served model profile (both engines; multi-cell forwards it to the
    # whole fleet via NetSimConfig.model)
    model: Union[str, ModelProfile] = "llama2-7b"
    # single-cell LatencyModel fidelity; None = "paper" for classic,
    # "extended" for batched (batch/context-dependent iterations).
    # Multi-cell fleets derive fidelity from node_kind (build_fleet_node).
    fidelity: Optional[str] = None
    # both
    node_kind: str = "classic"  # "classic" | "batched"
    max_batch: int = 8


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    """The online control loop: a `repro_torch.control` preset name, or None for
    an uncontrolled run. Unknown preset names fail here, at spec
    construction — not deep inside the run."""

    controller: Optional[ControllerLike] = None

    def __post_init__(self):
        validate_controller(self.controller)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The measurement grid. Each (rate, seed_index) point is one
    independent simulation seeded ``base_seed + 1000 * seed_index`` — the
    derivation every tracked baseline was produced under, so spec-driven
    reruns are bit-identical to the historical sweeps."""

    rates: Tuple[float, ...]  # aggregate jobs/s grid (Def.-2 x-axis)
    n_seeds: int = 3
    base_seed: int = 0
    sim_time: float = 10.0
    warmup: float = 2.0
    # transient-metric window length (score_jobs windows); None = off
    window_s: Optional[float] = None
    alpha: float = 0.95  # Def.-2 satisfaction threshold
    fast: bool = True  # False = reference draw-per-slot engine
    workers: Union[int, str, None] = 0  # default pool size for run()
    # resilient parallel_map: per-point wall-clock budget (seconds); a
    # point that keeps timing out / raising becomes a structured error on
    # its PointRun instead of hanging the sweep. None = historical
    # fail-fast behavior.
    task_timeout_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One named arm of an experiment: full replacement sub-specs for
    whatever differs from the base (None = inherit the base's), plus the
    per-arm sweep overrides grid benchmarks need (a per-GPU rate grid, a
    reduced mobility seed count, a longer diurnal horizon)."""

    name: str
    workload: Optional[WorkloadSpec] = None
    system: Optional[SystemSpec] = None
    control: Optional[ControlSpec] = None
    rates: Optional[Tuple[float, ...]] = None
    n_seeds: Optional[int] = None
    sim_time: Optional[float] = None
    # fault scenario override; None = inherit the base spec's. To switch
    # faults *off* in one arm of a faulted experiment, override with an
    # empty FaultSpec() (empty == fault-free by the opt-in contract).
    faults: Optional[FaultSpec] = None


@dataclasses.dataclass(frozen=True)
class ResolvedArm:
    """A variant merged over its base: everything one arm's grid needs.
    Not part of the serialized schema — `ExperimentSpec.resolve_arms()`
    produces these for the runner (picklable: workers receive one)."""

    name: str
    workload: WorkloadSpec
    system: SystemSpec
    control: ControlSpec
    sweep: SweepSpec  # rates/n_seeds/sim_time already overridden
    faults: Optional[FaultSpec] = None  # variant-over-base, like the rest

    @property
    def rates(self) -> Tuple[float, ...]:
        return self.sweep.rates


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The root: one experiment = workload x system x control x sweep,
    optionally fanned into named variant arms. With no variants the spec
    itself is the single arm; with variants, each variant is one arm and
    the base sub-specs are the template they override."""

    name: str
    workload: WorkloadSpec
    system: SystemSpec
    sweep: SweepSpec
    control: ControlSpec = dataclasses.field(default_factory=ControlSpec)
    variants: Tuple[VariantSpec, ...] = ()
    description: str = ""
    # fault-injection scenario applied to every arm (variants override);
    # None keeps the experiment on the fault-free fast path bit-identically
    faults: Optional[FaultSpec] = None

    # ------------------------------------------------------------ resolve
    def resolve_arms(self) -> List[ResolvedArm]:
        if not self.variants:
            return [
                ResolvedArm(self.name, self.workload, self.system,
                            self.control, self.sweep, self.faults)
            ]
        arms = []
        for v in self.variants:
            sw = self.sweep
            over = {
                k: val for k, val in (
                    ("rates", v.rates),
                    ("n_seeds", v.n_seeds),
                    ("sim_time", v.sim_time),
                ) if val is not None
            }
            if over:
                sw = dataclasses.replace(sw, **over)
            arms.append(
                ResolvedArm(
                    v.name,
                    v.workload if v.workload is not None else self.workload,
                    v.system if v.system is not None else self.system,
                    v.control if v.control is not None else self.control,
                    sw,
                    v.faults if v.faults is not None else self.faults,
                )
            )
        return arms

    def validate(self) -> "ExperimentSpec":
        """Eagerly resolve every registry reference in every arm, so a
        typo'd scenario/policy/controller/GPU name fails before any
        simulation starts (and before a spec is registered)."""
        names = [a.name for a in self.resolve_arms()]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate arm names in {self.name!r}: {names}")
        for arm in self.resolve_arms():
            resolve_scenario(arm.workload.scenario)
            sysm = arm.system
            resolve_model(sysm.model)  # both engines serve a model profile
            if sysm.kind == "multi_cell":
                resolve_topology(sysm.topology)
                if isinstance(sysm.policy, str) and sysm.policy not in POLICIES:
                    raise KeyError(
                        f"unknown routing policy {sysm.policy!r}; "
                        f"known: {sorted(POLICIES)}"
                    )
            elif sysm.kind == "single_cell":
                resolve_scheme(sysm.scheme)
                resolve_gpu(sysm.gpu)
            else:
                raise ValueError(
                    f"unknown system kind {sysm.kind!r} "
                    "(expected 'multi_cell' or 'single_cell')"
                )
            if sysm.node_kind not in ("classic", "batched"):
                raise ValueError(f"unknown node_kind {sysm.node_kind!r}")
            if sysm.kind == "single_cell" and arm.workload.mobility is not None:
                raise ValueError(
                    f"arm {arm.name!r}: mobility requires a multi_cell system"
                )
            if (
                sysm.kind == "single_cell"
                and arm.faults is not None
                and arm.faults.link_outages
            ):
                raise ValueError(
                    f"arm {arm.name!r}: link faults require a multi_cell "
                    "system (single-cell has no wireline fabric)"
                )
            if not arm.sweep.rates:
                raise ValueError(f"arm {arm.name!r} has an empty rate grid")
            if arm.sweep.n_seeds < 1:
                raise ValueError(f"arm {arm.name!r} needs n_seeds >= 1")
        return self

    # ---------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        d = _encode(self)
        d["schema_version"] = SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        version = d.get("schema_version")
        if version not in _COMPAT_VERSIONS:
            raise ValueError(
                f"spec schema_version {version!r} not in supported "
                f"{_COMPAT_VERSIONS} (a spec without a version is not trusted)"
            )
        d = {k: v for k, v in d.items() if k != "schema_version"}
        spec = _decode(dict(d, __type__="ExperimentSpec"))
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(f"decoded {type(spec).__name__}, not ExperimentSpec")
        return spec

    def to_json(self) -> str:
        """Stable JSON emission (sorted keys): byte-identical for equal
        specs, the form the golden test pins."""
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))


# ------------------------------------------------------- registry lookups
def resolve_scenario(scenario: Union[str, Scenario]) -> Scenario:
    if isinstance(scenario, Scenario):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise KeyError(
            f"unknown scenario {scenario!r}; known: {sorted(SCENARIOS)}"
        ) from None


def resolve_topology(topology: Union[str, TopologyConfig]) -> TopologyConfig:
    if isinstance(topology, TopologyConfig):
        return topology
    try:
        return TOPOLOGIES[topology]
    except KeyError:
        raise KeyError(
            f"unknown topology {topology!r}; known: {sorted(TOPOLOGIES)}"
        ) from None


def resolve_scheme(scheme: Union[str, SchemeConfig]) -> SchemeConfig:
    from ..core.simulator import SCHEMES  # SCHEMES only; class imported above

    if isinstance(scheme, SchemeConfig):
        return scheme
    try:
        return SCHEMES[scheme]
    except KeyError:
        raise KeyError(
            f"unknown scheme {scheme!r}; known: {sorted(SCHEMES)}"
        ) from None


def resolve_gpu(gpu: Union[str, HardwareSpec]) -> HardwareSpec:
    if isinstance(gpu, HardwareSpec):
        return gpu
    try:
        return GPU_SPECS[gpu]
    except KeyError:
        raise KeyError(
            f"unknown GPU {gpu!r}; known: {sorted(GPU_SPECS)}"
        ) from None


def resolve_model(model: Union[str, ModelProfile]) -> ModelProfile:
    if isinstance(model, ModelProfile):
        return model
    try:
        return MODEL_PROFILES[model]
    except KeyError:
        raise KeyError(
            f"unknown model profile {model!r}; known: {sorted(MODEL_PROFILES)}"
        ) from None


# ------------------------------------------------------------------ codec
# Only these types may appear inside a serialized spec: an explicit
# allow-list, so from_dict can never be steered into constructing
# something a spec file was not meant to contain.
_CODEC_TYPES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        PoissonProcess, PiecewiseRate, DiurnalRate, FlashCrowd, MMPP,
        MobilityConfig, ChannelConfig, SiteConfig, TopologyConfig,
        SchemeConfig, Scenario, HardwareSpec, ModelProfile, ModelService,
        NodeOutage, NodeCrashProcess, LinkOutage, Brownout, FaultSpec,
        WorkloadSpec, SystemSpec, ControlSpec, SweepSpec, VariantSpec,
        ExperimentSpec,
    )
}


def _encode(obj):
    """Encode a spec value into JSON-safe primitives; dataclasses become
    ``{"__type__": ClassName, ...fields}`` (every field written, so the
    serialized form is fully explicit and drift is loud)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _CODEC_TYPES:
            raise TypeError(
                f"{name} is not a serializable spec type; inline specs must "
                f"be built from: {sorted(_CODEC_TYPES)}"
            )
        out = {"__type__": name}
        for f in dataclasses.fields(obj):
            out[f.name] = _encode(getattr(obj, f.name))
        return out
    if isinstance(obj, (tuple, list)):
        return [_encode(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(
        f"cannot serialize {type(obj).__name__} in an experiment spec "
        "(controller/policy instances are run-time only: use preset names)"
    )


def _tuple_fields(cls) -> set:
    """Field names declared as tuples (possibly Optional): their decoded
    lists are converted back so round-tripped specs compare equal."""
    out = set()
    for f in dataclasses.fields(cls):
        t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
        if "Tuple" in t or "tuple" in t:
            out.add(f.name)
    return out


def _decode(obj):
    if isinstance(obj, dict):
        name = obj.get("__type__")
        if name is None:
            raise ValueError(f"spec dict without __type__ tag: {sorted(obj)}")
        try:
            cls = _CODEC_TYPES[name]
        except KeyError:
            raise ValueError(
                f"unknown spec type {name!r}; known: {sorted(_CODEC_TYPES)}"
            ) from None
        tuples = _tuple_fields(cls)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in obj.items():
            if k == "__type__":
                continue
            if k not in known:
                raise ValueError(f"{name} has no field {k!r}")
            v = _decode(v)
            if k in tuples and isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj
