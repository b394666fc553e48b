"""repro_torch.experiments — the unified declarative experiment API.

The port's copy of `repro/experiments/__init__.py` (imports and docstrings
rewritten only).

One spec, one runner, one result schema: every capacity study in this
repo — the paper's single-cell ICC-vs-MEC comparison, the multi-cell
routing sweeps, the batched-serving matrix, the flash-crowd control
arms — is an `ExperimentSpec` (a frozen, JSON-round-trippable dataclass
tree) executed by `run()` into an `ExperimentResult` (per-point
`SimResult`s, Def.-1/Def.-2 `CapacityCurve`s, spec echo, schema version).

  spec.py      the spec tree + exact to_dict/from_dict/JSON codec
  registry.py  register_experiment/get_experiment + the shipped grids
               (the tracked benchmarks, and their *_quick CI variants)
  runner.py    run(spec): one flat (arm x rate x seed) grid through one
               process pool, dispatching per arm to the single-cell or
               multi-cell engine
  result.py    the unified result schema + stable JSON emission
  cache.py     content-addressed result cache: (spec hash, arm
               fingerprint, rate, seed) -> stored point, invalidated on
               schema or engine-code change
  dispatch.py  run_sharded(spec): cache lookup, cost-balanced shard
               packing, pluggable executor, merge bit-identical to run()
  suites.py    named experiment groups + the bench_doc writers that
               regenerate every tracked BENCH_*.json in one command
  validate.py  schema checks for the tracked BENCH_*.json baselines +
               suite-coverage check

CLI:  python -m repro_torch.experiments list
      python -m repro_torch.experiments show <name>
      python -m repro_torch.experiments run <name> [--workers N] [--quick]
                                             [--out f.json] [--points ...]
                                             [--cache DIR] [--shards N]
      python -m repro_torch.experiments suite run <name> [--cache DIR]
      python -m repro_torch.experiments validate-bench [files...] [--suite]
"""

from .cache import (
    CacheStats,
    ResultCache,
    arm_fingerprint,
    code_fingerprint,
    spec_hash,
)
from .dispatch import (
    CostModel,
    LocalExecutor,
    Shard,
    plan_shards,
    run_sharded,
)
from .registry import (
    batching_capacity_spec,
    control_capacity_spec,
    get_experiment,
    list_experiments,
    network_capacity_spec,
    network_scenarios_spec,
    register_experiment,
    resilience_spec,
)
from .result import (
    ArmResult,
    CapacityCurve,
    ExperimentResult,
    PointResult,
    PointRun,
)
from .runner import assemble_result, run
from .spec import (
    MODEL_PROFILES,
    SCHEMA_VERSION,
    TOPOLOGIES,
    ControlSpec,
    ExperimentSpec,
    SweepSpec,
    SystemSpec,
    VariantSpec,
    WorkloadSpec,
)
from .suites import (
    Suite,
    SuiteEntry,
    get_suite,
    list_suites,
    register_suite,
    run_suite,
)
from .validate import validate_bench, validate_suite_coverage

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
    "ArmResult",
    "CapacityCurve",
    "ExperimentResult",
    "PointResult",
    "PointRun",
    "run",
    "assemble_result",
    "register_experiment",
    "get_experiment",
    "list_experiments",
    "network_capacity_spec",
    "network_scenarios_spec",
    "batching_capacity_spec",
    "control_capacity_spec",
    "resilience_spec",
    "CacheStats",
    "ResultCache",
    "spec_hash",
    "arm_fingerprint",
    "code_fingerprint",
    "CostModel",
    "LocalExecutor",
    "Shard",
    "plan_shards",
    "run_sharded",
    "Suite",
    "SuiteEntry",
    "register_suite",
    "get_suite",
    "list_suites",
    "run_suite",
    "validate_bench",
    "validate_suite_coverage",
]
