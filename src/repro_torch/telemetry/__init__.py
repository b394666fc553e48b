"""repro_torch.telemetry — trace recorder, phase profiler, derived metrics
and Chrome traces (the port's copy of `repro/telemetry`).

Pass an `EventRecorder` as ``recorder=`` or a `PhaseProfiler` as
``profiler=`` to `repro_torch.core.simulate` or
`repro_torch.network.simulate_network`. Both are free when off and leave
fixed-seed results bit-identical when on. Read-only consumers of the
recorder's columnar export: `metrics` (`summarize`, stage percentiles,
Little's-law checks, the `mm1_conformance` validator), `chrome`
(Perfetto-loadable traces) and `report` (deterministic offline md/html
capacity reports from stored `ExperimentResult` / ``BENCH_*.json``
files, ``python -m repro_torch.experiments report``).
"""

from .chrome import chrome_trace, write_chrome_trace
from .metrics import (
    littles_law_check,
    mm1_conformance,
    stage_percentiles,
    summarize,
)
from .profile import (
    PROFILE_SCHEMA,
    PhaseProfiler,
    active_profiler,
    merge_profiles,
)
from .recorder import (
    NULL_RECORDER,
    STAGE_FIELDS,
    TELEMETRY_SCHEMA,
    EventRecorder,
    NullRecorder,
    TraceRecorder,
    active,
)
from .report import generate_report, render_report

__all__ = [
    "PROFILE_SCHEMA",
    "PhaseProfiler",
    "active_profiler",
    "merge_profiles",
    "STAGE_FIELDS",
    "TELEMETRY_SCHEMA",
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "EventRecorder",
    "active",
    "chrome_trace",
    "write_chrome_trace",
    "summarize",
    "stage_percentiles",
    "littles_law_check",
    "mm1_conformance",
    "generate_report",
    "render_report",
]
