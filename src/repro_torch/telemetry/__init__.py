"""repro_torch.telemetry — the simulator's trace recorder and phase profiler.

Pass an `EventRecorder` as ``recorder=`` or a `PhaseProfiler` as
``profiler=`` to `repro_torch.core.simulate`. Both are free when off and
leave fixed-seed results bit-identical when on. The derived metrics,
reports and Chrome traces of the reference's telemetry are not ported yet
(`EventRecorder.to_metrics` raises until `telemetry/metrics.py` is).
"""

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
]
