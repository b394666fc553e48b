"""Deterministic fault injection and recovery (the port's copy of
`repro/faults`).

`spec` declares serializable fault scenarios (node crashes, link
outages/degradation, brownouts plus recovery-policy knobs); `schedule`
binds a spec to a seeded, slot-snapped timeline that the simulator
queries. Faults are strictly opt-in — without a FaultSpec every
fixed-seed result is bit-identical to the fault-free simulator. Link
faults need the multi-cell simulator (`repro_torch.network`):
`core.simulate` refuses them, as the reference's does.
"""
from .spec import (Brownout, FaultSpec, LinkOutage, NodeCrashProcess,
                   NodeOutage)
from .schedule import (FaultSchedule, NODE_FAIL, NODE_RECOVER, bind_faults)

__all__ = [
    "Brownout",
    "FaultSpec",
    "LinkOutage",
    "NodeCrashProcess",
    "NodeOutage",
    "FaultSchedule",
    "NODE_FAIL",
    "NODE_RECOVER",
    "bind_faults",
]
