"""repro_torch.control — arrival processes for the slot simulator.

The port's `control` holds only `arrivals.py` (stationary Poisson,
piecewise, diurnal, flash-crowd and MMPP rates), which `core.simulator`
imports. Mobility, the controllers and their presets are not ported yet.
"""

from .arrivals import (
    MMPP,
    ArrivalProcess,
    BoundArrivals,
    DiurnalRate,
    FlashCrowd,
    PiecewiseRate,
    PoissonProcess,
    bind_arrivals,
)

__all__ = [
    "MMPP",
    "ArrivalProcess",
    "BoundArrivals",
    "DiurnalRate",
    "FlashCrowd",
    "PiecewiseRate",
    "PoissonProcess",
    "bind_arrivals",
]
