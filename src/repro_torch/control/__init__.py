"""repro_torch.control — joint bandwidth-compute control (the port's copy of
`repro/control`).

  arrivals.py     non-stationary arrival processes (piecewise / diurnal /
                  MMPP / flash crowd) behind an abstraction whose
                  stationary case is the plain Poisson engine
  mobility.py     UE roaming between cells with Xn-handover re-homing of
                  in-flight uplink state (moved by the multi-cell
                  simulator, `repro_torch.network`)
  controllers.py  the online control loop: epoch observations -> actions
                  on bandwidth partition, admission, and routing retargets
  policy.py       controller presets (static / reactive /
                  slack_aware_joint) + the shared ControlState
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
from .controllers import (
    Actions,
    CellObs,
    Controller,
    NodeObs,
    Observation,
    ReactiveController,
    SlackAwareJointController,
    StaticController,
    control_epoch,
)
from .mobility import HandoverEvent, MobilityConfig, MobilityModel
from .policy import (
    CONTROLLERS,
    ControlState,
    ControllerLike,
    get_controller,
    list_controllers,
    validate_controller,
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
    "Actions",
    "CellObs",
    "Controller",
    "NodeObs",
    "Observation",
    "ReactiveController",
    "SlackAwareJointController",
    "StaticController",
    "control_epoch",
    "HandoverEvent",
    "MobilityConfig",
    "MobilityModel",
    "CONTROLLERS",
    "ControlState",
    "ControllerLike",
    "get_controller",
    "list_controllers",
    "validate_controller",
]
