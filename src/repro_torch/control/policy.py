"""Controller presets and the shared runtime control state (the port's
copy of `repro/control/policy.py`).

`ControlState` is the single mutable object the control loop writes and
the data path reads: the engines' admission gates consult `admit`/`quota`
per generated job, and the `controlled` routing policy adds `node_bias`
to its completion estimates. Keeping it in one place means a controller
preset is just a law mapping observations to this state — simulators and
policies never need to know which preset is running.
"""

from __future__ import annotations

import math
from typing import Dict, List, Union

from .controllers import (
    Controller,
    ReactiveController,
    SlackAwareJointController,
    StaticController,
)

__all__ = [
    "CONTROLLERS",
    "ControlState",
    "ControllerLike",
    "get_controller",
    "list_controllers",
    "validate_controller",
]

CONTROLLERS = {
    c.name: c
    for c in (StaticController, ReactiveController, SlackAwareJointController)
}

# The one controller-argument type every surface accepts: a preset name or
# a Controller instance. `simulate(controller=)` takes this alias (names are
# validated eagerly via `validate_controller`, not deep inside a run).
ControllerLike = Union[str, "Controller"]


def validate_controller(controller) -> None:
    """Raise on an unknown preset name or a non-controller object; None
    and Controller instances pass. Cheap: safe to call at config/spec
    construction so typos fail before any simulation starts."""
    if controller is None or isinstance(controller, Controller):
        return
    if isinstance(controller, str):
        if controller not in CONTROLLERS:
            raise KeyError(
                f"unknown controller {controller!r}; "
                f"known: {sorted(CONTROLLERS)}"
            )
        return
    raise TypeError(
        f"controller must be a preset name or Controller instance, "
        f"got {type(controller).__name__}"
    )


def get_controller(controller: Union[str, Controller]) -> Controller:
    """Resolve a preset name to a *fresh* controller instance (controllers
    hold hysteresis state, so sweeps must not share one across runs)."""
    if isinstance(controller, Controller):
        return controller
    try:
        return CONTROLLERS[controller]()
    except KeyError:
        raise KeyError(
            f"unknown controller {controller!r}; known: {sorted(CONTROLLERS)}"
        ) from None


def list_controllers() -> List[str]:
    return sorted(CONTROLLERS)


class ControlState:
    """Mutable state shared by the control loop and the data path."""

    def __init__(self, n_cells: int):
        self.n_cells = n_cells
        self.admit: List[bool] = [True] * n_cells  # reactive open/closed
        self.quota: List[float] = [math.inf] * n_cells  # epoch tokens
        self.node_bias: Dict[str, float] = {}
        self.n_epochs = 0
        # per-epoch counters (reset by control_epoch after each observation)
        self.generated: List[int] = [0] * n_cells
        self.admitted: List[int] = [0] * n_cells
        # run totals
        self.total_generated = 0
        self.total_rejected = 0

    def gate(self, job, now: float) -> bool:
        """Admission decision for one generated job (SlotEngine gate hook).
        Counts every arrival; spends one quota token per admission."""
        c = job.cell
        self.generated[c] += 1
        self.total_generated += 1
        if not self.admit[c] or self.quota[c] < 1.0:
            self.total_rejected += 1
            return False
        self.quota[c] -= 1.0
        self.admitted[c] += 1
        return True
