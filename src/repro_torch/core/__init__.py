"""repro_torch.core — the paper's contribution: the ICC framework.

Queueing analysis (§III), LLM latency model (§IV-A), 5G uplink SLS (§IV-A),
priority scheduling (§IV-B), system simulator (Fig. 5) and service-capacity
estimation (Def. 2). The port's copy of `repro/core`: plain numpy, no torch
(the card enters only through a measured service time,
`serving.calibrate.measured_service_fn`). Left out until `network` and
`experiments` are ported: `capacity.network_point` and
`capacity.network_sweep`.
"""

from .capacity import capacity_from_sweep, sweep
from .channel import ChannelConfig, UplinkChannel
from .latency_model import (
    A100,
    GH200_NVL2,
    LLAMA2_7B,
    TPU_V5E,
    HardwareSpec,
    LatencyModel,
    ModelProfile,
)
from .queueing import (
    ICCSystem,
    disjoint_satisfaction,
    exp_sum_cdf,
    joint_satisfaction,
    service_capacity,
)
from .scheduler import ComputeNode, ComputeNodeProtocol, Job
from .simulator import SCHEMES, SchemeConfig, SimConfig, SimResult, simulate

__all__ = [
    "A100",
    "GH200_NVL2",
    "LLAMA2_7B",
    "TPU_V5E",
    "ChannelConfig",
    "ComputeNode",
    "ComputeNodeProtocol",
    "HardwareSpec",
    "ICCSystem",
    "Job",
    "LatencyModel",
    "ModelProfile",
    "SCHEMES",
    "SchemeConfig",
    "SimConfig",
    "SimResult",
    "UplinkChannel",
    "capacity_from_sweep",
    "disjoint_satisfaction",
    "exp_sum_cdf",
    "joint_satisfaction",
    "service_capacity",
    "simulate",
    "sweep",
]
