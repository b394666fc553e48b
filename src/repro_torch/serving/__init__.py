"""Serving: continuous-batching engine + ICC priority scheduling."""

from .calibrate import MeasuredService, measure_service_time, measured_service_fn
from .engine import GenRequest, GenResult, InferenceEngine, SamplingParams
from .icc import ICCRequest, ICCServer, ServeStats

__all__ = [
    "GenRequest",
    "GenResult",
    "ICCRequest",
    "ICCServer",
    "InferenceEngine",
    "MeasuredService",
    "SamplingParams",
    "ServeStats",
    "measure_service_time",
    "measured_service_fn",
]
