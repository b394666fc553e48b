"""KV-cache HBM admission control for the batched compute node (the port's
copy of `repro/batching/kv_cache.py`).

The accelerator's HBM holds the model weights permanently; what is left is
the KV-cache pool. A job's footprint is reserved in full at admission
(Orca-style all-or-nothing reservation: ``(n_input + n_output) *
kv_bytes_per_token + state_bytes``), so a running batch can never OOM
mid-decode and no mid-flight eviction/restart machinery is needed. Jobs
whose reservation does not fit stay in the waiting queue — on
memory-constrained edge accelerators (L4-class) this admission gate, not
compute, is what caps the effective batch (arXiv:2411.17712's central
measurement; arXiv:2309.16739's binding constraint for RAN-sited GPUs).
"""

from __future__ import annotations

from ..core.latency_model import HardwareSpec, ModelProfile
from ..core.scheduler import Job

__all__ = ["KVCache"]


class KVCache:
    """Reservation-based KV/state memory pool of one accelerator (slice)."""

    def __init__(self, hw: HardwareSpec, model: ModelProfile):
        self.hw = hw
        self.model = model
        self.capacity_bytes = hw.hbm_bytes - model.model_bytes
        if self.capacity_bytes <= 0:
            raise ValueError(
                f"{model.name} weights ({model.model_bytes / 1e9:.1f} GB) do "
                f"not fit in {hw.name} HBM ({hw.hbm_bytes / 1e9:.1f} GB)"
            )
        self.used_bytes = 0.0
        self.peak_bytes = 0.0
        self._reserved: dict[int, float] = {}  # id(job) -> reserved bytes

    def job_bytes(self, job: Job) -> float:
        """Full-lifetime reservation for `job` (prompt + all output tokens)."""
        return (
            (job.n_input + job.n_output) * self.model.kv_bytes_per_token
            + self.model.state_bytes
        )

    def can_admit(self, job: Job) -> bool:
        return self.used_bytes + self.job_bytes(job) <= self.capacity_bytes

    def admit(self, job: Job) -> None:
        bytes_ = self.job_bytes(job)
        if self.used_bytes + bytes_ > self.capacity_bytes:
            raise RuntimeError(f"KV admission overflow for job {job.uid}")
        self._reserved[id(job)] = bytes_
        self.used_bytes += bytes_
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def release(self, job: Job) -> None:
        self.used_bytes = max(self.used_bytes - self._reserved.pop(id(job)), 0.0)

    def jobs_capacity(self, job: Job) -> int:
        """How many jobs of `job`'s shape the empty pool could hold — the
        cache-imposed concurrency ceiling a benchmark compares to max_batch."""
        return int(self.capacity_bytes // self.job_bytes(job))

    def utilization(self) -> float:
        return self.used_bytes / self.capacity_bytes
