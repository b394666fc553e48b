"""Roofline LLM-inference latency model (paper §IV-A, Eq. 7-8) — generalized.

The paper models the compute latency of one inference job J on one GPU as

    T_prefill  = max( N_input * C_LLM / G_comp,  M_LLM / G_mem )       (Eq. 7)
    T_tokengen = N_output * max( C_LLM / G_comp, M_LLM / G_mem )       (Eq. 8)
    C_LLM      = 2 * n_params   (FLOPs / token)

We keep that exact model (``fidelity="paper"``) for the faithful
reproduction of Figs. 6-7, and extend it (``fidelity="extended"``) with the
terms the paper omits but that dominate at the scales of our assigned
architectures:

  * KV-cache read traffic during decode (grows with context length; it is
    THE memory term for long_500k decode),
  * active-vs-total parameters for MoE (compute uses active, weight loading
    uses total),
  * batched service (weights are loaded once per step, not once per job),
  * a collective term for sharded serving on a TPU mesh (ICI all-reduce
    bytes per layer for tensor parallelism) — the TPU-native analogue of the
    paper's "scale GPU count" knob in Fig. 7.

All latencies are seconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

__all__ = [
    "HardwareSpec",
    "ModelProfile",
    "LatencyModel",
    "ModelService",
    "TPU_V5E",
    "A100",
    "H100",
    "L4",
    "GH200_NVL2",
    "LLAMA2_7B",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One accelerator (or an aggregated slice of them)."""

    name: str
    flops: float  # peak FLOP/s for the serving dtype
    hbm_bw: float  # bytes/s
    hbm_bytes: float  # capacity, bytes
    ici_bw: float = 0.0  # per-link interconnect bytes/s (0 = single device)

    def scaled(self, n: int) -> "HardwareSpec":
        """Aggregate n devices (the paper's Fig. 7 'GPU capacity' axis)."""
        return dataclasses.replace(
            self,
            name=f"{n}x{self.name}",
            flops=self.flops * n,
            hbm_bw=self.hbm_bw * n,
            hbm_bytes=self.hbm_bytes * n,
        )


# Hardware presets. v5e numbers are the assignment constants; GPU numbers are
# the datasheet values the paper cites ([17], [18]).
TPU_V5E = HardwareSpec("tpu-v5e", flops=197e12, hbm_bw=819e9, hbm_bytes=16e9, ici_bw=50e9)
A100 = HardwareSpec("a100", flops=312e12, hbm_bw=2039e9, hbm_bytes=80e9)
# GH200-NVL2: two Grace-Hopper superchips (2 x ~989 TF fp16, 2 x 4.9 TB/s HBM3e).
GH200_NVL2 = HardwareSpec("gh200-nvl2", flops=2 * 989e12, hbm_bw=2 * 4.9e12, hbm_bytes=2 * 144e9)
# Heterogeneous-fleet tiers for multi-cell RAN sites (repro_torch.network): H100 SXM
# fp16 dense, and L4 as the power-constrained far-edge cell-site accelerator.
H100 = HardwareSpec("h100", flops=989e12, hbm_bw=3352e9, hbm_bytes=80e9)
L4 = HardwareSpec("l4", flops=121e12, hbm_bw=300e9, hbm_bytes=24e9)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """What the latency model needs to know about one architecture."""

    name: str
    n_params: float  # total parameters
    n_active_params: float  # parameters touched per token (== n_params unless MoE)
    bytes_per_param: float  # serving dtype width
    kv_bytes_per_token: float  # per-token KV cache footprint (0 for SSM decode)
    state_bytes: float = 0.0  # recurrent state footprint (SSM/hybrid)
    n_layers: int = 0
    d_model: int = 0

    @property
    def model_bytes(self) -> float:
        return self.n_params * self.bytes_per_param

    @property
    def flops_per_token(self) -> float:
        # Paper: C_LLM = 2 * params (active params for MoE).
        return 2.0 * self.n_active_params


LLAMA2_7B = ModelProfile(
    name="llama2-7b",
    n_params=7e9,
    n_active_params=7e9,
    bytes_per_param=2.0,  # FP16, Table I
    kv_bytes_per_token=2 * 32 * 32 * 128 * 2.0,  # 2(k,v) * L * H * d_h * fp16
    n_layers=32,
    d_model=4096,
)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Predict prefill/decode latency for jobs on a hardware target.

    fidelity="paper"    -> exactly Eq. 7/8 (used for the faithful repro).
    fidelity="extended" -> adds KV-cache reads, batching, collective term.
    """

    hw: HardwareSpec
    model: ModelProfile
    fidelity: Literal["paper", "extended"] = "paper"
    tp_degree: int = 1  # tensor-parallel width (extended mode collective term)

    # ----------------------------------------------------------- paper mode
    def _paper_prefill(self, n_input: int) -> float:
        c = n_input * self.model.flops_per_token
        return max(c / self.hw.flops, self.model.model_bytes / self.hw.hbm_bw)

    def _paper_decode(self, n_output: int) -> float:
        per_tok = max(
            self.model.flops_per_token / self.hw.flops,
            self.model.model_bytes / self.hw.hbm_bw,
        )
        return n_output * per_tok

    # -------------------------------------------------------- extended mode
    def _collective_per_token(self) -> float:
        """Tensor-parallel all-reduce bytes/token over ICI (ring, 2 rounds/layer).

        2 all-reduces per transformer layer (attn out, mlp out), each moving
        2*(tp-1)/tp * d_model * bytes per token through each link.
        """
        if self.tp_degree <= 1 or self.hw.ici_bw <= 0:
            return 0.0
        bytes_per_layer = (
            2 * 2 * (self.tp_degree - 1) / self.tp_degree
            * self.model.d_model * self.model.bytes_per_param
        )
        return self.model.n_layers * bytes_per_layer / self.hw.ici_bw

    def _ext_prefill(self, n_input: int, batch: int) -> float:
        c = batch * n_input * self.model.flops_per_token
        mem = self.model.model_bytes + batch * n_input * self.model.kv_bytes_per_token
        coll = batch * n_input * self._collective_per_token()
        return max(c / self.hw.flops, mem / self.hw.hbm_bw) + coll

    def _ext_decode(self, n_output: int, context: int, batch: int) -> float:
        """Closed form of the per-token decode sum.

        Step i (0-based) costs  max(t_c, (m0 + slope*i)/bw) + coll  with a
        constant compute term t_c and a KV-read memory term linear in i, so
        the roofline crossover context solves analytically: steps before
        i* = ceil((t_c*bw - m0)/slope) are compute-bound (t_c each), steps
        from i* on are memory-bound (arithmetic series). O(1) instead of an
        O(n_output) Python loop — long_500k decodes are half a million steps.
        """
        if n_output <= 0:
            return 0.0
        t_c = batch * self.model.flops_per_token / self.hw.flops
        m0 = self.model.model_bytes + batch * (
            context * self.model.kv_bytes_per_token + self.model.state_bytes
        )
        slope = batch * self.model.kv_bytes_per_token
        bw = self.hw.hbm_bw
        coll = n_output * batch * self._collective_per_token()
        if slope <= 0.0:  # no KV growth (e.g. SSM): every step costs the same
            return n_output * max(t_c, m0 / bw) + coll
        i_star = min(n_output, max(0, math.ceil((t_c * bw - m0) / slope)))
        n_mem = n_output - i_star  # steps i_star .. n_output-1 are memory-bound
        idx_sum = (i_star + n_output - 1) * n_mem / 2.0
        return i_star * t_c + (n_mem * m0 + slope * idx_sum) / bw + coll

    # -------------------------------------------------------------- public
    def prefill_latency(self, n_input: int, batch: int = 1) -> float:
        if self.fidelity == "paper":
            return self._paper_prefill(n_input) * (batch if batch > 1 else 1)
        return self._ext_prefill(n_input, batch)

    def decode_latency(self, n_output: int, context: int = 0, batch: int = 1) -> float:
        if self.fidelity == "paper":
            return self._paper_decode(n_output) * (batch if batch > 1 else 1)
        return self._ext_decode(n_output, context, batch)

    def job_latency(self, n_input: int, n_output: int, batch: int = 1) -> float:
        """Total T_comp for one job (paper: T_prefill + T_tokengen)."""
        return self.prefill_latency(n_input, batch) + self.decode_latency(
            n_output, context=n_input, batch=batch
        )

    def iteration_latency(
        self, prefill_tokens: int, decode_batch: int, context_tokens: float
    ) -> float:
        """One continuous-batching engine iteration (Orca/vLLM-style).

        `decode_batch` resident sequences each generate one token while
        `prefill_tokens` prompt tokens are (chunk-)prefilled in the same
        forward pass; `context_tokens` is the KV already resident for the
        work in this pass (sum of the decode sequences' contexts plus the
        already-prefilled prefix of the chunking job). Weights are read
        once per iteration — that sharing is the continuous-batching win.

        Degenerate cases recover the whole-job model: a full-prompt prefill
        iteration equals `prefill_latency(n, batch=1)` and a decode-only
        iteration at batch 1 equals one step of `decode_latency`, in both
        fidelities — `BatchedComputeNode(max_batch=1)` relies on this.
        """
        new_tokens = prefill_tokens + decode_batch
        if new_tokens <= 0:
            return 0.0
        c = new_tokens * self.model.flops_per_token
        if self.fidelity == "paper":
            return max(c / self.hw.flops, self.model.model_bytes / self.hw.hbm_bw)
        mem = (
            self.model.model_bytes
            + (context_tokens + prefill_tokens) * self.model.kv_bytes_per_token
            + decode_batch * self.model.state_bytes
        )
        return (
            max(c / self.hw.flops, mem / self.hw.hbm_bw)
            + new_tokens * self._collective_per_token()
        )

    def service_rate(self, n_input: int, n_output: int) -> float:
        """Jobs/second the node can sustain (mu2 in the queueing model)."""
        return 1.0 / self.job_latency(n_input, n_output)


@dataclasses.dataclass(frozen=True)
class ModelService:
    """Picklable job-level service-time callable.

    Equivalent to ``lambda job: LatencyModel(hw, model).job_latency(...)``
    but usable from `ProcessPoolExecutor`-backed sweeps (`workers=`), where
    lambdas cannot cross the process boundary.
    """

    hw: HardwareSpec
    model: ModelProfile
    fidelity: str = "paper"

    def __call__(self, job) -> float:
        return LatencyModel(self.hw, self.model, fidelity=self.fidelity).job_latency(
            job.n_input, job.n_output
        )
