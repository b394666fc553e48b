"""repro_torch.batching — token-level continuous-batching compute subsystem
(the port's copy of `repro/batching`; beyond-paper).

The paper's compute node serves jobs one at a time (Eq. 7/8 whole-job
latency). Real edge LLM serving is iteration-level continuous batching with
KV-cache memory pressure — the regime measured by "Generative AI on the
Edge" (arXiv:2411.17712) and identified as the binding constraint for
RAN-sited accelerators by "Pushing Large Language Models to the 6G Edge"
(arXiv:2309.16739). This package models that loop at token granularity:

  kv_cache.py  reservation-based HBM admission control (weights + KV pool)
  node.py      BatchedComputeNode: iteration-stepped batched server with
               chunked prefill, deadline preemption, TTFT/TBT recording

Both node types satisfy `repro_torch.core.scheduler.ComputeNodeProtocol`, so the
single-cell `simulate()` and the multi-cell fleet accept either.
"""

from .kv_cache import KVCache
from .node import BatchedComputeNode, BatchStats

__all__ = ["KVCache", "BatchedComputeNode", "BatchStats"]
