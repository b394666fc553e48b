"""Synthetic LM data pipeline (a copy of `repro/training/data.py`; numpy only).

No external datasets ship with the container, so the pipeline generates a
*learnable* synthetic stream (not uniform noise): tokens follow a fixed
random successor permutation (an order-1 deterministic Markov chain) with
a small corruption rate. The achievable loss floor is

    H* = -(1-eps) ln(1-eps) + eps ln(V)        (eps = noise rate)

far below the uniform ln(V); a model that trains visibly approaches it —
examples/train_small_torch.py shows exactly that. The pipeline is an infinite,
seeded, batched iterator with deterministic resume (step -> batch is a
pure function, checkpoint-friendly).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "batch_for_step"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    noise: float = 0.05  # corruption rate (uniform resample)

    @property
    def loss_floor(self) -> float:
        eps, V = self.noise, self.vocab_size
        return -(1 - eps) * math.log(1 - eps) + eps * math.log(V)


class SyntheticLM:
    """Deterministic synthetic corpus: step -> batch is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.permutation(cfg.vocab_size)  # fixed successor table

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=(B,))
        noise = rng.random((B, S)) < cfg.noise
        rand = rng.integers(0, V, size=(B, S))
        for t in range(1, S + 1):
            det = self._succ[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t - 1], rand[:, t - 1], det)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    return SyntheticLM(cfg).batch(step)
