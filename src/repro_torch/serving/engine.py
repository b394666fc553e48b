"""Continuous-batching inference engine (counterpart of
`repro/serving/engine.py`).

A fixed pool of `max_batch` decode slots over one batched cache; requests
are prefilled individually (batch 1) and spliced into a free slot, decode
advances all slots in lock-step (one `Model.decode` per tick). A prompt is
tokens (S,) or, for vlm archs, frontend embeddings (S, d) in the params'
dtype, or for enc-dec archs a dict {"enc_embeds": (S_enc, d), "dec_tokens":
(S_dec,)} (the engine then needs `enc_len` >= S_enc); generated tokens are
always embedded from the table. A moe model routes inside
`Model.prefill/decode` (the prefill as one group of S tokens, each decode
row as its own group).

Splicing is generic across cache families (attention KV, Mamba2 and xLSTM
states, enc-dec cross KV): every leaf is written into its slot along its
batch axis (`transformer.CACHE_BATCH_AXIS`, the reference's "kv_batch"), and
a leaf shorter than the buffer along a sequence axis is filled up to it,
positions with -1 (empty), everything else with 0. Idle rows are stepped in
lock-step with the others, as in the reference; the next splice into a slot
overwrites whatever its row holds.

Timing: CUDA calls return before the card finishes, so the engine
synchronises the device before every clock read; `prefill_s` and
`decode_s` are device time plus host overhead, never enqueue time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..models.common import resolve_device
from ..models.model import Model, Params
from ..models.transformer import CACHE_BATCH_AXIS

__all__ = ["GenRequest", "GenResult", "InferenceEngine", "SamplingParams", "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = full distribution
    seed: int = 0


@dataclasses.dataclass
class GenRequest:
    uid: int
    prompt: Any  # (S,) int tokens, (S, d) frontend embeds (tensor, array or list), or a
    #              dict {"enc_embeds": (S_enc, d), "dec_tokens": (S_dec,)} for enc-dec
    max_new_tokens: int
    eos_token: Optional[int] = None
    sampling: SamplingParams = SamplingParams()


@dataclasses.dataclass
class GenResult:
    uid: int
    tokens: List[int]
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


def _generator_seed(seed: int, uid: int, position: int) -> int:
    """A 63-bit seed from (seed, uid, position); negative uids are fine."""
    h = 0
    for v in (seed, uid, position):
        h = (h * 0x100000001B3 + (v % (1 << 64))) % (1 << 63)
    return h


def sample_token(logits: torch.Tensor, sp: SamplingParams, uid: int, position: int) -> int:
    """One token from (V,) logits. Deterministic in (seed, uid, position),
    so batched == sequential results hold. The draws are the port's own
    (a CPU `torch.Generator`), not JAX's threefry bits."""
    if sp.temperature <= 0.0:
        return int(torch.argmax(logits))
    gen = torch.Generator().manual_seed(_generator_seed(sp.seed, uid, position))
    scaled = logits.float().cpu() / sp.temperature
    if sp.top_k > 0:
        vals, idx = torch.topk(scaled, sp.top_k)
        choice = torch.multinomial(torch.softmax(vals, -1), 1, generator=gen)
        return int(idx[choice])
    return int(torch.multinomial(torch.softmax(scaled, -1), 1, generator=gen))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class InferenceEngine:
    def __init__(
        self,
        model: Model,
        params: Params,
        max_batch: int = 8,
        max_seq: int = 256,
        enc_len: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(
                f"params on {params.embed.device}, engine device {self.device}"
            )
        self.model = model
        self.params = params
        self.M = max_batch
        self.Sc = max_seq
        self._enc_len = enc_len
        self._dtype = params.embed.dtype
        self.reset()

    # ------------------------------------------------------------- slots
    def reset(self) -> None:
        """Clear all slots and results; every cache slot becomes empty."""
        self.active = [False] * self.M
        self.pos = [0] * self.M
        self.last_tok = [0] * self.M
        self.results: Dict[int, GenResult] = {}
        self._slot_req: List[Optional[GenRequest]] = [None] * self.M
        self._remaining = [0] * self.M
        self._cache = self.model.init_cache(self.M, self.Sc, self.device, self._dtype,
                                            enc_len=self._enc_len)

    def warmup(self, sample_prompt: Any) -> None:
        """Run one short request so the first timed request pays no
        one-time costs (kernel build, library load, allocator growth)."""
        self.generate([GenRequest(uid=-987654, prompt=sample_prompt, max_new_tokens=2)])
        self.reset()

    def free_slots(self) -> List[int]:
        return [i for i, a in enumerate(self.active) if not a]

    def active_uids(self) -> List[int]:
        """uids of the requests currently occupying decode slots."""
        return [r.uid for r in self._slot_req if r is not None]

    @property
    def n_active(self) -> int:
        return sum(self.active)

    def _splice(self, cache1: dict, slot: int) -> None:
        """Insert a batch-1 prefill cache into slot `slot`, leaf by leaf."""

        def ins(full: torch.Tensor, one: torch.Tensor, bax: int) -> None:
            dst, one = full.select(bax, slot), one.squeeze(bax)
            if dst.shape != one.shape:  # a sequence axis shorter than the buffer
                if any(h > w for h, w in zip(one.shape, dst.shape)):
                    raise ValueError(f"cache leaf {tuple(one.shape)} exceeds {tuple(full.shape)}")
                dst.fill_(-1 if one.dtype == torch.int32 else 0)
                dst = dst[tuple(slice(0, n) for n in one.shape)]
            dst.copy_(one)

        for key, leaf in cache1.items():
            bax = CACHE_BATCH_AXIS[key]
            if isinstance(leaf, dict):
                for name, one in leaf.items():
                    ins(self._cache[key][name], one, bax)
            else:
                ins(self._cache[key], leaf, bax)

    # ----------------------------------------------------------- serving
    def submit(self, req: GenRequest) -> int:
        """Prefill + occupy a slot. Returns the slot index."""
        slots = self.free_slots()
        if not slots:
            raise RuntimeError("no free slot")
        slot = slots[0]
        if isinstance(req.prompt, dict):  # enc-dec: encoder frames + decoder prompt
            enc = torch.as_tensor(req.prompt["enc_embeds"]).to(self.device, self._dtype)
            dec = torch.as_tensor(req.prompt["dec_tokens"]).to(self.device, torch.long)
            if enc.shape[0] > self._enc_len:
                raise ValueError(f"request {req.uid}: {enc.shape[0]} encoder frames exceed "
                                 f"enc_len={self._enc_len}")
            prompt = {"enc_embeds": enc[None], "dec_tokens": dec[None]}
            plen = dec.shape[0]
        else:
            prompt = torch.as_tensor(req.prompt)  # (S,) tokens or (S, d) embeds
            dtype = self._dtype if prompt.dim() == 2 else torch.long
            prompt = prompt.to(self.device, dtype)[None]
            plen = prompt.shape[1]
        # Decode writes position p into slot p % Sc; p < Sc keeps every
        # written slot empty beforehand (see models/attention.py).
        if plen + req.max_new_tokens - 1 > self.Sc:
            raise ValueError(
                f"request {req.uid}: {plen} + {req.max_new_tokens} tokens exceed "
                f"max_seq={self.Sc}"
            )
        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache1 = self.model.prefill(self.params, prompt)
        tok = sample_token(logits[0], req.sampling, req.uid, 0)
        self._splice(cache1, slot)
        _sync(self.device)
        self.active[slot] = True
        self.pos[slot] = plen
        self.last_tok[slot] = tok
        self._slot_req[slot] = req
        self._remaining[slot] = req.max_new_tokens - 1
        self.results[req.uid] = GenResult(
            req.uid, [tok], prefill_s=time.perf_counter() - t0
        )
        if self._remaining[slot] <= 0 or tok == req.eos_token:
            self._finish(slot)
        return slot

    def _finish(self, slot: int) -> None:
        # Park the idle row at position 0: the lock-step decode still runs
        # it, and a stale position (up to max_seq after a request that
        # filled the cache) would wrap a cache smaller than the window.
        # Position 0 writes only the row's own slot 0, which the next
        # `_splice` into this slot overwrites.
        self.active[slot] = False
        self.pos[slot] = 0
        self._slot_req[slot] = None
        self._remaining[slot] = 0

    def step(self) -> int:
        """One lock-step decode tick for all active slots. Returns #active."""
        if self.n_active == 0:
            return 0
        _sync(self.device)
        t0 = time.perf_counter()
        tok = torch.tensor(self.last_tok, dtype=torch.long, device=self.device)
        pos = torch.tensor(self.pos, dtype=torch.int32, device=self.device)
        logits, self._cache = self.model.decode(self.params, self._cache, tok, pos)
        nxt = torch.argmax(logits, dim=-1).tolist()
        # per-slot stochastic sampling where requested (greedy is batched)
        for slot in range(self.M):
            req = self._slot_req[slot]
            if req is not None and req.sampling.temperature > 0.0:
                nxt[slot] = sample_token(
                    logits[slot], req.sampling, req.uid,
                    len(self.results[req.uid].tokens),
                )
        _sync(self.device)
        dt = time.perf_counter() - t0
        for slot in range(self.M):
            if not self.active[slot]:
                continue
            self.pos[slot] += 1
            self.last_tok[slot] = nxt[slot]
            req = self._slot_req[slot]
            res = self.results[req.uid]
            res.tokens.append(nxt[slot])
            res.decode_s += dt
            self._remaining[slot] -= 1
            if self._remaining[slot] <= 0 or nxt[slot] == req.eos_token:
                self._finish(slot)
        return self.n_active

    def generate(self, reqs: List[GenRequest]) -> Dict[int, GenResult]:
        """Convenience: run a request list to completion (batched greedily)."""
        pending = list(reqs)
        while pending or self.n_active:
            while pending and self.free_slots():
                self.submit(pending.pop(0))
            if self.n_active:
                self.step()
        return {r.uid: self.results[r.uid] for r in reqs}
