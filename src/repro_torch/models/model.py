"""Public model API (counterpart of `repro/models/model.py`).

    model = build_model(get_config("glm4-9b"))
    params = model.init(seed=0)                          # on the card
    logits, aux = model.forward(params, tokens)         # aux: moe router losses
    logits, cache = model.prefill(params, prompt)        # serving
    logits, cache = model.decode(params, cache, tok, pos)

Inputs are tokens (B, S) int, or frontend embeds (B, S, d) for vlm archs
(with optional M-RoPE streams `mrope_positions` (3, B, S)). `params` is a
`transformer.Decoder` module; every call runs on the device its parameters
live on. Forward only: the loss and training are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer
from .common import RuntimeFlags, resolve_device

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rt: RuntimeFlags

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device="cuda", dtype=None) -> transformer.Decoder:
        """Random weights drawn on `device` from a generator seeded `seed`."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_decoder_params(self.cfg, gen, dev, dtype)

    # -------------------------------------------------------------- forward
    def forward(
        self, params: transformer.Decoder, batch: torch.Tensor,
        mrope_positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """-> (logits (B, S, V), aux): for moe archs the router losses
        `moe_lb_loss` and `moe_z_loss` summed over layers, else {}."""
        return transformer.decoder_forward(params, self.cfg, self.rt, batch,
                                           mrope_positions=mrope_positions)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int, device="cuda", dtype=None) -> dict:
        return transformer.init_decode_cache(
            self.cfg, batch, cache_len, resolve_device(device), dtype
        )

    def prefill(
        self, params: transformer.Decoder, prompt: torch.Tensor,
        mrope_positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """-> (last-position logits (B, V), cache)."""
        return transformer.decoder_prefill(params, self.cfg, self.rt, prompt,
                                           mrope_positions=mrope_positions)

    def decode(
        self, params: transformer.Decoder, cache: dict, token: torch.Tensor, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, dict]:
        """One token for every sequence in the batch -> (logits, cache)."""
        return transformer.decoder_decode(params, self.cfg, self.rt, cache, token, pos)


def build_model(cfg: ModelConfig, rt: Optional[RuntimeFlags] = None) -> Model:
    return Model(cfg, rt or RuntimeFlags())
