"""Public model API (counterpart of `repro/models/model.py`): one `Model`
facade over every family.

    model = build_model(get_config("glm4-9b"))
    params = model.init(seed=0)                          # on the card
    logits, aux = model.forward(params, tokens)         # aux: moe router losses
    loss, aux = model.loss(params, batch)                # train
    logits, cache = model.prefill(params, prompt)        # serving
    logits, cache = model.decode(params, cache, tok, pos)

Inputs are tokens (B, S) int, or frontend embeds (B, S, d) for vlm archs
(with optional M-RoPE streams `mrope_positions` (3, B, S)); enc-dec archs
take dict(enc_embeds=(B, S_enc, d), dec_tokens=(B, S_dec)). `params` is a
`transformer.Decoder` module, or an `encdec.EncDec` for enc-dec archs;
every call runs on the device its parameters live on. `loss` is
differentiable for every family (`training/` trains them); prefill and
decode record no graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from . import encdec, transformer
from .common import RuntimeFlags, resolve_device

__all__ = ["Model", "build_model", "Params", "cross_entropy_loss", "rmsnorm_calls"]

Params = Union[transformer.Decoder, encdec.EncDec]


def cross_entropy_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int
    vocab_size: int,
) -> torch.Tensor:
    """Mean token NLL: logsumexp in f32, minus the picked logit rounded
    through bf16, as the reference's bf16 one-hot contraction computes it
    (its gradient rounds likewise). The picked logit is gathered, not
    contracted with a (B, S, V) one-hot. The padded vocab tail is never a
    label; `vocab_size` is kept for the reference's signature."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked.to(torch.bfloat16).float())


def rmsnorm_calls(cfg: ModelConfig) -> Tuple[int, int]:
    """(rmsnorm calls of one forward, those a remat backward runs again).
    A forward runs 2 a block (an mLSTM, sLSTM or Mamba2 block: its own and
    its inner norm) and the final norm; zamba2 adds the shared block's 2 at
    each of its ng applications; enc-dec runs 2 an encoder layer, 3 a
    decoder layer and 2 final norms. Remat recomputes every block, each
    zamba2 group (not the remainder layers) and every encoder and decoder
    layer. So a train step calls the forward kernel n + again times under
    remat (n without) and the backward kernel n times."""
    L = cfg.n_layers
    if cfg.n_encoder_layers:
        n = 2 * cfg.n_encoder_layers + 3 * L + 2
        return n, n - 2
    if cfg.family == "hybrid":
        ng, gs, _ = transformer.group_shape(cfg)
        return 2 * L + 2 * ng + 1, 2 * ng * gs + 2 * ng
    return 2 * L + 1, 2 * L


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rt: RuntimeFlags

    @property
    def is_encdec(self) -> bool:
        return self.cfg.n_encoder_layers > 0

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device="cuda", dtype=None) -> Params:
        """Random weights drawn on `device` from a generator seeded `seed`.
        On the meta device (shapes and dtypes only, for `launch.dryrun`)
        nothing is drawn."""
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        if self.is_encdec:
            return encdec.init_encdec_params(self.cfg, gen, dev, dtype)
        return transformer.init_decoder_params(self.cfg, gen, dev, dtype)

    # -------------------------------------------------------------- forward
    def forward(
        self, params: Params, batch: Any,
        mrope_positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """-> (logits (B, S, V), aux): for moe archs the router losses
        `moe_lb_loss` and `moe_z_loss` summed over layers, else {}."""
        if self.is_encdec:
            return encdec.encdec_forward(params, self.cfg, self.rt, batch["enc_embeds"],
                                         batch["dec_tokens"])
        return transformer.decoder_forward(params, self.cfg, self.rt, batch,
                                           mrope_positions=mrope_positions)

    def loss(self, params: Params, batch: dict) -> Tuple[torch.Tensor, dict]:
        """Next-token LM loss (+ the moe aux terms, weighted 0.01 and 0.001),
        as the reference's `Model.loss`. batch: {"tokens" (B, S) or "embeds"
        (B, S, d), "labels" (B, S)}; enc-dec archs take {"enc_embeds" (B,
        S_enc, d), "dec_tokens" (B, S), "labels" (B, S)}. Returns (loss, aux)."""
        if self.is_encdec:
            logits, aux = encdec.encdec_forward(params, self.cfg, self.rt, batch["enc_embeds"],
                                                batch["dec_tokens"])
        else:
            inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
            logits, aux = transformer.decoder_forward(params, self.cfg, self.rt, inputs)
        loss = cross_entropy_loss(logits, batch["labels"], self.cfg.padded_vocab)
        if aux:
            loss = loss + 0.01 * aux.get("moe_lb_loss", 0.0) \
                        + 0.001 * aux.get("moe_z_loss", 0.0)
        return loss, aux

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int, device="cuda", dtype=None,
                   enc_len: int = 0) -> dict:
        """Zeroed decode cache; enc-dec archs add a cross cache of `enc_len`
        frames (`cache_len` when 0, as the reference)."""
        dev = resolve_device(device)
        if self.is_encdec:
            return encdec.init_encdec_cache(self.cfg, batch, cache_len,
                                            enc_len or cache_len, dev, dtype)
        return transformer.init_decode_cache(self.cfg, batch, cache_len, dev, dtype)

    def prefill(
        self, params: Params, prompt: Any,
        mrope_positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """-> (last-position logits (B, V), cache)."""
        if self.is_encdec:
            return encdec.encdec_prefill(params, self.cfg, self.rt, prompt["enc_embeds"],
                                         prompt["dec_tokens"])
        return transformer.decoder_prefill(params, self.cfg, self.rt, prompt,
                                           mrope_positions=mrope_positions)

    def decode(
        self, params: Params, cache: dict, token: torch.Tensor, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, dict]:
        """One token for every sequence in the batch -> (logits, cache)."""
        if self.is_encdec:
            return encdec.encdec_decode(params, self.cfg, self.rt, cache, token, pos)
        return transformer.decoder_decode(params, self.cfg, self.rt, cache, token, pos)


def build_model(cfg: ModelConfig, rt: Optional[RuntimeFlags] = None) -> Model:
    return Model(cfg, rt or RuntimeFlags())
