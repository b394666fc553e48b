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

Sharded serving, every family: under `sharding.use_mesh(mesh, rules)` the
parameters go on the mesh once (`distribute_params`, by `param_axes`), and
`prefill`, `decode` and `init_cache` bring their inputs onto it by their
axes (tokens ("batch", "seq"), vlm embeds ("batch", "seq", "embed") and
M-RoPE streams (None, "batch", "seq"), enc-dec's encoder embeds and
decoder tokens likewise, pos ("batch",), the cache, attention and
recurrent leaves alike, by `cache_axes`), as jit's `in_shardings` do in the
reference. The three kernels run on local shards (`kernels/ops.py`); the
recurrences (Mamba2, mLSTM, sLSTM) and the moe routing run each in one
`sharding.run_local` on the local shards (their modules say how):

    with sharding.use_mesh(mesh, sharding.PREFILL_RULES):
        dparams = model.distribute_params(params)
        logits, cache = model.prefill(dparams, tokens)      # DTensors
    with sharding.use_mesh(mesh, sharding.DECODE_RULES):
        logits, cache = model.decode(dparams, cache, tok, pos)

Sharded training, every family: under `sharding.use_mesh(mesh,
TRAIN_RULES)` (FSDP over "data", tensor parallelism over "model") the
parameters go on the mesh as DTensors that require grad
(`distribute_params(params.requires_grad_(True))`), `loss` brings its batch on
by `BATCH_AXES`, and `training.make_train_step` takes the gradients, the
clip and AdamW as DTensors (moments placed like their parameters). The
loss is vocab-parallel (`cross_entropy_loss`: the (B, S, V) logits are
never gathered), the moe aux losses are the whole batch's, naive or
chunked attention runs on local shards in one `run_local`
(`attention._local_core`), and rmsnorm and its backward kernel run on
local shards, gamma's gradient a partial sum over the rows reduced to its
own placement. Each `run_local` core declares the gradient of an input it
takes replicated beside sharded ones a partial sum (`sharding.run_local`):

    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        dparams = model.distribute_params(params.requires_grad_(True))
        step = training.make_train_step(model, training.AdamWConfig())
        dparams, opt_state, metrics = step(dparams, training.adamw_init(dparams), batch)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import sharding as sh
from ..configs.base import ModelConfig
from . import encdec, transformer
from .common import RuntimeFlags, resolve_device

__all__ = ["Model", "build_model", "Params", "cross_entropy_loss", "rmsnorm_calls"]

Params = Union[transformer.Decoder, encdec.EncDec]
# the logical axes of `Model.loss`'s batch entries
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "dec_tokens": ("batch", "seq"), "embeds": ("batch", "seq", "embed"),
              "enc_embeds": ("batch", "seq", "embed")}


def cross_entropy_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int
    vocab_size: int,
) -> torch.Tensor:
    """Mean token NLL: logsumexp in f32, minus the picked logit rounded
    through bf16, as the reference's bf16 one-hot contraction computes it
    (its gradient rounds likewise). The picked logit is gathered, not
    contracted with a (B, S, V) one-hot. The padded vocab tail is never a
    label; `vocab_size` is kept for the reference's signature. Under a mesh
    the loss is vocab-parallel (`_sharded_cross_entropy`)."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels)
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked.to(torch.bfloat16).float())


def _sharded_cross_entropy(logits: DTensor, labels: DTensor) -> DTensor:
    """The loss on logits laid out ("batch", "seq", "vocab"), never
    gathered: each rank takes its vocab shard's logsumexp and the picked
    logit where the label falls in its shard (0 elsewhere, so the shards'
    sum is the picked logit); the shards' logsumexps, (B, S) each, are
    gathered and combined by one more logsumexp; each rank's rows give
    their share of the mean, which is summed. A replicated scalar. On one
    shard it is the unsharded loss bit for bit: the logsumexp of one value
    is that value, and the share is 1."""
    mesh = sh.current_mesh()
    lg_pl = sh.placements_of(logits.shape, ("batch", "seq", "vocab"))
    vocab = sh.dims_sharding(lg_pl, 2)
    rows = [p if p == Shard(0) else Replicate() for p in lg_pl]
    B = logits.shape[0]

    def shard_terms(lg, lab):
        n = lg.shape[-1]
        local = lab.long() - sh.shard_index(mesh, vocab) * n
        own = (local >= 0) & (local < n)
        picked = lg.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        return (torch.logsumexp(lg.float(), dim=-1)[..., None],
                torch.where(own, picked, torch.zeros((), dtype=lg.dtype, device=lg.device)))

    lse, picked = sh.run_local(
        shard_terms, ([Shard(2) if i in vocab else p for i, p in enumerate(rows)],
                      [Partial() if i in vocab else p for i, p in enumerate(rows)]),
        (lg_pl, rows), logits, labels)
    lse, picked = sh.redistribute(lse, rows), sh.redistribute(picked, rows)

    def mean_nll(ls, pk):
        nll = torch.mean(torch.logsumexp(ls, dim=-1) - pk.to(torch.bfloat16).float())
        return nll if ls.shape[0] == B else nll * (ls.shape[0] / B)

    loss = sh.run_local(mean_nll, [Partial() if p == Shard(0) else p for p in rows],
                        (rows, rows), lse, picked)
    return sh.redistribute(loss, [Replicate()] * len(rows))


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

    def param_axes(self, params: Params) -> dict:
        """{parameter name: its logical axes}, the reference's axes tree
        keyed by the port's names (`convert.reference_key`; the stacked
        layer axes, unsharded there, dropped): each parameter's `.axes`,
        set where `common.param` made it."""
        axes = {n: getattr(p, "axes", None) for n, p in params.named_parameters()}
        lost = [n for n, a in axes.items() if a is None]
        if lost:
            # copy.deepcopy makes new Parameters without them
            raise ValueError(f"parameters without logical axes: {lost[:3]}")
        return axes

    def cache_axes(self, batch: int = 0, cache_len: int = 0, enc_len: int = 0) -> dict:
        """The logical axes of `init_cache`'s tree, leaf for leaf the
        reference's. The sizes are the reference's signature; the tree
        depends on the config alone."""
        if self.is_encdec:
            return encdec.encdec_cache_axes(self.cfg)
        return transformer.decode_cache_axes(self.cfg)

    def distribute_params(self, params: Params) -> Params:
        """`params` on the active mesh, each leaf placed by `param_axes`
        (`sharding.distribute_params`) and requiring grad as its source
        does (`params.requires_grad_(True)` first to train them)."""
        return sh.distribute_params(params, self.param_axes(params))

    def _on_mesh(self, params: Params) -> bool:
        """Whether a mesh is active; then `params` must be on the mesh."""
        if sh.current_mesh() is None:
            return False
        if not isinstance(params.embed, DTensor):
            raise TypeError("params are not on the mesh: Model.distribute_params first")
        return True

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
        S_enc, d), "dec_tokens" (B, S), "labels" (B, S)}. Returns (loss, aux).
        Under a mesh the batch goes on it by its axes (`BATCH_AXES`), and
        the loss and aux terms are replicated DTensors."""
        if self._on_mesh(params):
            batch = {k: sh.on_mesh(v, BATCH_AXES[k]) for k, v in batch.items()}
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
            cache = encdec.init_encdec_cache(self.cfg, batch, cache_len,
                                             enc_len or cache_len, dev, dtype)
        else:
            cache = transformer.init_decode_cache(self.cfg, batch, cache_len, dev, dtype)
        if sh.current_mesh() is not None:
            cache = sh.distribute_tree(cache, self.cache_axes())
        return cache

    def prefill(
        self, params: Params, prompt: Any,
        mrope_positions: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, dict]:
        """-> (last-position logits (B, V), cache)."""
        if self._on_mesh(params):
            if self.is_encdec:
                prompt = {"enc_embeds": sh.on_mesh(prompt["enc_embeds"], ("batch", "seq", "embed")),
                          "dec_tokens": sh.on_mesh(prompt["dec_tokens"], ("batch", "seq"))}
            else:
                prompt = sh.on_mesh(prompt, ("batch", "seq", "embed")[:prompt.dim()])
            if mrope_positions is not None:
                mrope_positions = sh.on_mesh(mrope_positions, (None, "batch", "seq"))
        if self.is_encdec:
            return encdec.encdec_prefill(params, self.cfg, self.rt, prompt["enc_embeds"],
                                         prompt["dec_tokens"])
        return transformer.decoder_prefill(params, self.cfg, self.rt, prompt,
                                           mrope_positions=mrope_positions)

    def decode(
        self, params: Params, cache: dict, token: torch.Tensor, pos: torch.Tensor
    ) -> Tuple[torch.Tensor, dict]:
        """One token for every sequence in the batch -> (logits, cache)."""
        if self._on_mesh(params):
            token = sh.on_mesh(token, ("batch", "embed")[:token.dim()])
            pos = sh.on_mesh(pos, ("batch",))
            cache = sh.distribute_tree(cache, self.cache_axes())
        if self.is_encdec:
            return encdec.encdec_decode(params, self.cfg, self.rt, cache, token, pos)
        return transformer.decoder_decode(params, self.cfg, self.rt, cache, token, pos)


def build_model(cfg: ModelConfig, rt: Optional[RuntimeFlags] = None) -> Model:
    return Model(cfg, rt or RuntimeFlags())
