"""Model/architecture configuration system (the port's own copy of
`repro.configs.base`).

One frozen dataclass covers all six families (dense / moe / ssm / hybrid /
vlm / audio); family-specific fields default to "off". Each architecture
registers a full-size config plus a smoke variant of the same family
(<=2 layers, d_model<=512, <=4 experts) for CPU tests. The port registers
every architecture of the JAX package, with the same FULL and SMOKE values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "smoke_variant"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # --- attention ---------------------------------------------------------
    rope_theta: float = 1e6
    qkv_bias: bool = False
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) dims
    window: int = 0  # sliding-window size, 0 = full attention
    nope_interval: int = 0  # llama4 iRoPE: every Nth layer skips RoPE
    # --- mlp ----------------------------------------------------------------
    activation: str = "silu"  # silu | gelu | relu2
    # --- moe ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- ssm (mamba2) -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # --- xlstm ---------------------------------------------------------------
    slstm_every: int = 0  # every Nth block is sLSTM (others mLSTM)
    # --- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0  # one shared attention block per N ssm layers
    # --- enc-dec (seamless) ----------------------------------------------------
    n_encoder_layers: int = 0
    # --- embedding frontend stub (vlm/audio) -----------------------------------
    embeds_input: bool = False  # input_specs feeds (B, S, d_model) embeddings
    # --- misc -------------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 512  # pad vocab so the TP axis always divides

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_decoder_only(self) -> bool:
        return self.n_encoder_layers == 0

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks), for the
        latency model (C_LLM = 2 * params) and MODEL_FLOPS accounting."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dh, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.embeds_input:
            emb = self.padded_vocab * d  # output head only (frontend stubbed)
        attn = d * H * dh + 2 * d * K * dh + H * dh * d
        mlp = 3 * d * f if self.activation == "silu" else 2 * d * f
        if self.n_experts:
            mlp_total = self.n_experts * mlp + d * self.n_experts
        else:
            mlp_total = mlp
        per_layer = attn + mlp_total + 2 * d
        if self.family == "ssm":  # xlstm: recurrent mixers, no std attention
            di = self.d_inner
            per_layer = 2 * d * di + di * d + 3 * di * self.ssm_head_dim + 2 * d
        if self.family == "hybrid":
            di = self.d_inner
            nh = self.n_ssm_heads
            mamba = (
                d * (2 * di + 2 * self.ssm_state * nh // max(nh, 1) + nh)
                + di * d + 2 * d
            )
            per_layer = mamba
        total = emb + L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            total += attn + mlp + 2 * d  # one shared block
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (per_layer + attn)  # + cross-attn
        return float(total)

    def active_param_count(self) -> float:
        """Parameters touched per token (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f if self.activation == "silu" else 2 * d * f
        dense = self.param_count() - self.n_layers * self.n_experts * mlp
        return dense + self.n_layers * self.top_k * mlp


_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_configs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def smoke_variant(name: str) -> ModelConfig:
    return get_config(name, smoke=True)


def _ensure_loaded() -> None:
    # Import the per-arch modules for their registration side effects.
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        glm4_9b,
        llama2_7b,
        llama4_scout_17b_a16e,
        mistral_large_123b,
        mixtral_8x22b,
        nemotron_4_15b,
        qwen1_5_110b,
        qwen2_vl_72b,
        seamless_m4t_large_v2,
        xlstm_1_3b,
        zamba2_7b,
    )
