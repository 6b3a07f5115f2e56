"""Config system: model/arch configs and run settings.

Counterpart of :mod:`repro.config` (a copy).  Every assigned architecture
is a :class:`ModelConfig` built in ``repro_torch.configs.<id>``; the
dry run's shapes (``repro.configs.shapes``) have no counterpart yet.
Configs are frozen dataclasses -- hashable and serializable for
checkpoint metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    kind: Literal["gqa", "mla"] = "gqa"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0        # partial rotary (stablelm: 0.25)
    window: int | None = None         # sliding-window attention
    # MLA (deepseek-v2) fields:
    kv_lora: int = 0                  # compressed KV latent width
    q_lora: int = 0                   # 0 = direct q projection (V2-Lite)
    rope_head_dim: int = 64           # decoupled RoPE key width
    v_head_dim: int = 0               # 0 = head_dim

    @property
    def vdim(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def q_groups(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0               # shared (always-on) experts
    capacity_factor: float = 1.25
    group_size: int = 512             # dispatch group (tokens)
    aux_loss_coef: float = 0.01
    router_scale: bool = True         # normalize top-k weights to sum 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    act: Literal["silu", "gelu", "relu2"] = "silu"
    glu: bool = True
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False
    # MoE models: leading layers that stay dense, and their ffn width.
    n_dense_layers: int = 0
    dense_d_ff: int = 0
    # Hybrid (hymba): every layer runs attention and SSM heads in parallel;
    # `global_attn_layers` use full attention, others use `attn.window`.
    global_attn_every: int = 0
    # Encoder-decoder (whisper): n_layers is the decoder depth.
    n_enc_layers: int = 0
    dec_len_train: int = 512          # decoder length for train shapes
    # VLM (paligemma): number of stub patch-embedding prefix tokens.
    vlm_prefix: int = 0
    # Positional scheme.
    pos: Literal["rope", "sinusoidal"] = "rope"
    param_dtype: str = "bfloat16"

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def quadratic_attention(self) -> bool:
        """True if decode-time cost/memory grows linearly with context for
        every layer (full attention) — disqualifies long_500k."""
        if self.family in ("ssm",):
            return False
        if self.family == "hybrid":
            return False  # SWA + SSM; few global layers bounded by design
        return True

    def active_params_per_layer(self) -> int:
        """Approximate active parameter count of one layer (for 6ND)."""
        d = self.d_model
        n = 0
        if self.attn is not None:
            a = self.attn
            if a.kind == "mla":
                qdim = a.num_heads * (a.head_dim + a.rope_head_dim)
                n += d * qdim                                  # W_q
                n += d * (a.kv_lora + a.rope_head_dim)         # W_dkv, W_kr
                n += a.kv_lora * a.num_heads * (a.head_dim + a.vdim)
                n += a.num_heads * a.vdim * d                  # W_o
            else:
                n += d * a.num_heads * a.head_dim              # W_q
                n += 2 * d * a.num_kv_heads * a.head_dim       # W_k, W_v
                n += a.num_heads * a.vdim * d                  # W_o
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            nheads = d_in // s.head_dim
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
            n += conv_dim * s.d_conv
            n += d_in * d
        if self.moe is not None:
            m = self.moe
            mult = 3 if self.glu else 2
            n += (m.top_k + m.num_shared) * mult * d * m.d_expert
            n += d * m.num_experts                              # router
        else:
            mult = 3 if self.glu else 2
            n += mult * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — 6*N*D model FLOPs uses this."""
        n = self.n_layers * self.active_params_per_layer()
        if self.n_dense_layers and self.moe is not None:
            mult = 3 if self.glu else 2
            moe_ffn = (self.moe.top_k + self.moe.num_shared) * mult * \
                self.d_model * self.moe.d_expert
            dense_ffn = mult * self.d_model * (self.dense_d_ff or self.d_ff)
            n += self.n_dense_layers * (dense_ffn - moe_ffn)
        if self.is_encdec:
            # encoder layers + decoder cross-attn (roughly one extra attn)
            n += self.n_enc_layers * self.active_params_per_layer()
            if self.attn:
                a = self.attn
                n += self.n_layers * (2 * self.d_model * a.num_heads * a.head_dim
                                      + 2 * self.d_model * a.num_kv_heads * a.head_dim)
        n += self.d_model * self.vocab * (1 if self.tie_embeddings else 2)
        return n
