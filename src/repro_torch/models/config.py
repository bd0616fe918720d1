"""Model configuration schema for the architecture zoo.

The port's own copy of ``repro/models/config.py`` (no JAX in it; the port
imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                   # 0 for attention-free
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # Attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True         # False = encoder-only (hubert)
    sliding_window: int = 0     # 0 = full attention
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_shard: str = "expert"   # "expert" (E on model axis) | "tensor" (d_ff)
    moe_impl: str = "shard_map"  # "shard_map" (explicit a2a) | "gspmd" (§Perf A/C)
    router_z_coef: float = 1e-3
    router_lb_coef: float = 1e-2

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0          # N; 0 = no SSM
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # Hybrid (Hymba): both attention and SSM branches per layer
    parallel_ssm: bool = False

    # VLM: cross-attention injection every k-th layer
    cross_attn_every: int = 0
    vision_seq: int = 0         # stub frontend tokens per image

    # Audio stub frontend
    frontend_dim: int = 0       # 0 = token embedding; else linear proj stub

    # Numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"         # full | dots | none
    # Attention chunking for long sequences (flash-style scans)
    attn_q_chunk: int = 4096
    attn_k_chunk: int = 1024
    attn_chunk_threshold: int = 8192

    # Sharding hints (see models/sharding.py)
    shard_attn_heads: bool = True   # False when n_heads % tp != 0
    shard_ssm_heads: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def q_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def n_cross_layers(self) -> int:
        if not self.cross_attn_every:
            return 0
        return self.n_layers // self.cross_attn_every

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += d * v                              # lm head
        per_layer = 2 * d                           # norms
        if self.has_attention:
            per_layer += d * dh * (hq + 2 * hkv) + hq * dh * d
            if self.qkv_bias:
                per_layer += dh * (hq + 2 * hkv)
            if self.qk_norm:
                per_layer += 2 * dh
        if self.has_ssm:
            di, nst, hs = self.ssm_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * di) + 2 * d * nst + d * hs   # in_proj(x,z), B, C, dt
            per_layer += self.ssm_conv * (di + 2 * nst)        # convs
            per_layer += 3 * hs + di                           # A_log, D, dt_bias, norm
            per_layer += di * d                                # out_proj
        if self.is_moe:
            per_layer += d * self.n_experts                    # router
            per_layer += self.n_experts * (3 * d * f // 1)     # wi, wg, wo per expert
        elif f:
            per_layer += 3 * d * f                             # swiglu wi, wg, wo
        n += self.n_layers * per_layer
        # Cross-attention layers (vlm)
        if self.n_cross_layers:
            n += self.n_cross_layers * (
                d * dh * (hq + 2 * hkv) + hq * dh * d + 2 * d
            )
        if self.frontend_dim:
            n += self.frontend_dim * d
        return n

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top-k of E experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = self.n_layers * (self.n_experts - self.experts_per_token) * 3 * d * f
        return self.param_count() - inactive
