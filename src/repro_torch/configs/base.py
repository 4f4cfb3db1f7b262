"""Architecture configuration of the real-model task worlds, the port of
``repro.configs.base.ArchConfig``.

Every architecture gets one ``configs/<id>.py`` that instantiates
:class:`ArchConfig` with the exact published numbers (citation in the
module docstring).  ``reduced()`` derives the small variant of the same
family (2 layers, d_model <= 256, small vocab).  The round configuration
(``FLRoundConfig``) and the input shapes join with the distributed trainer.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture description (one per assigned architecture)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- optional features -------------------------------------------------
    head_dim: int = 0                 # derived if 0
    n_experts: int = 0                # MoE
    top_k: int = 1                    # MoE routing
    capacity_factor: float = 1.25     # MoE dispatch capacity
    ssm_state: int = 0                # Mamba state dim N
    ssm_conv: int = 4                 # Mamba depthwise conv width
    ssm_expand: int = 2               # Mamba d_inner = expand * d_model
    qk_norm: bool = False             # per-head RMSNorm on q/k (qwen3)
    qkv_bias: bool = False            # QKV projection bias (qwen1.5)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # serve-time sliding window (ring-buffer KV cache); does NOT affect
    # training attention
    sliding_window: int = 0
    # train-time attention window (0 = full causal)
    train_window: int = 0
    # stub-frontend dims (vlm / audio): number of prepended frontend tokens
    n_frontend_tokens: int = 0
    frontend_dim: int = 0             # embedding dim delivered by the stub
    norm_eps: float = 1e-5
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (matches ``models.transformer.init``)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        dh, Hq, Hk = self.dh, self.n_heads, self.n_kv_heads
        total = V * d  # embed
        if not self.tie_embeddings:
            total += d * V  # lm_head
        total += d  # final norm
        per_layer = 0
        if self.family == "ssm":
            per_layer += d  # norm
            per_layer += self._mamba_params()
        else:
            # attention (+ optional parallel mamba for hybrid)
            per_layer += d  # ln1
            per_layer += d * Hq * dh + 2 * d * Hk * dh + Hq * dh * d
            if self.qkv_bias:
                per_layer += Hq * dh + 2 * Hk * dh
            if self.qk_norm:
                per_layer += 2 * dh
            if self.family == "hybrid":
                per_layer += self._mamba_params() + 2 * d  # fused norms
            # mlp / moe
            per_layer += d  # ln2
            if self.family == "moe":
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * (3 * d * f)
            elif f > 0:
                per_layer += 3 * d * f
        total += L * per_layer
        if self.n_frontend_tokens:
            total += self.frontend_dim * d  # projector stub
        return total

    def _mamba_params(self) -> int:
        d, di, N, k = self.d_model, self.d_inner, self.ssm_state, self.ssm_conv
        dt_rank = max(1, math.ceil(d / 16))
        n = d * 2 * di            # in_proj (x and z)
        n += di * k               # depthwise conv
        n += di * (dt_rank + 2 * N)  # x_proj -> (dt, B, C)
        n += dt_rank * di + di    # dt_proj (+bias)
        n += di * N + di          # A_log, D
        n += di * d               # out_proj
        return n

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small variant of the same family: 2 layers, d_model<=256,
        <=4 experts, small vocab."""
        d = min(self.d_model, 256)
        dh = 32
        n_heads = max(2, min(4, self.n_heads)) if self.n_heads else 0
        n_kv = max(1, min(2, self.n_kv_heads)) if self.n_kv_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            head_dim=dh if n_heads else 0,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 4) if self.n_frontend_tokens else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
        )
