"""Grouped-query attention, the training and prefill path: the port of
``repro.models.attention`` (``attn_init``, ``_project_qkv``, ``attention``).

Attention always goes through ``kernels.flash_attention.ops.flash_gqa``:
on a CUDA tensor the Hopper kernel, on a CPU tensor its plain version.
There is no gate.  The flash path assumes contiguous positions 0..S-1,
which holds at every training and prefill call site.  ``decode_attention``,
the KV cache and its ``_repeat_kv`` come with serving (the kernel indexes
the grouped KV heads itself)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_gqa
from repro_torch.models import layers


def attn_init(key, cfg: ArchConfig):
    d, dh, Hq, Hk = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    k1, k2, k3, k4 = prng.split(key, 4)
    p = {
        "wq": layers.dense_init(k1, d, Hq * dh, bias=cfg.qkv_bias),
        "wk": layers.dense_init(k2, d, Hk * dh, bias=cfg.qkv_bias),
        "wv": layers.dense_init(k3, d, Hk * dh, bias=cfg.qkv_bias),
        "wo": layers.dense_init(k4, Hq * dh, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(dh, key.device)
        p["k_norm"] = layers.rmsnorm_init(dh, key.device)
    return p


def _project_qkv(p, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x [B,S,d] -> q [B,S,Hq,dh], k/v [B,S,Hk,dh] (roped, normed)."""
    B, S, _ = x.shape
    dh, Hq, Hk = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    q = layers.dense(p["wq"], x).reshape(B, S, Hq, dh)
    k = layers.dense(p["wk"], x).reshape(B, S, Hk, dh)
    v = layers.dense(p["wv"], x).reshape(B, S, Hk, dh)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p, cfg: ArchConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention, [B,S,d] ->
    [B,S,d]."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = flash_gqa(q, k, v, causal=True, window=cfg.train_window)
    return layers.dense(p["wo"], out.reshape(B, S, cfg.n_heads * cfg.dh))
