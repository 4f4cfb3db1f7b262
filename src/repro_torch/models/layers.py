"""Core functional layers of the real-model tasks, the port of
``repro.models.layers``.

Every module is a pair of plain functions on a dict of tensors:
``<mod>_init(key, ...) -> params`` and ``<mod>(params, x) -> y``.  Layouts
are the reference's: dense weights are [in, out] and apply as ``x @ w``.
Init draws go through ``repro_torch.prng`` (the reference's threefry
stream), on the key's device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import prng


def _uniform(key: torch.Tensor, shape, scale: float) -> torch.Tensor:
    return prng.uniform(key, shape, -scale, scale)


def dense_init(key, d_in: int, d_out: int, bias: bool = False):
    scale = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(key, (d_in, d_out), scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=key.device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)             # [dh/2]
    angles = positions[..., None].float() * freqs             # [..., S, dh/2]
    angles = angles[..., None, :]                             # [..., S, 1, dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(key, d: int, f: int):
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": dense_init(k1, d, f)["w"],
        "w_up": dense_init(k2, d, f)["w"],
        "w_down": dense_init(k3, f, d)["w"],
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"])
    u = x @ p["w_up"]
    return (g * u) @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / loss
# ---------------------------------------------------------------------------


def embed_init(key, vocab: int, d: int):
    return {"w": prng.normal(key, (vocab, d)) * 0.02}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), p["w"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy.  logits [..., V], labels int [...]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
