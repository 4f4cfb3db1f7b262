"""Plain PyTorch version of the ``flash_attention`` kernel: the CPU path
of the wrapper, the backward's function (autograd through it), and the
yardstick the kernel is held to on the card."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """The kernel's function in its layout: q [B, H, S, D]; k, v
    [B, Hk, S, D] with H % Hk == 0 (query head h reads KV head
    h // (H // Hk)) -> out [B, H, S, D] (materialized softmax).  The KV
    repeat folds the per-group gradients back onto the grouped heads
    under autograd."""
    n_rep = q.shape[1] // k.shape[1]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=1)
        v = torch.repeat_interleave(v, n_rep, dim=1)
    S = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: int = 0) -> torch.Tensor:
    """``attention_ref`` in the model layout: q [B,S,Hq,dh], k/v
    [B,S,Hk,dh] -> [B,S,Hq,dh]."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)
