"""Plain PyTorch version of the ``batched_dot`` kernel."""
from __future__ import annotations

import torch


def batched_dot_ref(G: torch.Tensor, h: torch.Tensor):
    """G, h: [C, P] -> (dots [C], norms [C]) in float32."""
    G, h = G.float(), h.float()
    return (G * h).sum(dim=-1), (h * h).sum(dim=-1)
