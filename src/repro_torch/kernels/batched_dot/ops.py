"""beta* over a cohort through the ``batched_dot`` kernel (the port of
``repro.kernels.batched_dot.ops.optimal_beta_pallas``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.batched_dot.batched_dot import batched_dot


def optimal_beta(G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """beta* = <G_c, h_c> / ||h_c||^2 per cohort row (Eq. 20), 0 where
    h_c == 0.  G, h: [C, P] flattened cohort updates and store rows."""
    dots, norms = batched_dot(G, h)
    return torch.where(norms > 0, dots / norms.clamp_min(1e-30),
                       torch.zeros_like(dots))
