"""Plain PyTorch version of the ``stale_agg_refresh`` kernel.

The CPU path of the wrapper and the yardstick the kernel is held to on the
card.  It walks the cohort in the kernel's order and selects padding slots
out exactly as the kernel does."""
from __future__ import annotations

import torch


def stale_agg_refresh_ref(coeff: torch.Tensor, beta: torch.Tensor,
                          act: torch.Tensor, idx: torch.Tensor,
                          G: torch.Tensor, h: torch.Tensor,
                          stale_sum: torch.Tensor) -> torch.Tensor:
    """coeff, beta, act: [C]; idx: [C] distinct rows of the store; G: [C, P];
    h: [N, P] store, refreshed IN PLACE (h[idx[c]] <- G[c] where act[c] > 0);
    stale_sum: [P].  Returns delta [P] f32, read from the pre-refresh rows.

    A slot with coeff == 0 and act == 0 adds nothing, even where its G row
    is not finite."""
    coeff, beta, act = coeff.float(), beta.float(), act.float()
    rows = idx.tolist()
    delta = stale_sum.float().clone()
    live = (coeff != 0) | (act != 0)
    # row by row, as the kernel: no [C, P] gather of the store
    for c, i in enumerate(rows):
        contrib = coeff[c] * (G[c] - beta[c] * h[i])        # pre-refresh
        delta += torch.where(live[c], contrib, torch.zeros_like(contrib))
    for c, i in enumerate(rows):
        if act[c] > 0:
            h[i] = G[c]
    return delta
