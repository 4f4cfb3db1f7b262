"""Unbiased MMFL aggregation (Eq. 3) and the stale variance-reduced delta
(Eq. 18), the port of ``repro.core.aggregation``.

Parameters and updates are flat: a task's params are one [P] tensor and a
cohort's updates one [A, P] tensor (``core.stale.FlatLayout`` gives the
parameter-shaped views).  The stale family's production path is the
``stale_agg_refresh`` kernel; ``stale_delta_onedot`` is its order-pinned
reference form."""
from __future__ import annotations

import torch


def unbiased_coeffs(d: torch.Tensor, B: torch.Tensor, p: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """P_{(i,b),s} = d_{i,s} / (B_i * p_{s|(i,b)}) * 1[active]  (Eq. 3).
    All args are per-processor [V] (for one model s)."""
    return torch.where(active > 0, d / (B * p.clamp_min(1e-30)),
                       torch.zeros_like(d))


def aggregate(w: torch.Tensor, updates: torch.Tensor,
              coeffs: torch.Tensor) -> torch.Tensor:
    """w^{tau+1} = w^tau - sum_c P_c G_c  (Eq. 3); w [P], updates [A, P]."""
    return w - coeffs.to(updates.dtype) @ updates


def stale_delta_onedot(coeffs: torch.Tensor, G: torch.Tensor,
                       h_cohort: torch.Tensor, beta_cohort: torch.Tensor,
                       h: torch.Tensor, stale_weights: torch.Tensor
                       ) -> torch.Tensor:
    """Eq. (18)'s Delta as ONE contraction:

      Delta = sum_n stale_weights_n h_n + sum_a coeffs_a (G_a - beta_a h_a)

    coeffs/beta_cohort [A]; G/h_cohort [A, P]; h [N, P] store;
    stale_weights [N] (d * beta, zero off-support)."""
    wts = torch.cat([stale_weights, coeffs])
    fresh = G - beta_cohort[:, None] * h_cohort
    return wts @ torch.cat([h, fresh], dim=0)


def apply_delta(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return w - delta.to(w.dtype)
