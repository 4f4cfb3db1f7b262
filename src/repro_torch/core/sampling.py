"""Optimal heterogeneous client sampling (the paper's core contribution),
the port of ``repro.core.sampling``.

The closed-form water-filling of Theorems 2/8/9 for the
communication-budgeted sampling problem

    min_p  sum_{s,v} ||U_{v,s}||^2 / p_{s|v}
    s.t.   p >= 0,  sum_s p_{s|v} <= 1 (per processor),  sum_{s,v} p = m,

shared by MMFL-LVR (U = d/B * loss), plus the uniform-random baseline and
the per-processor assignment draw.  The saturated-set search is a stable
sort + cumulative sums, as in the reference.  Sums over the short model
axis are written out column by column so their order is fixed.

Shapes: V = total processors, S = models.
  U        [V, S]  utility per processor x model (0 where unavailable)
  returns  [V, S]  sampling probabilities p_{s|v}
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng

# Paper Assumption 5: lower-bounded probability, as a utility floor.
UTILITY_FLOOR = 1e-8


def index_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 2] per-index keys via ``fold_in``: key i depends only on
    (key, i), never on n (the padding-invariance contract of the engine)."""
    return prng.fold_in(key, torch.arange(n, device=key.device))


def index_uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """[n] iid U[0,1) draws, one per index key."""
    return prng.uniform(index_keys(key, n))


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (short) axis, column after column."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def processor_budget_utilities(client_util: torch.Tensor, B: Any,
                               total: Optional[int] = None) -> torch.Tensor:
    """Expand per-client utilities [N,S] to per-processor [V,S] given integer
    budgets B [N] (V = sum(B)); processors of one client share utilities."""
    B_t = torch.as_tensor(np.asarray(B), device=client_util.device).long()
    if total is None:
        total = int(np.asarray(B).sum())
    return torch.repeat_interleave(client_util, B_t, dim=0,
                                   output_size=int(total))


def _waterfill_floor(U: torch.Tensor):
    """Clamp, apply the Assumption-5 utility floor, return (U, has_any [V],
    row masses M [V])."""
    U = U.clamp_min(0.0)
    has_any = (U > 0).any(dim=1)
    U = torch.where(U > 0, U.clamp_min(UTILITY_FLOOR), torch.zeros_like(U))
    return U, has_any, _row_sum(U)


def _waterfill_levels(M: torch.Tensor, has_any: torch.Tensor, m: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which processors saturate (sum_s p = 1) and the shared scale of the
    rest (the cross-processor coupling of Thm 8/9)."""
    V = M.shape[0]
    dev, f32 = M.device, torch.float32
    m_t = torch.tensor(m, dtype=f32, device=dev)
    V_eff = has_any.sum()
    # descending masses; the saturated set is a prefix of this order
    order = torch.argsort(-M, stable=True)
    M_sorted = M[order]
    csum = torch.cumsum(M_sorted, dim=0)
    total = csum[-1]
    # remaining[j] = mass of the scaled set when the first j are saturated
    remaining = torch.cat([total[None], total - csum])[:V + 1]
    j_idx = torch.arange(V + 1, device=dev)
    m_rem = m_t - j_idx.to(f32)
    max_rem = torch.cat([M_sorted, torch.zeros(1, dtype=f32, device=dev)])
    ok = (m_rem > 0) & (m_rem * max_rem <= remaining + 1e-12)
    j_star = torch.argmax(ok.to(torch.int32))             # first True
    full = m_t >= V_eff
    rem_j = remaining[j_star]
    scale = torch.where(rem_j > 0,
                        (m_t - j_star.to(f32)) / rem_j.clamp_min(1e-30),
                        torch.zeros((), dtype=f32, device=dev))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(V, device=dev)
    saturated = (rank < j_star) | full
    return saturated, scale


def _waterfill_rows(U, M, has_any, saturated, scale) -> torch.Tensor:
    M_safe = M.clamp_min(1e-30)
    p_sat = U / M_safe[:, None]
    p_scaled = U * scale
    p = torch.where(saturated[:, None], p_sat, p_scaled)
    p = torch.where(has_any[:, None], p, torch.zeros_like(p))
    return p.clamp(0.0, 1.0)


def solve_waterfilling(U: torch.Tensor, m: float) -> torch.Tensor:
    """Closed-form solution of the budgeted sampling problem (Thm 8/9).
    U [V, S] nonnegative utilities; m the expected tasks per round.
    Returns p [V, S] with sum(p) == min(m, V_eff) and row sums <= 1."""
    U, has_any, M = _waterfill_floor(U)
    saturated, scale = _waterfill_levels(M, has_any, m)
    return _waterfill_rows(U, M, has_any, saturated, scale)


def solve_waterfilling_capped(U: torch.Tensor, m: float,
                              eta: torch.Tensor) -> torch.Tensor:
    """Water-filling with per-processor participation caps
    sum_s p_{s|v} <= eta_v (footnote 3).  Saturated processors get
    p = eta_v * U / M_v; the order is by cap-normalized mass M_v / eta_v.
    eta == 1 reduces exactly to ``solve_waterfilling``."""
    dev, f32 = U.device, torch.float32
    m_t = torch.tensor(m, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    U = torch.where(U > 0, U.clamp_min(UTILITY_FLOOR), torch.zeros_like(U))
    eta = eta.to(f32).clamp(1e-9, 1.0)
    has_any = (U > 0).any(dim=1)
    M = _row_sum(U)
    V = U.shape[0]
    r = torch.where(has_any, M / eta, zero)
    order = torch.argsort(-r, stable=True)
    M_sorted = M[order]
    eta_sorted = torch.where(has_any, eta, zero)[order]
    r_sorted = r[order]
    csum_M = torch.cumsum(M_sorted, dim=0)
    csum_eta = torch.cumsum(eta_sorted, dim=0)
    total_M = csum_M[-1]
    remaining_M = torch.cat([total_M[None], total_M - csum_M])[:V + 1]
    spent_eta = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                           csum_eta])[:V + 1]
    m_rem = m_t - spent_eta
    next_r = torch.cat([r_sorted, torch.zeros(1, dtype=f32, device=dev)])
    ok = (m_rem > 0) & (m_rem * next_r <= remaining_M + 1e-12)
    j_star = torch.argmax(ok.to(torch.int32))
    eta_total = torch.where(has_any, eta, zero).sum()
    full = m_t >= eta_total
    rem_j = remaining_M[j_star]
    scale = torch.where(rem_j > 0, m_rem[j_star] / rem_j.clamp_min(1e-30),
                        zero)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(V, device=dev)
    saturated = (rank < j_star) | full
    M_safe = M.clamp_min(1e-30)
    p_sat = eta[:, None] * U / M_safe[:, None]
    p_scaled = U * scale
    p = torch.where(saturated[:, None], p_sat, p_scaled)
    p = torch.where(has_any[:, None], p, torch.zeros_like(p))
    return p.clamp(0.0, 1.0)


def lvr_probabilities(losses: torch.Tensor, d: torch.Tensor, B: Any,
                      avail: torch.Tensor, m: float,
                      eta: Optional[torch.Tensor] = None,
                      total: Optional[int] = None) -> torch.Tensor:
    """MMFL-LVR (Thm 2/9).  losses [N,S] current local losses; d [N,S]
    dataset fractions; B [N] processor budgets; avail [N,S] bool; ``eta``
    [N] optional per-client caps.  Returns p [V,S]."""
    B_f = torch.as_tensor(np.asarray(B, np.float32), device=losses.device)
    util = losses.abs() * d / B_f.clamp_min(1.0)[:, None]
    util = torch.where(avail, util, torch.zeros_like(util))
    U = processor_budget_utilities(util, B, total)
    if eta is not None:
        eta_v = processor_budget_utilities(eta[:, None], B, total)[:, 0]
        return solve_waterfilling_capped(U, m, eta_v)
    return solve_waterfilling(U, m)


def random_probabilities(d: torch.Tensor, B: Any, avail: torch.Tensor,
                         m: float, total: Optional[int] = None
                         ) -> torch.Tensor:
    """Uniform-random baseline: every available (processor, model) pair gets
    equal probability, scaled to meet the budget m."""
    util = avail.to(torch.float32)
    U = processor_budget_utilities(util, B, total)
    n_pairs = (U > 0).sum().clamp_min(1)
    p = U * (torch.tensor(m, dtype=torch.float32, device=U.device)
             / n_pairs.to(torch.float32))
    row = _row_sum(p)[:, None]
    p = torch.where(row > 1.0, p / row, p)
    return p.clamp(0.0, 1.0)


def sample_assignment(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Participation draw: each processor independently picks at most one
    model, model s with probability p_{s|v}.  Per-processor inverse-CDF
    over ``index_uniform``, so processor v's draw depends only on (key, v).
    Returns active [V,S] in {0,1} with at most one 1 per row."""
    V, S = p.shape
    stay_idle = 1.0 - _row_sum(p)
    probs = torch.cat([p, stay_idle[:, None]], dim=1).clamp(0.0, 1.0)
    probs = probs / _row_sum(probs).clamp_min(1e-30)[:, None]
    cdf = torch.empty_like(probs)
    cdf[:, 0] = probs[:, 0]
    for j in range(1, S + 1):
        cdf[:, j] = cdf[:, j - 1] + probs[:, j]
    u = index_uniform(key, V)
    # first s with cdf > u; past the last column (u >= cdf[S] by rounding)
    # the processor stays idle, as with JAX's out-of-range one_hot
    choice = (u[:, None] >= cdf).sum(dim=1).clamp_max(S)
    return torch.nn.functional.one_hot(choice, S + 1)[:, :S].to(
        torch.float32)
