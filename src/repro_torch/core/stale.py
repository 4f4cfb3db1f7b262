"""Optimal staleness coefficients (MMFL-StaleVR, Thm 3/10), their
zero-overhead estimator (MMFL-StaleVRE, Eq. 21) and the server's stale
store — the port of ``repro.core.stale``.

The store of one task is ONE contiguous [N, P] f32 tensor for its whole
life: ``FlatLayout`` is the leaf-offset table that turns a flat [..., P]
tensor into parameter-shaped views, so the ``stale_agg_refresh`` kernel
writes into the live store and nothing concatenates it per round.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch


class FlatLayout:
    """Leaf-offset table of a parameter dict: leaf ``name`` lives at
    ``[offset, offset + numel)`` of the flat last axis, with ``shape``."""

    def __init__(self, shapes: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.names: List[str] = []
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.offsets: Dict[str, int] = {}
        off = 0
        for name, shape in shapes:
            self.names.append(name)
            self.shapes[name] = tuple(int(s) for s in shape)
            self.offsets[name] = off
            off += math.prod(shape)
        self.P = off

    @classmethod
    def of(cls, params: Dict[str, torch.Tensor]) -> "FlatLayout":
        return cls([(k, tuple(v.shape)) for k, v in params.items()])

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Parameter-shaped views ([..., *shape]) into ``flat`` [..., P]."""
        lead = tuple(flat.shape[:-1])
        return {n: flat[..., self.offsets[n]:
                        self.offsets[n] + math.prod(self.shapes[n])]
                .view(lead + self.shapes[n]) for n in self.names}

    def flatten(self, tree: Dict[str, torch.Tensor], lead: int = 0
                ) -> torch.Tensor:
        """Dict of [*lead_dims, *shape] leaves -> [*lead_dims, P]."""
        first = tree[self.names[0]]
        lead_shape = tuple(first.shape[:lead])
        return torch.cat([tree[n].reshape(lead_shape + (-1,))
                          for n in self.names], dim=-1)


def optimal_beta(G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """beta* = <G, h> / ||h||^2 per row (Thm 3, Eq. 20); 0 when h == 0.
    G, h: [C, P]."""
    num = (G.float() * h.float()).sum(dim=-1)
    den = (h.float() * h.float()).sum(dim=-1)
    return torch.where(den > 0, num / den.clamp_min(1e-30),
                       torch.zeros_like(num))


class BetaState(NamedTuple):
    """Per-client StaleVRE bookkeeping, all [N] (or [N, S]) tensors."""
    beta_hat: torch.Tensor     # beta measured right after a refresh (~1)
    beta_last: torch.Tensor    # beta measured at the last activation
    t_hat: torch.Tensor        # round of the beta_hat measurement
    t_last: torch.Tensor       # round of the beta_last measurement


def init_beta_state(n: int, device=None) -> BetaState:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    one = torch.ones((n,), dtype=torch.float32, device=device)
    return BetaState(beta_hat=one, beta_last=one.clone(), t_hat=z,
                     t_last=z.clone())


def estimate_beta(state: BetaState, tau: torch.Tensor) -> torch.Tensor:
    """Eq. (21): extrapolate beta at round ``tau`` from the last measured
    decay slope, clipped to [0, 1]."""
    dt_hist = (state.t_hat - state.t_last).clamp_min(1.0)
    slope = (state.beta_hat - state.beta_last) / dt_hist
    beta = state.beta_hat - slope * (tau - state.t_hat).clamp_min(0.0)
    return beta.clamp(0.0, 1.0)


def update_beta_state(state: BetaState, active: torch.Tensor,
                      measured_beta: torch.Tensor, tau: torch.Tensor
                      ) -> BetaState:
    """On activation the measured beta becomes ``beta_last``; the
    post-refresh similarity (~1) becomes ``beta_hat`` stamped at ``tau``."""
    act = active > 0
    tau = torch.as_tensor(tau, dtype=torch.float32,
                          device=active.device).expand_as(state.t_hat)
    return BetaState(
        beta_hat=torch.where(act, torch.ones_like(state.beta_hat),
                             state.beta_hat),
        beta_last=torch.where(act, measured_beta.clamp(0.0, 1.0),
                              state.beta_last),
        t_hat=torch.where(act, tau, state.t_hat),
        t_last=torch.where(act, state.t_hat, state.t_last))


def init_stale_store(P: int, n_clients: int, device=None) -> torch.Tensor:
    """h_{i,s}: the [N, P] store of one task (zeros = 'no update')."""
    return torch.zeros((n_clients, P), dtype=torch.float32, device=device)


def stale_mean(h: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_i weights_i h_i with weights = (d_i/B_i) beta_i: [N] x [N, P]."""
    return weights.to(h.dtype) @ h
