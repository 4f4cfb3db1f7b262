"""Shared strategy mixins: the loss-/uniform-probability helpers and the
server-side stale store (h_{i,s}), the port of
``repro.core.methods.mixins``."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import sampling, stale
from repro_torch.kernels.batched_dot import ops as batched_dot_ops


class LossSamplingMixin:
    """Water-filling over loss utilities (MMFL-LVR, Thm 2/9).
    ``cfg.eta_cap`` (scalar or [N]) switches to the footnote-3 capped
    water-filling; None keeps ``solve_waterfilling``."""

    def _eta(self, ctx):
        eta = getattr(self.cfg, "eta_cap", None) if self.cfg else None
        if eta is None:
            return None
        eta = torch.as_tensor(eta, dtype=torch.float32,
                              device=ctx.d.device)
        if eta.dim() == 0:
            eta = eta.expand(len(ctx.B)).clone()
        return eta

    def probabilities(self, ctx, losses_ns):
        return sampling.lvr_probabilities(losses_ns, ctx.d, ctx.B, ctx.avail,
                                          ctx.m, eta=self._eta(ctx),
                                          total=ctx.V)


class UniformSamplingMixin:
    """Uniform-random sampling (the baselines that sample blindly)."""

    def probabilities(self, ctx, losses_ns):
        return sampling.random_probabilities(ctx.d, ctx.B, ctx.avail, ctx.m,
                                             total=ctx.V)


class StaleStoreMixin:
    """Per-(client, model) stale update store h (Sec. 5) and the Eq. 20 beta
    measurement.  The store is ONE contiguous [N, P] tensor per task; the
    ``stale_agg_refresh`` kernel refreshes its active rows in place."""

    uses_stale_store = True

    def init_state(self, P: int, n_clients: int,
                   device: Any = None) -> Dict[str, Any]:
        return {"h": stale.init_stale_store(P, n_clients, device),
                "h_valid": torch.zeros((n_clients,), dtype=torch.float32,
                                       device=device)}

    @staticmethod
    def refresh_valid(h_valid: torch.Tensor, act: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
        """h_valid[i] <- max(h_valid[i], act) for the cohort's clients."""
        hv = h_valid.clone()
        hv[idx] = torch.maximum(h_valid[idx], act)
        return hv

    @staticmethod
    def measure_beta(G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """beta* = <G, h> / ||h||^2 per cohort row (Eq. 20), through the
        ``batched_dot`` kernel.  G, h: [C, P]."""
        return batched_dot_ops.optimal_beta(G, h)
