"""Shared aggregation rule of the stale variance-reduced family (Eq. 18):

    Delta = sum_i (d_i/B_i) beta_i h_i  +  sum_{active} P_i (G_i - beta_i h_i)

StaleVR (beta* of Eq. 20) and StaleVRE (beta estimated by Eq. 21) differ
only in how beta is produced — subclasses override ``_beta``.  The delta and
the store refresh (Algorithm 2: the delta reads the rows before they are
refreshed) run as ONE pass of the ``stale_agg_refresh`` kernel, on every
device: a CUDA store launches the kernel, a CPU store its plain version."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import aggregation, stale
from repro_torch.core.methods.base import MethodStrategy
from repro_torch.core.methods.mixins import StaleStoreMixin
from repro_torch.kernels.stale_agg.stale_agg import stale_agg_refresh


class StaleVRFamily(StaleStoreMixin, MethodStrategy):

    def _beta(self, state: Dict[str, Any], G: torch.Tensor,
              act: torch.Tensor, idx: torch.Tensor, round_idx: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Per-client beta [N] (before h_valid masking) + updated state."""
        raise NotImplementedError

    def aggregate(self, w, state, G, coeff, act, idx, *, d_col, lr,
                  round_idx):
        hv = state["h_valid"]
        beta_all, state = self._beta(state, G, act, idx, round_idx)
        beta_all = beta_all * hv                    # stale term only if valid
        # processors of client i share h_i: sum_b (d/B) beta h = d beta h
        stale_sum = stale.stale_mean(state["h"], d_col * beta_all)
        delta = stale_agg_refresh(coeff, beta_all[idx], act, idx, G,
                                  state["h"], stale_sum)
        hv = self.refresh_valid(hv, act, idx)
        new_w = aggregation.apply_delta(w, delta)
        return new_w, {**state, "h_valid": hv}, {"beta": beta_all}
