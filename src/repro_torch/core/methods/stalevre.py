"""MMFL-StaleVRE (Eq. 21): the zero-overhead estimator of the optimal
staleness coefficient.  Active clients get beta measured against the stored
h (Eq. 20); inactive clients get a linear extrapolation along the observed
decay — no extra computation or communication vs LVR."""
from __future__ import annotations

import torch

from repro_torch.core import stale
from repro_torch.core.methods.base import register
from repro_torch.core.methods.mixins import LossSamplingMixin
from repro_torch.core.methods.stale_family import StaleVRFamily


@register("stalevre")
class StaleVREMethod(LossSamplingMixin, StaleVRFamily):

    def init_state(self, P, n_clients, device=None):
        state = super().init_state(P, n_clients, device)
        state["beta"] = stale.init_beta_state(n_clients, device)
        return state

    def _beta(self, state, G, act, idx, round_idx):
        hv = state["h_valid"]
        est = stale.estimate_beta(state["beta"], round_idx)          # [N]
        measured = self.measure_beta(G, state["h"][idx])             # [A]
        beta_all = est.clone()
        beta_all[idx] = torch.where(act > 0, measured, est[idx])
        active_n = torch.zeros_like(hv)
        active_n[idx] = act * hv[idx]
        measured_n = torch.zeros_like(hv)
        measured_n[idx] = measured
        new_bstate = stale.update_beta_state(state["beta"], active_n,
                                             measured_n, round_idx)
        return beta_all, {**state, "beta": new_bstate}
