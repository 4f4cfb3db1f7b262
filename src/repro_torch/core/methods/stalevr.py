"""MMFL-StaleVR (Thm 3/10): loss-based sampling with the optimal staleness
coefficient beta* = <G, h>/||h||^2 (Eq. 20).  Measuring beta* exactly needs
every client's fresh update each round (paper Sec. 5) — the overhead
StaleVRE removes."""
from __future__ import annotations

from repro_torch.core.methods.base import register
from repro_torch.core.methods.mixins import LossSamplingMixin
from repro_torch.core.methods.stale_family import StaleVRFamily


@register("stalevr")
class StaleVRMethod(LossSamplingMixin, StaleVRFamily):
    needs_all_updates = True

    def _beta(self, state, G, act, idx, round_idx):
        # G covers all N clients here (idx == arange(N)), so the cohort's
        # store rows are the whole store: no gather
        return self.measure_beta(G, state["h"]), state
