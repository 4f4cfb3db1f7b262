"""MMFL-LVR (the paper's Thm 2/9): loss-based water-filling sampling —
clients upload one scalar loss, only the sampled cohort trains — with
unbiased Eq. 3 aggregation."""
from __future__ import annotations

from repro_torch.core.methods.base import MethodStrategy, register
from repro_torch.core.methods.mixins import LossSamplingMixin


@register("lvr")
class LVRMethod(LossSamplingMixin, MethodStrategy):
    pass
