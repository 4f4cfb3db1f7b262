"""Uniform-random baseline: every available (processor, model) pair is
sampled with equal probability scaled to the budget m; unbiased Eq. 3
aggregation."""
from __future__ import annotations

from repro_torch.core.methods.base import MethodStrategy, register
from repro_torch.core.methods.mixins import UniformSamplingMixin


@register("random")
class RandomMethod(UniformSamplingMixin, MethodStrategy):
    pass
