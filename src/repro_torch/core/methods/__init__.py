"""Pluggable MMFL method strategies (the port of ``repro.core.methods``).

Importing this package registers the methods of the port's first slice:
``lvr``, ``random``, ``stalevr`` and ``stalevre``."""
from repro_torch.core.methods.base import (MethodStrategy, SamplerContext,
                                           available_methods, get_class,
                                           make, register)
from repro_torch.core.methods.mixins import (LossSamplingMixin,
                                             StaleStoreMixin,
                                             UniformSamplingMixin)
from repro_torch.core.methods.stale_family import StaleVRFamily

# registration side effects — one module per method
from repro_torch.core.methods import random     # noqa: F401
from repro_torch.core.methods import lvr        # noqa: F401
from repro_torch.core.methods import stalevr    # noqa: F401
from repro_torch.core.methods import stalevre   # noqa: F401

__all__ = [
    "MethodStrategy", "SamplerContext", "StaleVRFamily",
    "LossSamplingMixin", "StaleStoreMixin", "UniformSamplingMixin",
    "available_methods", "get_class", "make", "register",
]
