"""Hand-written Hopper kernels of the port, one folder per TPU kernel of
``repro.kernels``.

Each folder holds the kernel, its wrapper and ``ref.py``, the plain
PyTorch version of the same function.  A wrapper dispatches on the device
of the tensors it is given: a CUDA tensor launches the kernel (or raises),
a CPU tensor takes the plain version.  There is no other switch.

``launch_counts`` counts kernel launches per wrapper; it is bumped only
where a wrapper launches its kernel, so a run can show that the main path
went through the kernels (``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Dict

launch_counts: Dict[str, int] = {"batched_dot": 0, "stale_agg_refresh": 0,
                                 "flash_attention": 0, "selective_scan": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
