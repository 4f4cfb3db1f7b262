"""Empirical monitors for the convergence-bound terms of Theorem 1/4, the
port of ``repro.core.convergence``:

  * ``H1``  ||H_{tau,s}||_1 = sum_active P  (expected 1)
  * ``Zp``  (||H||_1 - 1)^2 — the term behind E[Z_p]
  * ``Zl``  ( sum_active P f_i  -  sum_i d_i f_i )^2 — the term behind
            E[Z_l], which MMFL-LVR minimizes
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ordered_sums(x: torch.Tensor) -> torch.Tensor:
    """Index-ordered sequential sums along axis 0 of a [V, ...] stack:
    every column accumulates its terms in index order in f32, as the
    reference's ``lax.scan`` chain does.  The monitor columns are small, so
    they are reduced on the host (``numpy.add.accumulate`` is strictly
    sequential), all columns in one pass."""
    host = x.detach().to("cpu", torch.float32).numpy()
    out = (np.add.accumulate(host, axis=0, dtype=np.float32)[-1] if len(host)
           else np.zeros(host.shape[1:], np.float32))
    return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Index-ordered sequential sum of a 1-D array (see ``ordered_sums``)."""
    return ordered_sums(x)


def round_metrics(coeffs: torch.Tensor, losses_v: torch.Tensor,
                  d_v: torch.Tensor, B_v: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """H1, Zp, Zl from per-processor [V] columns — or [V, S] ones, one
    column per model, all in one ordered pass.  B_v >= 1 on real
    processors; the maximum only guards rows with B 0."""
    sums = ordered_sums(torch.stack(
        [coeffs, coeffs * losses_v, d_v / B_v.clamp_min(1.0) * losses_v],
        dim=1))
    return {"H1": sums[0], "Zp": (sums[0] - 1.0) ** 2,
            "Zl": (sums[1] - sums[2]) ** 2}
