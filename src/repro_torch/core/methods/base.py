"""Method strategy protocol + registry, the port of
``repro.core.methods.base``.

Every method the engine can run is a ``MethodStrategy`` subclass registered
under a string name with ``@register("name")``.  The engine is
method-agnostic: it asks the strategy for sampling probabilities, draws
participation, runs the cohort's local training, and hands the updates back
to ``strategy.aggregate``.

  class-level flags
    needs_all_updates   every client trains every round (G over all N is
                        produced in the stats phase)
    uses_stale_store    keeps per-client h stores

  sampling side
    probabilities(ctx, losses_ns)           -> p [V,S]
    sample(key, p)                          -> active [V,S] in {0,1}
    coefficients(d_v, B_v, p_v, act_v)      -> aggregation coeffs [V]

  training side (one task; params and updates flat, see core.stale)
    init_state(P, n_clients, device)        -> per-task state dict
    aggregate(w, state, G, coeff, act, idx, *, d_col, lr, round_idx)
        -> (new_w, new_state, extras)
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import aggregation, sampling


@dataclasses.dataclass
class SamplerContext:
    """The world statistics the sampling side needs."""
    d: torch.Tensor        # [N,S] dataset fractions among available clients
    B: np.ndarray          # [N]   processor budgets (host)
    avail: torch.Tensor    # [N,S] availability mask
    m: float               # expected training tasks per round (budget)
    V: Optional[int] = None           # total processor rows


class MethodStrategy:
    """Base strategy: uniform sampling + unbiased aggregation (Eq. 3)."""

    name: ClassVar[str] = "?"
    needs_all_updates: ClassVar[bool] = False
    uses_stale_store: ClassVar[bool] = False

    def __init__(self, cfg: Any = None):
        self.cfg = cfg

    # -- sampling side -----------------------------------------------------
    def probabilities(self, ctx: SamplerContext,
                      losses_ns: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Default: each processor independently picks <= 1 model."""
        return sampling.sample_assignment(key, p)

    def coefficients(self, d_v: torch.Tensor, B_v: torch.Tensor,
                     p_v: torch.Tensor, act_v: torch.Tensor) -> torch.Tensor:
        """Default: the unbiased d/(B p) coefficients of Eq. 3."""
        return aggregation.unbiased_coeffs(d_v, B_v, p_v, act_v)

    def cohort_size(self, n_clients: int, m: float, n_models: int) -> int:
        """Fixed training-cohort capacity per task (expected actives per
        task m/S, with a 2.5x margin)."""
        return int(min(n_clients,
                       max(8, np.ceil(2.5 * m / n_models) + 4)))

    # -- training side -----------------------------------------------------
    def init_state(self, P: int, n_clients: int,
                   device: Any = None) -> Dict[str, Any]:
        return {}

    def aggregate(self, w: torch.Tensor, state: Dict[str, Any],
                  G: torch.Tensor, coeff: torch.Tensor, act: torch.Tensor,
                  idx: torch.Tensor, *, d_col: torch.Tensor,
                  lr: torch.Tensor, round_idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, Any],
                             Dict[str, torch.Tensor]]:
        """One task's aggregation rule.  w [P] flat params; G [A, P] the
        cohort's updates; coeff/act/idx [A] (all-client methods have
        A == N, idx == arange(N)).  Default: Eq. 3."""
        return aggregation.aggregate(w, G, coeff), state, {}


_REGISTRY: Dict[str, Type[MethodStrategy]] = {}


def register(name: str):
    """Class decorator: ``@register("lvr")`` makes the strategy discoverable
    by ``make(name)`` / ``available_methods()``."""
    def deco(cls: Type[MethodStrategy]) -> Type[MethodStrategy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_class(name: str) -> Type[MethodStrategy]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown MMFL method {name!r}; available: "
                       f"{', '.join(available_methods())}")
    return _REGISTRY[name]


def make(name: str, cfg: Any = None) -> MethodStrategy:
    return get_class(name)(cfg)


def available_methods() -> List[str]:
    return sorted(_REGISTRY)
