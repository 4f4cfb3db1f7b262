"""Federated non-iid partitioner of the paper's §6.1 protocol, numpy only.

The port's own copy of ``repro.data.partition`` (the parts the §6.1 CNN
worlds use): the same code on the same generator gives the same arrays.

For each model (task):
  * every client sees only 30% of the labels (label-shard non-iid-ness);
  * clients split into high-data (10% of clients, ~120 datapoints each) and
    low-data (90%, ~12 datapoints each) groups, independently per model.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def label_shard_partition(
    rng: np.random.Generator,
    x: np.ndarray,
    y: np.ndarray,
    n_clients: int,
    label_frac: float = 0.3,
    high_frac: float = 0.1,
    n_high: int = 120,
    n_low: int = 12,
    n_labels: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Returns {"x": [N,cap,...], "y": [N,cap,...], "count": [N],
    "high": [N] bool} with wrap-padding (padded rows repeat real rows)."""
    n_labels = int(n_labels if n_labels is not None else y.max() + 1)
    k_labels = max(1, int(round(label_frac * n_labels)))
    by_label = [np.where(y == c)[0] for c in range(n_labels)]

    high = np.zeros(n_clients, bool)
    high[rng.choice(n_clients, max(1, int(high_frac * n_clients)),
                    replace=False)] = True
    counts = np.where(high, n_high, n_low)
    # jitter counts +-20% ("around 120 / around 12 datapoints")
    counts = np.maximum(2, (counts * rng.uniform(0.8, 1.2, n_clients))
                        .astype(np.int64))
    cap = int(counts.max())

    xs = np.zeros((n_clients, cap) + x.shape[1:], x.dtype)
    ys = np.zeros((n_clients, cap) + y.shape[1:], y.dtype)
    for i in range(n_clients):
        labels = rng.choice(n_labels, k_labels, replace=False)
        pool = np.concatenate([by_label[c] for c in labels])
        take = rng.choice(pool, counts[i], replace=counts[i] > len(pool))
        pad = np.resize(take, cap)            # wrap-pad with real rows
        xs[i], ys[i] = x[pad], y[pad]
    return {"x": xs, "y": ys, "count": counts.astype(np.int32), "high": high}


def processor_budgets(rng: np.random.Generator, avail: np.ndarray
                      ) -> np.ndarray:
    """Paper §6.1 client resource heterogeneity: B_i = |S_i| for 25%,
    ceil(|S_i|/2) for 50%, 1 for 25%."""
    n = avail.shape[0]
    si = avail.sum(axis=1)
    u = rng.permutation(n)
    B = np.empty(n, np.int64)
    q1, q2 = n // 4, n // 4 + n // 2
    B[u[:q1]] = si[u[:q1]]
    B[u[q1:q2]] = np.ceil(si[u[q1:q2]] / 2).astype(np.int64)
    B[u[q2:]] = 1
    return np.maximum(B, 1)


def availability(rng: np.random.Generator, n_clients: int, n_models: int,
                 frac_all: float = 0.9) -> np.ndarray:
    """90% of clients can train all S models, 10% only S-1 (random)."""
    avail = np.ones((n_clients, n_models), bool)
    limited = rng.choice(n_clients,
                         max(0, int(round((1 - frac_all) * n_clients))),
                         replace=False)
    for i in limited:
        avail[i, rng.integers(n_models)] = False
    return avail
