"""Synthetic stand-ins for the paper's datasets, numpy only.

The port's own copy of ``repro.data.synthetic`` (the image task of the
§6.1 worlds): the same code on the same ``numpy.random.Generator`` gives
the same arrays, so both packages train on identical worlds.

* ``make_image_task`` — Fashion-MNIST/EMNIST-like 28x28 class-conditional
  images: a fixed random low-frequency template per class plus noise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_image_task(rng: np.random.Generator, n_classes: int = 10,
                    n_per_class: int = 400, side: int = 28
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional images: each class = fixed random low-frequency
    template + per-sample noise.  Returns (x [M,28,28,1], y [M])."""
    freqs = rng.normal(size=(n_classes, 4, 4))
    xs, ys = [], []
    grid = np.stack(np.meshgrid(np.linspace(0, 1, side),
                                np.linspace(0, 1, side)), -1)
    for c in range(n_classes):
        tpl = np.zeros((side, side))
        for i in range(4):
            for j in range(4):
                tpl += freqs[c, i, j] * np.sin(
                    np.pi * ((i + 1) * grid[..., 0] + (j + 1) * grid[..., 1]))
        tpl = tpl / (np.abs(tpl).max() + 1e-9)
        noise = rng.normal(scale=0.35, size=(n_per_class, side, side))
        xs.append(np.clip(tpl[None] + noise, -2, 2))
        ys.append(np.full((n_per_class,), c))
    x = np.concatenate(xs)[..., None].astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]
