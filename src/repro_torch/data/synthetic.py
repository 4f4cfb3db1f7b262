"""Synthetic stand-ins for the paper's datasets, numpy only.

The port's own copy of ``repro.data.synthetic`` (the image task of the
§6.1 worlds and the token task of the real-model worlds): the same code on
the same ``numpy.random.Generator`` gives the same arrays, so both packages
train on identical worlds.

* ``make_image_task`` — Fashion-MNIST/EMNIST-like 28x28 class-conditional
  images: a fixed random low-frequency template per class plus noise.
* ``make_token_stream`` / ``make_token_task`` — Zipf-ish token streams,
  sharded per client, for the real-model LM tasks.
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


def make_token_stream(rng: np.random.Generator, vocab: int, n_tokens: int
                      ) -> np.ndarray:
    """Zipf-ish token stream with local structure for LM examples."""
    base = rng.zipf(1.3, size=n_tokens).astype(np.int64)
    toks = (base + rng.integers(0, 7, size=n_tokens)) % vocab
    return toks.astype(np.int32)


def make_token_task(rng: np.random.Generator, vocab: int, n_clients: int,
                    cap: int, seq_len: int, n_test: int = 16
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-client LM shards for the real-model task worlds.

    Each client's rows come from its own Zipf stream shifted by a
    client-specific token offset (non-iid vocabulary slices across
    clients).  Returns (x [n_clients, cap, seq_len] int32, test_x [n_test,
    seq_len] int32); next-token targets are the sequences themselves (the
    model's loss shifts internally)."""
    x = np.empty((n_clients, cap, seq_len), np.int32)
    for c in range(n_clients):
        stream = make_token_stream(rng, vocab, cap * seq_len)
        x[c] = ((stream + (c * 7) % vocab) % vocab).reshape(cap, seq_len)
    test = make_token_stream(rng, vocab, n_test * seq_len)
    return x, test.reshape(n_test, seq_len)
