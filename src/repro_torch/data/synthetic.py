"""Synthetic 10-class Gaussian-cluster classification data (numpy).

Own copy of ``repro.data.synthetic.make_classification_data``: the same
``seed`` gives the same bytes as the reference.
"""
from __future__ import annotations

import numpy as np


def make_classification_data(seed: int, *, num_classes=10, dim=64,
                             n_per_class=600, noise=1.0, sep=2.0):
    """Gaussian clusters: x ~ N(sep * mu_c, noise^2 I). Returns (x, y)."""
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(num_classes, dim))
    mus /= np.linalg.norm(mus, axis=1, keepdims=True)
    xs, ys = [], []
    for c in range(num_classes):
        xs.append(sep * mus[c] + noise * rng.normal(size=(n_per_class, dim)))
        ys.append(np.full(n_per_class, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]
