"""Non-IID Dirichlet partitioning (Hsu et al. 2019, paper §7.2), numpy.

Own copy of ``repro.data.partition.dirichlet_partition``: the same
generator state gives the same split as the reference.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray,
                        num_clients: int, alpha: float, per_client: int):
    """Returns (indices [m, per_client], nu [m, C])."""
    classes = np.unique(labels)
    C = len(classes)
    by_class = {c: rng.permutation(np.where(labels == c)[0]).tolist() for c in classes}
    nu = rng.dirichlet(np.full(C, alpha), size=num_clients)
    out = np.zeros((num_clients, per_client), dtype=np.int64)
    for i in range(num_clients):
        counts = rng.multinomial(per_client, nu[i])
        got = []
        for c, n in zip(classes, counts):
            pool = by_class[int(c)]
            take = pool[:n]
            if len(take) < n:  # recycle if exhausted (sampling w/ replacement)
                extra = rng.choice(np.where(labels == c)[0], n - len(take))
                take = take + list(extra)
            by_class[int(c)] = pool[n:]
            got.extend(take)
        while len(got) < per_client:
            got.append(int(rng.integers(len(labels))))
        out[i] = np.array(got[:per_client])
    return out, nu
