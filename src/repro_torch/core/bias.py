"""Closed-form FedAvg bias (Proposition 1 / Eq. (3)) and helpers (port of
``repro.core.bias``; plain numpy in float64).

For quadratic local objectives F_i(x) = 1/2 ||x - u_i||^2 and time-invariant
Bernoulli uplinks with probabilities p_i, FedAvg's expected iterate converges
to Eq. (3):

    lim E[x^T] = sum_i  p_i u_i (1 + sum_{j=2}^m (-1)^{j+1} (1/j)
                  sum_{S subset [m]\\{i}, |S|=j-1} prod_{z in S} p_z)
                 / (1 - prod_i (1 - p_i))

(the inner sum runs over subsets of [m] \\ {i}; cf. the proof of Prop. 1 —
the theorem statement's B_j has a typo writing [m] \\ {j}).

Equivalently, the per-client weight is E[X_i / sum_j X_j | A != empty],
which we also expose via exact enumeration for validation.
"""
from __future__ import annotations

import itertools

import numpy as np


def fedavg_client_weights(p: np.ndarray) -> np.ndarray:
    """Exact E[X_i / sum X_j] / P(A != empty) by enumeration (m <= ~20)."""
    p = np.asarray(p, dtype=np.float64)
    m = len(p)
    w = np.zeros(m)
    for bits in itertools.product([0, 1], repeat=m):
        k = sum(bits)
        if k == 0:
            continue
        prob = np.prod([pi if b else 1 - pi for pi, b in zip(p, bits)])
        for i in range(m):
            if bits[i]:
                w[i] += prob / k
    return w / (1.0 - np.prod(1.0 - p))


def fedavg_fixed_point(p: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Eq. (3): limit of E[x^T] under FedAvg. u: [m, d]."""
    w = fedavg_client_weights(p)
    return (w[:, None] * np.asarray(u, dtype=np.float64)).sum(0)


def fedavg_fixed_point_series(p: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Eq. (3) evaluated via the paper's inclusion-exclusion series
    (independent code path; used to cross-check `fedavg_fixed_point`)."""
    p = np.asarray(p, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    m = len(p)
    out = np.zeros(u.shape[1])
    denom = 1.0 - np.prod(1.0 - p)
    for i in range(m):
        others = [z for z in range(m) if z != i]
        inner = 1.0
        for j in range(2, m + 1):
            ssum = sum(np.prod(p[list(S)]) for S in itertools.combinations(others, j - 1))
            inner += ((-1) ** (j + 1)) * ssum / j
        out += p[i] * inner / denom * u[i]
    return out


def two_client_fixed_point(u1, u2, p1, p2):
    """Fig. 2 scalar example: closed form for m=2."""
    w1 = (p1 * (1 - p2) + p1 * p2 / 2) / (1 - (1 - p1) * (1 - p2))
    w2 = (p2 * (1 - p1) + p1 * p2 / 2) / (1 - (1 - p1) * (1 - p2))
    return w1 * u1 + w2 * u2
