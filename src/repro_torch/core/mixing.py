"""Implicit-gossip mixing matrices (Eq. 4) and ergodicity (Lemma 3) (port
of ``repro.core.mixing``; plain numpy in float64).

W^(t)_{ij} = 1/|A^t| for i,j in A^t; W_{ii} = 1 for i not in A^t; else 0.
rho = lambda_2(E[(W)^2]) < 1 whenever p_i^t >= c > 0 (Lemma 3):

    general:  rho <= 1 - c^4 (1 - (1-c)^m)^2 / 8
    uniform k-of-m: rho <= 1 - (k/m)^2 / 8
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


def mixing_matrix(active: np.ndarray) -> np.ndarray:
    """Eq. (4) for one round. active: [m] bool."""
    active = np.asarray(active, dtype=bool)
    m = len(active)
    k = int(active.sum())
    W = np.zeros((m, m))
    if k <= 1:
        return np.eye(m)
    idx = np.where(active)[0]
    W[np.ix_(idx, idx)] = 1.0 / k
    for i in range(m):
        if not active[i]:
            W[i, i] = 1.0
    return W


def expected_w2(p: np.ndarray) -> np.ndarray:
    """M = E[(W)^2] by exact enumeration over active sets (m <= ~16)."""
    p = np.asarray(p, dtype=np.float64)
    m = len(p)
    M = np.zeros((m, m))
    for bits in itertools.product([0, 1], repeat=m):
        prob = np.prod([pi if b else 1 - pi for pi, b in zip(p, bits)])
        W = mixing_matrix(np.array(bits, dtype=bool))
        M += prob * (W @ W)
    return M


def expected_w2_mc(p: np.ndarray, n_samples: int, seed: int = 0) -> np.ndarray:
    """Monte-Carlo M for larger m."""
    rng = np.random.default_rng(seed)
    p = np.asarray(p)
    m = len(p)
    M = np.zeros((m, m))
    for _ in range(n_samples):
        W = mixing_matrix(rng.random(m) < p)
        M += W @ W
    return M / n_samples


def rho_of(M: np.ndarray) -> float:
    """Second-largest eigenvalue of the (symmetric, doubly-stochastic) M."""
    ev = np.sort(np.linalg.eigvalsh(M))
    return float(ev[-2])


def lemma3_general_bound(c: float, m: int) -> float:
    return 1.0 - (c ** 4) * (1.0 - (1.0 - c) ** m) ** 2 / 8.0


def lemma3_uniform_bound(k: int, m: int) -> float:
    return 1.0 - (k / m) ** 2 / 8.0


def consensus_error(clients_flat) -> float:
    """(1/m) sum_i ||x_i - xbar||^2 — Eq. (5) diagnostics. ``clients_flat``
    is a numpy array or a torch tensor ``[m, n]``, such as one trajectory of
    a ``FedState``'s client buffer (``state.clients[b]``, any device and
    dtype; summed in float64)."""
    if isinstance(clients_flat, torch.Tensor):
        x = clients_flat.detach().double()
        return float(((x - x.mean(0)) ** 2).sum(-1).mean())
    xbar = clients_flat.mean(0)
    return float(np.mean(np.sum((clients_flat - xbar) ** 2, axis=-1)))
