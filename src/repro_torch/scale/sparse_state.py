"""Gather/scatter updates of the per-client ``AlgoState`` rows (port of
``repro.scale.sparse_state``).

The stateful rules keep ``[B, m, ...]`` per-client leaves: FedAU's gap
stats, MIFA's update memory, F3AST's availability EMAs (FedPBC-M's momentum
is the server's, ``[B, 1, n]``). At m = 50k an elementwise update of those
leaves every round is the O(m) work cohort subsampling exists to avoid, and
for MIFA the ``[m, n]`` memory write would dominate. So each rule gets a
*cohort branch*: its rows are read by ``gather`` at ``cohort [B, C]`` and
written back by ``scatter_`` at the same indices, IN PLACE — only the
B x C sampled rows are touched per round, and the branch consumes the
``algo_state`` it is given (it returns the same object). MIFA's memory
itself is ``[B, m, n]`` storage, as in the reference; its per-round write
is O(C·n) and its read is the mean over rows.

Semantics against the dense branches (``core/algorithms.py``): the same
update rules on the cohort's rows, with population normalizations over the
cohort (the delta-weighted members average over the C candidates, and
FedAU's gap clocks tick in cohort appearances). Every branch has the
signature ``(algo_state, server [B, n], x_star_c [B, C, n], cohort [B, C],
c_active [B, C], c_p [B, C], t) -> (algo_state', server')``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.core.algorithms import (
    AlgorithmSpec,
    _delta,
    masked_mean,
    weighted_sum,
)


def _cohort_fedau(spec: AlgorithmSpec) -> Callable:
    K = spec.fedau_K

    def branch(algo, server, x_star, cohort, c_active, c_p, t):
        C = c_active.shape[-1]
        gap_c = torch.clamp_max(algo.gap.gather(1, cohort) + 1.0, float(K))
        sum_c = algo.sum_gaps.gather(1, cohort) + torch.where(c_active,
                                                              gap_c, 0.0)
        n_c = algo.n_gaps.gather(1, cohort) + c_active.float()
        mean_gap = torch.where(n_c > 0, sum_c / n_c.clamp_min(1.0), 1.0)
        w = c_active.float() * mean_gap / C
        new_server = server + weighted_sum(_delta(x_star, server),
                                           w).to(server.dtype)
        algo.gap.scatter_(1, cohort, torch.where(c_active, 0.0, gap_c))
        algo.sum_gaps.scatter_(1, cohort, sum_c)
        algo.n_gaps.scatter_(1, cohort, n_c)
        return algo, new_server

    return branch


def _cohort_mifa(spec: AlgorithmSpec) -> Callable:
    def branch(algo, server, x_star, cohort, c_active, c_p, t):
        mem = algo.mem
        rows = cohort.unsqueeze(-1).expand(-1, -1, mem.shape[-1])
        # O(C·n) write: only the arrived cohort rows of the memory change
        new = torch.where(c_active.unsqueeze(-1),
                          _delta(x_star, server).to(mem.dtype),
                          mem.gather(1, rows))
        mem.scatter_(1, rows, new)
        return algo, server + mem.mean(1).to(server.dtype)

    return branch


def _cohort_f3ast(spec: AlgorithmSpec) -> Callable:
    beta, cap = spec.f3ast_beta, spec.f3ast_cap

    def branch(algo, server, x_star, cohort, c_active, c_p, t):
        lam_c = (1.0 - beta) * algo.lam.gather(1, cohort) \
            + beta * c_active.float()
        # availability-balanced pick within the cohort: the `cap` arrived
        # clients with the smallest EMA (stable ranks, as jnp.argsort)
        score = torch.where(c_active, lam_c, float("inf"))
        order = torch.argsort(score, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        selected = c_active & (rank < cap)
        any_sel = selected.any(-1, keepdim=True)
        new_server = torch.where(any_sel, masked_mean(x_star, selected),
                                 server)
        algo.lam.scatter_(1, cohort, lam_c)
        return algo, new_server

    return branch


def _cohort_fedpbc_m(spec: AlgorithmSpec) -> Callable:
    beta = spec.fedpbc_m_beta

    def branch(algo, server, x_star, cohort, c_active, c_p, t):
        any_active = c_active.any(-1, keepdim=True)
        agg = masked_mean(x_star, c_active)
        step = torch.where(any_active, agg.float() - server.float(), 0.0)
        mom = beta * algo.mom[:, 0] + step
        new_server = (server.float() + mom).to(server.dtype)
        return dataclasses.replace(algo, mom=mom.unsqueeze(1)), new_server

    return branch


_COHORT_DEFS: Dict[str, Callable[[AlgorithmSpec], Callable]] = {
    "fedau": _cohort_fedau,
    "mifa": _cohort_mifa,
    "f3ast": _cohort_f3ast,
    "fedpbc_m": _cohort_fedpbc_m,
}

COHORT_STATEFUL = frozenset(_COHORT_DEFS)


def cohort_branch(name: str, spec: AlgorithmSpec) -> Callable:
    """The sparse cohort aggregate of a stateful rule. The fusable
    (empty-state) family does not appear here: its cohort path runs through
    the buffer engine (``repro_torch.scale.buffer``), SYNC knobs
    included."""
    if name not in _COHORT_DEFS:
        raise ValueError(
            f"no sparse cohort branch for {name!r} (stateful rules: "
            f"{sorted(_COHORT_DEFS)}; the empty-state family aggregates "
            f"through the buffer engine)")
    return _COHORT_DEFS[name](spec)
