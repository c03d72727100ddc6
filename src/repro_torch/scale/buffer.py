"""Buffered semi-async aggregation (port of ``repro.scale.buffer``).

Cross-device FL servers do not wait for the whole active set: arriving
client updates are folded into a running buffer, and an aggregation step
*commits* when the buffer fills or a deadline passes (the
``Strategy(wait_for_full, buffer_size, ms_to_wait)`` shape of
afl-aggregation-bench, with the wall-clock deadline recast in rounds).
Between commits the server model is frozen, so every buffered contributor
trained from its own model, and on commit the postponed broadcast goes to
exactly the clients whose updates entered the committed buffer.

The fold is exact for the whole fusable (empty-state) family: each member's
server rule is a masked mean (``OP_MEAN``) or a weighted-delta step
(``OP_ALL`` / ``OP_KNOWN_P``), and both are sums over contributions. In the
degenerate configuration (commit every round: ``deadline_rounds=1`` without
``wait_for_full``, or ``wait_for_full`` with a buffer the round always
fills) the committed expression is term for term the port's synchronous
``masked_mean`` / ``weighted_sum``, the same reductions over the same
tensors, so the two engines agree bit for bit
(``tests/test_torch_scale.py``).

Every tensor carries the leading trajectory axis ``B``: ``acc [B, n]``,
the scalars ``[B]``, ``in_buffer [B, m]``. The knobs are Python scalars (a
``Strategy``: the branches are chosen in Python) or ``[B]`` tensors (the
sweep's per-trajectory columns, ``strategy_knob_columns``: chosen per
trajectory by ``torch.where``), so buffered-vs-sync is one more batched
dimension of one round function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels.ref import OP_ALL, OP_MEAN


@dataclass(frozen=True)
class Strategy:
    """One buffered-aggregation policy (a sweep-axis value).

    ``wait_for_full``: commit ONLY when ``buffer_size`` contributions have
    arrived (the deadline is ignored). Otherwise commit when the buffer
    fills OR ``deadline_rounds`` rounds have passed since the last commit.
    ``staleness_discount`` in [0, 1): per-round decay applied to the
    standing buffer (0 = pure partial sums, the exact fold).
    """

    name: str
    wait_for_full: bool = False
    buffer_size: int = 1
    deadline_rounds: int = 1
    staleness_discount: float = 0.0

    @property
    def is_sync(self) -> bool:
        """Whether this policy commits every round regardless of arrivals —
        the degenerate configuration equal to the synchronous engine."""
        return (not self.wait_for_full) and self.deadline_rounds == 1


SYNC = Strategy("sync")

# Per-trajectory knob columns, in batch-layout order. dtypes:
# bool / int32 / int32 / float32.
STRATEGY_KNOB_FIELDS = ("wait_for_full", "buffer_size", "deadline_rounds",
                        "staleness_discount")

# Per-round metrics every buffered round emits (callers extend metric_keys).
BUFFER_METRIC_KEYS = ("commit", "buffer_fill", "commit_staleness")


def knobs_of(strategy: Union[Strategy, Mapping[str, Any], None]
             ) -> Dict[str, Any]:
    """Normalize a strategy into its knob dict: a ``Strategy`` gives Python
    scalars, a mapping passes through (the sweep's ``[B]`` columns), None
    means SYNC."""
    if strategy is None:
        strategy = SYNC
    if isinstance(strategy, Strategy):
        return {"wait_for_full": bool(strategy.wait_for_full),
                "buffer_size": int(strategy.buffer_size),
                "deadline_rounds": int(strategy.deadline_rounds),
                "staleness_discount": float(strategy.staleness_discount)}
    missing = [k for k in STRATEGY_KNOB_FIELDS if k not in strategy]
    if missing:
        raise ValueError(f"strategy knob mapping is missing {missing}; "
                         f"expected keys {STRATEGY_KNOB_FIELDS}")
    return {k: strategy[k] for k in STRATEGY_KNOB_FIELDS}


def strategy_knob_columns(strategies: Sequence[Strategy], block: int,
                          device=None) -> Dict[str, torch.Tensor]:
    """Batch-layout knob columns: each strategy's scalars repeated over its
    ``block`` trajectories, concatenated in strategy order (``device=None``:
    the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    dtypes = {"wait_for_full": np.bool_, "buffer_size": np.int32,
              "deadline_rounds": np.int32, "staleness_discount": np.float32}
    return {k: torch.as_tensor(np.repeat(np.asarray(
        [getattr(s, k) for s in strategies], dt), block), device=dev)
        for k, dt in dtypes.items()}


@dataclass
class BufferState:
    """The server's running buffer between commits, per trajectory.

    ``acc`` mirrors the server params in fp32 (partial numerator or delta
    sum); ``weight``/``count`` are the folded denominator and contribution
    count; ``since`` counts rounds since the last commit (the deadline
    clock); ``age_sum`` accumulates contribution ages for the staleness
    metric; ``in_buffer`` marks clients with an update in the standing
    buffer (the postponed-broadcast recipients); ``commits`` counts commits.
    """

    acc: torch.Tensor        # [B, n] f32
    weight: torch.Tensor     # [B] f32
    count: torch.Tensor      # [B] i32
    since: torch.Tensor      # [B] i32
    age_sum: torch.Tensor    # [B] f32
    in_buffer: torch.Tensor  # [B, m] bool
    commits: torch.Tensor    # [B] i32


def init_buffer_state(server: torch.Tensor, m: int) -> BufferState:
    """An empty buffer for ``server [B, n]`` over ``m`` clients."""
    B, n = server.shape
    dev = server.device

    def zeros(dtype, *shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    return BufferState(acc=zeros(torch.float32, n),
                       weight=zeros(torch.float32),
                       count=zeros(torch.int32), since=zeros(torch.int32),
                       age_sum=zeros(torch.float32),
                       in_buffer=zeros(torch.bool, m),
                       commits=zeros(torch.int32))


def _col(v, like: torch.Tensor):
    """A per-trajectory ``[B]`` tensor as a column broadcasting against
    ``like [B, ...]``; Python scalars pass."""
    if isinstance(v, torch.Tensor):
        return v.reshape((-1,) + (1,) * (like.dim() - 1))
    return v


def _sel(pred, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select that stays a Python branch for a Python bool predicate and is
    a per-trajectory ``torch.where`` for a ``[B]`` one."""
    if isinstance(pred, (bool, np.bool_)):
        return a if pred else b
    return torch.where(_col(pred, a), a, b)


def buffered_aggregate(buf: BufferState, server: torch.Tensor,
                       x_star: torch.Tensor, active: torch.Tensor,
                       p_t: torch.Tensor, knobs: Mapping[str, Any], *, op,
                       m_total: int,
                       in_buffer_new: torch.Tensor) -> tuple:
    """Fold one round of arrivals into the buffer; commit if due.

    ``x_star [B, M, n]``: the round's trained client params, ``M`` matching
    ``active``/``p_t [B, M]`` (the full population, or a gathered cohort).
    ``op``: the member's fused opcode (``FUSED_OPS[name]``), a Python int or
    a ``[B]`` tensor for the batched family axis. ``m_total``: the
    population the delta-weighted members normalize by (m dense, C in
    cohort mode). ``in_buffer_new``: the updated ``[B, m]`` membership mask
    (the caller scatters cohort arrivals into it).

    Returns ``(new_buffer, new_server, commit [B] bool, metrics)`` with
    ``metrics`` keyed by ``BUFFER_METRIC_KEYS``, each ``[B]``.
    """
    static_op = not isinstance(op, torch.Tensor)
    # the weights and deltas are written as the synchronous branches write
    # them (core/algorithms.py), so a commit-every-round buffer reproduces
    # them bit for bit
    w_mean = active.float()
    xf = x_star.float()
    if static_op:
        is_mean = int(op) == OP_MEAN
        if int(op) == OP_MEAN:
            w = w_mean
        elif int(op) == OP_ALL:
            w = w_mean / m_total
        else:
            w = w_mean / p_t.clamp_min(1e-3) / m_total
        d = xf if is_mean else xf - server.unsqueeze(1).float()
    else:
        is_mean = op == OP_MEAN
        opc = op.unsqueeze(-1)
        w = torch.where(opc == OP_MEAN, w_mean,
                        torch.where(opc == OP_ALL, w_mean / m_total,
                                    w_mean / p_t.clamp_min(1e-3) / m_total))
        d = torch.where(_col(is_mean, xf), xf,
                        xf - server.unsqueeze(1).float())

    decay = 1.0 - knobs["staleness_discount"]
    # Fold this round's arrivals: mean members accumulate raw params (the
    # masked_mean numerator), delta members weighted deltas against the
    # FROZEN server, so the fold is the synchronous sum in installments.
    contrib = (d * w.unsqueeze(-1)).sum(1)
    # decay * 0 + contrib == contrib exactly (the standing buffer is +0.0
    # after init/commit), so the commit-every-round path stays bitwise.
    acc = _col(decay, contrib) * buf.acc + contrib
    weight = decay * buf.weight + w.sum(-1)
    count = buf.count + active.sum(-1).to(torch.int32)
    since = buf.since + 1
    # everything already buffered ages one round before the new arrivals
    age_sum = buf.age_sum + buf.count.float()

    full = count >= knobs["buffer_size"]
    due = since >= knobs["deadline_rounds"]
    commit = _sel(knobs["wait_for_full"], full, full | due)

    # Commit expressions mirror the synchronous branches term for term: mean
    # members divide by max(weight, 1) and keep the server on an empty
    # buffer; delta members add the folded update.
    s = server

    def mean_srv():
        denom = weight.clamp_min(1.0).unsqueeze(-1)
        return torch.where((weight > 0.0).unsqueeze(-1),
                           (acc / denom).to(s.dtype), s)

    def delta_srv():
        return s + acc.to(s.dtype)

    if isinstance(is_mean, bool):
        committed = mean_srv() if is_mean else delta_srv()
    else:
        committed = _sel(is_mean, mean_srv(), delta_srv())
    new_server = torch.where(commit.unsqueeze(-1), committed, s)

    mean_age = age_sum / count.float().clamp_min(1.0)
    keep = ~commit
    new_buf = BufferState(
        acc=torch.where(commit.unsqueeze(-1), 0.0, acc),
        weight=torch.where(commit, 0.0, weight),
        count=torch.where(commit, 0, count),
        since=torch.where(commit, 0, since),
        age_sum=torch.where(commit, 0.0, age_sum),
        in_buffer=in_buffer_new & keep.unsqueeze(-1),
        commits=buf.commits + commit.to(torch.int32))
    metrics = {"commit": commit.float(), "buffer_fill": count.float(),
               "commit_staleness": torch.where(commit, mean_age, 0.0)}
    return new_buf, new_server, commit, metrics
