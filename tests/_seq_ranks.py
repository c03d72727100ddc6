"""Simulated sequence-parallel ranks in one process: one thread a rank,
each with a ``repro_torch.sharding.pool.SequenceAxis`` whose two
collectives (``_all_gather``, ``_all_reduce``) meet the other threads'
through shared memory and a barrier instead of ``torch.distributed``. Every
exchange of the axis (``gather_prefix``, ``gather_all``, ``all_sum``,
``prev_rows``, ``carry_in``, ``reduce_grads``, ``reduce_loss``) runs as it
runs in a pool worker, forward and backward, and the axis tallies its
collectives as there. A sum adds the ranks' tensors in rank order, so
every rank gets the same bits, as from a real all-reduce.
"""
import threading

import torch

from repro_torch.sharding.pool import SequenceAxis
from repro_torch.sharding.specs import sequence_parallel


class _Exchange:
    """The ranks' meeting point: each deposits its tensor, waits for the
    others, reads all of them, and waits again before the slots are
    reused."""

    def __init__(self, size: int):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=120)

    def swap(self, index: int, x: torch.Tensor):
        self.slots[index] = x.detach().clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


class ThreadAxis(SequenceAxis):
    """A ``SequenceAxis`` whose collectives run between threads."""

    def __init__(self, index: int, size: int, exchange: _Exchange):
        super().__init__(index, size, None, host_staged=False)
        self.exchange = exchange

    def _all_gather(self, x, dim):
        parts = self.exchange.swap(self.index, x)
        out = torch.cat(parts, dim)
        self.bytes["all-gather"] += out.numel() * out.element_size()
        self.count["all-gather"] += 1
        return out

    def _all_reduce(self, x):
        parts = self.exchange.swap(self.index, x)
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p
        self.bytes["all-reduce"] += out.numel() * out.element_size()
        self.count["all-reduce"] += 1
        return out


def run_ranks(size: int, fn):
    """``fn(axis)`` on ``size`` threads, each with its rank's
    ``ThreadAxis`` installed as the forward's sequence axis; returns the
    values in rank order (a rank's exception is raised here)."""
    exchange = _Exchange(size)
    axes = [ThreadAxis(r, size, exchange) for r in range(size)]
    out, errors = [None] * size, []

    def work(r):
        try:
            with sequence_parallel(axes[r]):
                out[r] = fn(axes[r])
        except BaseException as e:      # reported below, with the barrier
            errors.append(e)
            exchange.barrier.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out

