"""Data sources for the round engine (port of ``repro.data.sources``).

A ``DataSource`` turns one round's index draw into the per-client batches
the round consumes::

    sample(ds_state, round, pick) -> (batches, ds_state)

``batches`` leaves carry leading ``[B, m, s, ...]`` axes (trajectory,
client, local step). The randomness is injected: ``pick [B, m, s, b]`` is
the round's with-replacement index draw into every client's shard, made by
the engine's draw function (``repro_torch.core.federated``) from explicit
``torch.Generator``s, or handed in by a test. ``pick_spec`` tells the
drawer the draw's shape, ``(local_steps, batch_size, per_client)``, or is
``None`` for a source that needs no draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Batches = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DataSource:
    init: Callable[..., Any]      # (data) -> ds_state
    sample: Callable[..., Any]    # (ds_state, round, pick) -> (batches, ds_state)
    name: str = ""
    pick_spec: Optional[Tuple[int, int, int]] = None   # (s, b, per_client)


def _gather(idx: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """Dataset rows for ``pick [B, m, s, b]`` into the client shards ``idx``
    (``[m, per_client]`` shared by every trajectory, or ``[B, m, per_client]``)."""
    B, m = pick.shape[:2]
    flat = pick.reshape(B, m, -1)
    if idx.dim() == 2:
        idx = idx.unsqueeze(0).expand(B, -1, -1)
    return torch.gather(idx, 2, flat).reshape(pick.shape)


def classification_source(x, y, client_idx, *, local_steps: int,
                          batch_size: int) -> DataSource:
    """Sampler over a partitioned classification dataset held on one device:
    ``x [n, ...]``, ``y [n]``, ``client_idx [m, per_client]``. Each round
    draws ``[m, s, b]`` examples with replacement from every client's shard.
    """
    per_client = client_idx.shape[-1]

    def init(data=None):
        return ()

    def sample(ds_state, t, pick):
        sel = _gather(client_idx, pick)
        return {"x": x[sel], "y": y[sel]}, ds_state

    return DataSource(init, sample, "classification",
                      (local_steps, batch_size, per_client))


def traced_classification_source(shared, *, local_steps: int, batch_size: int,
                                 per_client: int) -> DataSource:
    """Counterpart of ``classification_source`` whose partition travels per
    trajectory in ``ds_state`` (``{"idx": [B, m, per_client]}``) and whose
    dataset is ``shared`` (``{"x": [n, ...], "y": [n]}``, one copy for every
    trajectory). Given equal arrays the two sources give equal batches.
    """

    def init(data):
        return data

    def sample(ds_state, t, pick):
        sel = _gather(ds_state["idx"], pick)
        return {"x": shared["x"][sel], "y": shared["y"][sel]}, ds_state

    return DataSource(init, sample, "classification_traced",
                      (local_steps, batch_size, per_client))


def fixed_source(batches: Batches) -> DataSource:
    """Every round sees the same ``[m, s, ...]`` batch leaves (the quadratic
    counterexample setups, where each client's objective is deterministic),
    served as ``[1, m, s, ...]`` so they broadcast over every trajectory."""
    batches = {k: v.unsqueeze(0) for k, v in batches.items()}

    def init(data=None):
        return ()

    def sample(ds_state, t, pick=None):
        return batches, ds_state

    return DataSource(init, sample, "fixed", None)
