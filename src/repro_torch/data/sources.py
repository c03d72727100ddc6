"""Data sources for the round engine (port of ``repro.data.sources``).

A ``DataSource`` turns one round's index draw into the per-client batches
the round consumes::

    sample(ds_state, round, pick) -> (batches, ds_state)

``batches`` leaves carry leading ``[B, m, s, ...]`` axes (trajectory,
client, local step). The randomness is injected: ``pick`` is the round's
draw — ``[B, m, s, b]`` with-replacement indices into every client's shard
for the classification sources, ``[B, m, s, b, T]`` tokens for the LM
source — made by the engine's draw function
(``repro_torch.core.federated``) from explicit ``torch.Generator``s, or
handed in by a test. ``pick_spec`` tells the drawer the draw,
``(*per-client shape, high)`` (integers in ``[0, high)``), or is ``None``
for a source that needs no draw; ``init_high`` likewise the per-client
draw that ``init`` takes (the LM source's offsets), or ``None``.

Cohort mode (``repro_torch.scale``): ``sample_cohort(ds_state, round,
cohort, pick)`` takes the round's cohort ``[B, C]`` and a draw with ``C`` in
place of ``m`` (``[B, C, s, b]``) and returns ``[B, C, s, ...]`` batches of
the sampled clients only, so a round's data is O(C), not O(m). With the
full-population cohort ``arange(m)`` it is bit for bit the dense
``sample``. A source without it (``None``) cannot run the cohort engine.
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
    pick_spec: Optional[Tuple[int, ...]] = None   # (*per-client shape, high)
    init_high: Optional[int] = None               # init's per-client draw
    # (ds_state, round, cohort [B, C], pick [B, C, ...]) -> (batches, ds_state)
    sample_cohort: Optional[Callable[..., Any]] = None


def _cohort_rows(idx: torch.Tensor, cohort: torch.Tensor) -> torch.Tensor:
    """The cohort's shards ``[B, C, per_client]`` of the client shards
    ``idx`` (``[m, per_client]`` shared, or ``[B, m, per_client]``)."""
    if idx.dim() == 2:
        return idx[cohort]
    return torch.gather(idx, 1, cohort.unsqueeze(-1).expand(
        -1, -1, idx.shape[-1]))


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

    def sample_cohort(ds_state, t, cohort, pick):
        sel = _gather(_cohort_rows(client_idx, cohort), pick)
        return {"x": x[sel], "y": y[sel]}, ds_state

    return DataSource(init, sample, "classification",
                      (local_steps, batch_size, per_client),
                      sample_cohort=sample_cohort)


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

    def sample_cohort(ds_state, t, cohort, pick):
        sel = _gather(_cohort_rows(ds_state["idx"], cohort), pick)
        return {"x": shared["x"][sel], "y": shared["y"][sel]}, ds_state

    return DataSource(init, sample, "classification_traced",
                      (local_steps, batch_size, per_client),
                      sample_cohort=sample_cohort)


def traced_lm_source(shared, *, local_steps: int, batch_size: int,
                     per_client: int) -> DataSource:
    """Next-token counterpart of ``traced_classification_source``: the
    corpus is ``shared`` (``{"toks": [n, T + 1]}`` int sequences, each one
    token longer than the context so tokens and labels come from one
    slice), the partition ``ds_state`` (``{"idx": [B, m, per_client]}``
    sequence indices). A round's ``pick [B, m, s, b]`` chooses sequences
    with replacement from every client's shard, the classification
    sources' protocol; the batches are ``tokens = seqs[..., :-1]`` and
    ``labels = seqs[..., 1:]``.
    """

    def init(data):
        return data

    def _slice(seqs):
        return {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}

    def sample(ds_state, t, pick):
        return _slice(shared["toks"][_gather(ds_state["idx"], pick)]), \
            ds_state

    def sample_cohort(ds_state, t, cohort, pick):
        sel = _gather(_cohort_rows(ds_state["idx"], cohort), pick)
        return _slice(shared["toks"][sel]), ds_state

    return DataSource(init, sample, "lm_traced",
                      (local_steps, batch_size, per_client),
                      sample_cohort=sample_cohort)


def lm_source(*, num_clients: int, local_steps: int, batch: int, seq: int,
              vocab: int, client_shift: bool = True,
              memory_shape: Optional[Tuple[int, ...]] = None) -> DataSource:
    """Synthetic non-IID token streams: each client draws tokens from its
    own half-vocab slice ``[lo, lo + vocab // 2)``.

    ``init(lo)`` takes the offsets ``lo [B, m]`` (drawn once, in
    ``[0, vocab // 2)``; ``None`` without ``client_shift``);
    ``sample(ds_state, t, pick)`` takes the round's token draw
    ``pick [B, m, s, b, T]`` in ``[0, vocab // 2)`` and returns ``tokens =
    lo + pick`` with ``labels = roll(tokens, -1)`` along the sequence.
    ``num_clients`` is the reference's signature; the shapes come with the
    draws. ``sample_cohort(ds_state, t, cohort, pick)`` takes the cohort
    ``[B, C]`` and its clients' token draw ``[B, C, s, b, T]``.
    """
    if memory_shape is not None:
        raise NotImplementedError(
            "memory leaves (vlm/audio) wait for the model zoo (ROADMAP "
            "Queue 1 item 14)")
    half = vocab // 2

    def init(lo=None):
        return {"lo": lo}

    def sample(ds_state, t, pick):
        lo = ds_state["lo"]
        toks = pick if lo is None else lo[:, :, None, None, None] + pick
        return {"tokens": toks, "labels": toks.roll(-1, -1)}, ds_state

    def sample_cohort(ds_state, t, cohort, pick):
        lo = ds_state["lo"]
        toks = pick if lo is None else \
            lo.gather(1, cohort)[:, :, None, None, None] + pick
        return {"tokens": toks, "labels": toks.roll(-1, -1)}, ds_state

    return DataSource(init, sample, "lm", (local_steps, batch, seq, half),
                      half if client_shift else None,
                      sample_cohort=sample_cohort)


def fixed_source(batches: Batches) -> DataSource:
    """Every round sees the same ``[m, s, ...]`` batch leaves (the quadratic
    counterexample setups, where each client's objective is deterministic),
    served as ``[1, m, s, ...]`` so they broadcast over every trajectory;
    a cohort ``[B, C]`` gets its clients' rows, ``[B, C, s, ...]``."""
    full = batches
    batches = {k: v.unsqueeze(0) for k, v in full.items()}

    def init(data=None):
        return ()

    def sample(ds_state, t, pick=None):
        return batches, ds_state

    def sample_cohort(ds_state, t, cohort, pick=None):
        return {k: v[cohort] for k, v in full.items()}, ds_state

    return DataSource(init, sample, "fixed", None,
                      sample_cohort=sample_cohort)
