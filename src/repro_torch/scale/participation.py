"""Per-round cohort subsampling (port of ``repro.scale.participation``).

Cross-device servers never talk to all m clients in a round: a cohort of
C ≪ m candidates is drawn, and only those face the link process. The
composition keeps ``core/federated.py``'s mask semantics: the link is still
sampled over the full ``[B, m]`` population (its state, Markov chains
included, advances identically whether or not a cohort is drawn), and the
cohort's arrival mask is the gather ``active[b, cohort[b]]``, so a client
participates iff it is sampled AND its uplink is up, and the round's
client-side compute and memory are O(C), not O(m).

``sample_cohort`` is a drawer: it takes an explicit ``torch.Generator``
(the engine's ``"cohort"`` stream, ``GeneratorDraws``), apart from the
functions that compute a round from the draw.
"""
from __future__ import annotations

import torch


def sample_cohort(gen: torch.Generator, m: int, size: int) -> torch.Tensor:
    """Uniform without-replacement cohort: ``[size]`` unique int64 client
    indices in ``[0, m)``, on the generator's device."""
    if not 1 <= size <= m:
        raise ValueError(f"cohort size {size} must be in [1, m={m}]")
    return torch.randperm(m, generator=gen, device=gen.device)[:size]


def cohort_arrivals(cohort: torch.Tensor, active_m: torch.Tensor,
                    p_t_m: torch.Tensor):
    """Gather the full-population link draw down to the cohort:
    ``cohort [B, C]`` into ``active_m [B, m]`` and ``p_t_m [B, m]`` gives
    the ``[B, C]`` arrival mask (sampled AND link up) and the matching link
    probabilities for importance-weighted members."""
    return active_m.gather(1, cohort), p_t_m.gather(1, cohort)


def scatter_mask(cohort: torch.Tensor, values: torch.Tensor,
                 m: int) -> torch.Tensor:
    """Scatter a ``[B, C]`` bool cohort mask into a dense ``[B, m]`` mask
    (rows outside the cohort are False), for bookkeeping that stays
    ``[B, m]``."""
    out = torch.zeros(cohort.shape[0], m, dtype=torch.bool,
                      device=cohort.device)
    return out.scatter_(1, cohort, values)
