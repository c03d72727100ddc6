"""Unreliable-uplink processes (paper §7.2), port of ``repro.core.connectivity``.

The per-client connection probabilities of Eq. 9 and the three unreliable
schemes — Bernoulli, two-state Markov, cyclic — each with its time-invariant
and time-varying / homogeneous and non-homogeneous / reset and no-reset
variants, over a leading trajectory axis: ``p_base [B, m]``.

Randomness is injected. ``init(u)`` and ``sample(state, t, u)`` take the
uniforms ``u [B, m]`` the engine drew for them (``repro_torch.core.federated
.draw_round``) and return ``(active [B, m] bool, p_t [B, m], new_state)``.
``t`` is the round index: a Python int shared by every trajectory, or a
``[B]`` int tensor when the trajectories of a batch stand at different
rounds (the adaptive search's mixed batches); each row then computes what
an int round would give it, bit for bit.

The Eq.-9 knobs ``gamma`` and ``period`` default to the config's values;
the sweep passes per-trajectory ``[B]`` tensors instead, so a gamma
ablation is one batch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Union

import numpy as np
import torch

from repro_torch.configs import FederationConfig

Scalar = Union[float, int, torch.Tensor]


# ---------------------------------------------------------------------------
# Eq. (9): p_i construction from data heterogeneity
# ---------------------------------------------------------------------------


def build_base_probs(seed_or_rng, num_clients, num_classes, *, alpha=0.1,
                     sigma0=10.0, mu0=0.0, delta=0.02):
    """Paper §7.2: nu_i ~ Dirichlet(alpha); r ~ lognormal(mu0, sigma0^2)^C
    normalized; p_i = <r, nu_i> clipped at delta. Returns numpy
    ``(p [m] float32, nu [m, C], r [C])``.

    Drawn on the host with ``np.random.default_rng`` — not the reference's
    ``jax.random.dirichlet`` stream, so parity tests hand ``p_base`` across.
    """
    rng = (seed_or_rng if isinstance(seed_or_rng, np.random.Generator)
           else np.random.default_rng(seed_or_rng))
    nu = rng.dirichlet(np.full(num_classes, alpha), size=num_clients)
    r = np.exp(mu0 + sigma0 * rng.normal(size=num_classes))
    r = r / r.sum()
    p = nu @ r
    return np.maximum(p, delta).astype(np.float32), nu, r


def _col(v: Scalar) -> Scalar:
    """A per-trajectory ``[B]`` knob as a ``[B, 1]`` column; scalars pass."""
    return v.reshape(-1, 1) if isinstance(v, torch.Tensor) else v


# the angle's factor, rounded to float32 as the reference rounds it
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def p_of_t(p_base: torch.Tensor, t, *, gamma: Scalar,
           period: Scalar) -> torch.Tensor:
    """Eq. (9): p_i^t = p_i * [(1-gamma) + gamma * sin(2 pi t / P)], in
    float32 as the reference computes it: ``float32(2 pi) * float32(t)``,
    divided by ``P``, then ``sin``. ``gamma``/``period`` are numbers or
    ``[B]`` tensors; ``t`` an int or a ``[B]`` tensor, whose float32
    product per row has the bits of the int path's numpy product."""
    if isinstance(t, torch.Tensor):
        ang = _TWO_PI_F32 * t.reshape(-1, 1).to(p_base.device, torch.float32)
        if isinstance(period, torch.Tensor):
            # the int path's ``float / tensor`` is ``reciprocal() * float``
            per = _col(period).to(p_base.device, torch.float32)
            eps = torch.sin(per.reciprocal() * ang)
        else:
            eps = torch.sin(ang / period)
    else:
        ang = float(np.float32(2.0 * math.pi) * np.float32(t))  # f32 product
        if isinstance(period, torch.Tensor):
            eps = torch.sin(ang / _col(period).to(p_base.device,
                                                  torch.float32))
        else:
            eps = torch.sin(torch.full((), ang, dtype=torch.float32,
                                       device=p_base.device) / period)
    gamma = _col(gamma)
    return torch.clamp(p_base * ((1.0 - gamma) + gamma * eps), 0.0, 1.0)


def _dynamics(cfg: FederationConfig, gamma, period):
    """Explicit overrides win over the config's static values."""
    return (cfg.gamma if gamma is None else gamma,
            cfg.period if period is None else period)


# ---------------------------------------------------------------------------
# Link processes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkProcess:
    init: Callable[..., Any]          # (u [B, m]) -> state
    sample: Callable[..., Any]        # (state, t, u) -> (active, p_t, state)
    name: str = ""


def bernoulli_process(p_base, cfg: FederationConfig, *, gamma=None,
                      period=None) -> LinkProcess:
    tv = cfg.time_varying
    gamma, period = _dynamics(cfg, gamma, period)

    def init(u):
        return ()

    def sample(state, t, u):
        p_t = p_of_t(p_base, t, gamma=gamma, period=period) if tv else p_base
        return u < p_t, p_t, state

    return LinkProcess(init, sample, f"bernoulli_{'tv' if tv else 'ti'}")


def markov_process(p_base, cfg: FederationConfig, *, gamma=None,
                   period=None) -> LinkProcess:
    """Two-state ON/OFF chain, Table 3 transition construction.

    Homogeneous: transitions from time-invariant p_i. Non-homogeneous:
    transitions re-derived from time-varying p_i^t.

    Time-index convention (as in the reference): the mask returned for
    round ``t`` is the chain state AFTER the transition derived from
    ``p_of_t(t)`` — ``sample`` advances ``X_{t-1} -> X_t`` with rates
    ``(q_t, q*_t) = transitions(p_i^t)`` and returns ``X_t``; the ``init``
    draw ``X_{-1} ~ Bernoulli(p_base)`` is the pre-round seed state and is
    never itself a mask.
    """
    tv = cfg.time_varying
    gamma, period = _dynamics(cfg, gamma, period)

    def transitions(p_t):
        p_t = torch.clamp(p_t, 1e-4, 1 - 1e-4)
        cond = 0.05 * (1.0 - p_t) <= p_t
        q_star = torch.where(cond, 0.05, p_t / (1.0 - p_t))        # OFF -> ON
        q = torch.where(cond, 0.05 * (1.0 - p_t) / p_t, 1.0)        # ON -> OFF
        return q, q_star

    def init(u):
        return u < p_base

    def sample(on, t, u):
        p_t = p_of_t(p_base, t, gamma=gamma, period=period) if tv else p_base
        q, q_star = transitions(p_t)
        new_on = torch.where(on, u >= q, u < q_star)
        return new_on, p_t, new_on

    return LinkProcess(init, sample, f"markov_{'nonhom' if tv else 'hom'}")


def cyclic_process(p_base, cfg: FederationConfig, *, gamma=None,
                   period=None) -> LinkProcess:
    """Fig. 5: link active for p_i*L of every cycle of length L, after a
    random offset drawn once (no reset) or redrawn at every cycle start
    (periodic reset) from that round's engine draw ``u``.

    The reported connection probability follows the bernoulli/markov
    semantics: time-varying configs report ``p_of_t``.
    """
    L = cfg.cyclic_length
    tv = cfg.time_varying
    reset = cfg.cyclic_reset
    gamma, period = _dynamics(cfg, gamma, period)

    def offsets(u):
        return u * (1.0 - p_base) * L

    def init(u):
        return {"offset": offsets(u)}

    def sample(state, t, u):
        if isinstance(t, torch.Tensor):     # per-row rounds
            col = t.reshape(-1, 1).to(p_base.device)
            if reset:
                state = {"offset": torch.where(col % L == 0, offsets(u),
                                               state["offset"])}
            phase = (col % L).to(torch.float32)
        else:
            if reset and t % L == 0:
                state = {"offset": offsets(u)}
            phase = float(t % L)
        off = state["offset"]
        active = (phase >= off) & (phase < off + p_base * L)
        p_t = p_of_t(p_base, t, gamma=gamma, period=period) if tv else p_base
        return active, p_t, state

    return LinkProcess(init, sample, f"cyclic_{'reset' if reset else 'noreset'}")


def make_link_process(p_base, cfg: FederationConfig, *, gamma=None,
                      period=None) -> LinkProcess:
    """Build the configured scheme's process. ``gamma``/``period`` override
    the config's Eq.-9 dynamics and may be ``[B]`` tensors."""
    kw = dict(gamma=gamma, period=period)
    if cfg.scheme == "bernoulli":
        return bernoulli_process(p_base, cfg, **kw)
    if cfg.scheme == "markov":
        return markov_process(p_base, cfg, **kw)
    if cfg.scheme == "cyclic":
        return cyclic_process(p_base, cfg, **kw)
    raise ValueError(cfg.scheme)
