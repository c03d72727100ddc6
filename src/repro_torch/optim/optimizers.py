"""Minimal optimizers (SGD + momentum, Adam) over the flat parameter buffer
(port of ``repro.optim.optimizers``).

``params``/``grads`` are ``[B, m, n]`` (trajectory, client, flat params) and
the state holds a per-client ``step`` counter ``[B, m]`` int32 plus the
moment buffers. The counter is carried across rounds in ``FedState``, so a
schedule decays with the client's total local steps, as in the reference.
``lr`` is a number, a ``[B]`` tensor, or a schedule ``step [B, m] -> [B, m]``.
A model in two parameter groups (``repro_torch.core.params.Groups``) has its
update and moments mapped over the groups, one ``step`` counter for both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.params import Leaves, first, gmap, lead_view
from repro_torch.optim.schedules import constant


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any, torch.Tensor], tuple]


def _schedule(lr):
    return lr if callable(lr) else constant(lr)


def _step0(params):
    """The per-client step counter: ``[B, m]`` of ``params [B, m, n]`` (or
    of ``Leaves`` ``[B, m, *shape]``)."""
    lead = first(params)
    shape = lead.shape[:2] if isinstance(params, Leaves) else lead.shape[:-1]
    return torch.zeros(shape, dtype=torch.int32, device=lead.device)


def _zeros32(params):
    return gmap(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# the update of a large buffer runs over slices of this many parameters a
# row, so that its fp32 temporaries stay small beside the model's buffers
# (each element's arithmetic is the same as in one call)
_SLICE = 1 << 26


def _sliced(fn, p, *xs):
    """``fn(p, *xs).to(p.dtype)``, over slices of the last axis where it
    is longer than ``_SLICE``."""
    n = p.shape[-1]
    if n <= _SLICE:
        return fn(p, *xs).to(p.dtype)
    out = torch.empty_like(p)
    for i in range(0, n, _SLICE):
        cols = slice(i, i + _SLICE)
        out[..., cols] = fn(p[..., cols], *(x[..., cols] for x in xs))
    return out


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        st = {"step": _step0(params)}
        if momentum:
            st["mu"] = _zeros32(params)
        return st

    def update(params, state, grads):
        eta = sched(state["step"])
        step = state["step"] + 1

        def descend(a, b):
            return a - lead_view(eta, a) * b

        if momentum:
            mu = gmap(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
            return gmap(lambda p, u: _sliced(descend, p, u), params, mu), \
                {"step": step, "mu": mu}
        return gmap(lambda p, g: _sliced(descend, p, g), params,
                    grads), {"step": step}

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros32(params),
                "v": _zeros32(params)}

    def update(params, state, grads):
        step = state["step"] + 1
        eta = sched(step)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        m = gmap(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"],
                 grads)
        v = gmap(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                 state["v"], grads)

        def step_one(p, m_, v_):
            u = ((m_ / lead_view(bc1, m_))
                 / (torch.sqrt(v_ / lead_view(bc2, v_)) + eps))
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p - lead_view(eta, p) * u).to(p.dtype)

        return gmap(step_one, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
