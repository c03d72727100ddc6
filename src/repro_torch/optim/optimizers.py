"""Minimal optimizers (SGD + momentum, Adam) over the flat parameter buffer
(port of ``repro.optim.optimizers``).

``params``/``grads`` are ``[B, m, n]`` (trajectory, client, flat params) and
the state holds a per-client ``step`` counter ``[B, m]`` int32 plus the
moment buffers. The counter is carried across rounds in ``FedState``, so a
schedule decays with the client's total local steps, as in the reference.
``lr`` is a number, a ``[B]`` tensor, or a schedule ``step [B, m] -> [B, m]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.optim.schedules import constant


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any, torch.Tensor], tuple]


def _schedule(lr):
    return lr if callable(lr) else constant(lr)


def _step0(params):
    return torch.zeros(params.shape[:-1], dtype=torch.int32,
                       device=params.device)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        st = {"step": _step0(params)}
        if momentum:
            st["mu"] = torch.zeros_like(params, dtype=torch.float32)
        return st

    def update(params, state, grads):
        eta = sched(state["step"]).unsqueeze(-1)
        step = state["step"] + 1
        if momentum:
            mu = momentum * state["mu"] + grads.float()
            return (params - eta * mu).to(params.dtype), {"step": step,
                                                          "mu": mu}
        return (params - eta * grads).to(params.dtype), {"step": step}

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        return {"step": _step0(params),
                "m": torch.zeros_like(params, dtype=torch.float32),
                "v": torch.zeros_like(params, dtype=torch.float32)}

    def update(params, state, grads):
        step = state["step"] + 1
        eta = sched(step).unsqueeze(-1)
        g = grads.float()
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * torch.square(g)
        sf = step.to(torch.float32).unsqueeze(-1)
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * params.float()
        return (params - eta * u).to(params.dtype), {"step": step, "m": m,
                                                     "v": v}

    return Optimizer(init, update)
