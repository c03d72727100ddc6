"""Learning-rate schedules (port of ``repro.optim.schedules``).

``paper_decay`` is the paper's Appendix-B schedule
eta_t = eta_0 / sqrt(t/10 + 1). ``eta0`` is a number or a per-trajectory
``[B]`` tensor; a schedule maps the per-client step counter ``[B, m]`` to
the per-client learning rate ``[B, m]`` (float32).
"""
from __future__ import annotations

import torch


def _rows(eta0, step):
    """``eta0`` as a ``[B, 1]`` column against ``step [B, m]`` (numbers pass)."""
    if isinstance(eta0, torch.Tensor):
        return eta0.to(step.device, torch.float32).reshape(
            (-1,) + (1,) * (step.dim() - 1))
    return eta0


def constant(eta0):
    def sched(step):
        return torch.zeros(step.shape, dtype=torch.float32,
                           device=step.device) + _rows(eta0, step)
    return sched


def paper_decay(eta0, div: float = 10.0):
    def sched(step):
        t = step.to(torch.float32)
        return _rows(eta0, step) / torch.sqrt(t / div + 1.0)
    return sched
