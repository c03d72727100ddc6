"""Kernel dispatch for the fused aggregation hot path (port of
``repro.kernels.dispatch``).

The backend follows the tensor, never a guess:

- ``"triton"`` — CUDA tensors: the hand-written kernel
  (``repro_torch.kernels.masked_agg``), always; there is no quiet fallback,
  so a kernel that cannot launch raises.
- ``"torch"`` — CPU tensors: the plain version
  (``repro_torch.kernels.ref``), which defines what the kernel computes.

Whether the engine uses the fused aggregation at all is the ``use_kernel``
knob, threaded through ``AlgorithmSpec.aggregate`` -> ``make_round_fn`` ->
``make_batched_run_rounds`` -> ``SweepSpec``; ``None`` at any of those
levels defers to :func:`use_kernel_default` (the ``REPRO_USE_KERNEL``
environment variable, default off, as in the reference).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.kernels.masked_agg import fused_masked_agg, resolve_backend
from repro_torch.kernels.ref import OP_ALL, OP_KNOWN_P, OP_MEAN

__all__ = ["BACKENDS", "FUSED_OPS", "fused_agg", "resolve_backend",
           "resolve_use_kernel", "use_kernel_default"]

BACKENDS = ("triton", "torch")

_ENV_USE_KERNEL = "REPRO_USE_KERNEL"

# Aggregation opcode per algorithm name — the branch table the fused kernel
# folds into one select. Only these (the empty-state family) are fusable;
# stateful rules (fedau/mifa/f3ast/fedpbc_m) keep the branch path.
FUSED_OPS = {
    "fedpbc": OP_MEAN,
    "fedavg": OP_MEAN,
    "fedavg_all": OP_ALL,
    "fedavg_known_p": OP_KNOWN_P,
}


def use_kernel_default() -> bool:
    """The ambient ``use_kernel`` default: ``REPRO_USE_KERNEL`` env var
    (1/true/yes/on), else False (the engine's branch path)."""
    return os.environ.get(_ENV_USE_KERNEL, "").strip().lower() in (
        "1", "true", "yes", "on")


def resolve_use_kernel(flag: Optional[bool] = None) -> bool:
    """Normalize a ``use_kernel`` knob: None defers to the env default."""
    return use_kernel_default() if flag is None else bool(flag)


def fused_agg(x: torch.Tensor, mask: torch.Tensor, op: torch.Tensor,
              prev: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Fused aggregation over the flat client buffer: ``x [B, m, n]`` (or
    ``[m, n]``) with the shapes of ``fused_masked_agg``; one kernel launch
    for the whole batch on the card (``resolve_backend``). Returns fp32
    ``[B, n]`` / ``[n]``."""
    return fused_masked_agg(x, mask, op, prev, p)
