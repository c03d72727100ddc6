"""Fixed draws as tensors, without JAX: the port's drawer interface
(``params`` / ``link_init`` / call, and the re-packing ``copy`` / ``take``
/ ``select`` / ``concat``) over ``[B, ...]`` tensors of a run's initial
models, initial link uniforms and per-round link uniforms and batch
indices. ``_torch_parity.JaxKeyDraws`` fills one from the reference's keys;
a sharded run's workers unpickle its slices without importing JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import federated as tfed


class TensorDraws:
    def __init__(self, params, init_u, u, pick):
        self._params, self._init_u, self._u, self._pick = \
            params, init_u, u, pick

    def params(self, init_params):
        return self._params

    def link_init(self):
        return self._init_u

    def __call__(self, t):
        if isinstance(t, torch.Tensor):
            rows = torch.arange(self._u.shape[0])
            return tfed.RoundDraws(self._u[rows, t.cpu()],
                                   self._pick[rows, t.cpu()])
        return tfed.RoundDraws(self._u[:, t], self._pick[:, t])

    def copy(self):
        return self

    def take(self, rows):
        r = torch.as_tensor(np.asarray(rows, np.int64))
        return TensorDraws(self._params[r], self._init_u[r], self._u[r],
                           self._pick[r])

    def select(self, mask, other):
        keep = torch.as_tensor(np.asarray(mask, bool))

        def pick(a, b):
            return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)),
                               a, b)

        return TensorDraws(pick(self._params, other._params),
                           pick(self._init_u, other._init_u),
                           pick(self._u, other._u),
                           pick(self._pick, other._pick))

    @staticmethod
    def concat(drawers):
        return TensorDraws(*(torch.cat([getattr(d, a) for d in drawers])
                             for a in ("_params", "_init_u", "_u", "_pick")))
