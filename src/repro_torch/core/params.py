"""Flat parameter buffers and their named views.

The port stores a model as one flat fp32 vector ``[..., n]`` (a whole
sweep's client models as ``[B, m, n]``) so that local training writes one
buffer and the server update is one kernel launch over it. A
``ParamLayout`` names the leaves: each is a view into the buffer with the
reference's shape (``w1 [dim, hidden]`` stays ``[dim, hidden]``), in the
order the layout lists them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamLayout:
    leaves: Tuple[Tuple[str, Tuple[int, ...]], ...]   # (name, shape) in order

    @property
    def size(self) -> int:
        return sum(int(np.prod(s)) for _, s in self.leaves)

    def spans(self):
        """``(name, shape, start, stop)`` of every leaf in the flat vector."""
        off = 0
        for name, shape in self.leaves:
            k = int(np.prod(shape))
            yield name, shape, off, off + k
            off += k

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Named views ``[..., *shape]`` into ``flat [..., n]`` (no copies;
        gradients flow back into ``flat``)."""
        lead = flat.shape[:-1]
        return {name: flat[..., a:b].reshape(lead + tuple(shape))
                for name, shape, a, b in self.spans()}

    def flatten(self, tree: Mapping[str, object], lead: Tuple[int, ...] = (),
                device=None) -> torch.Tensor:
        """Leaves (numpy or tensors, each ``[*lead, *shape]``) -> one
        contiguous fp32 ``[*lead, n]`` buffer, in layout order."""
        parts = []
        for name, shape, _, _ in self.spans():
            leaf = tree[name]
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.array(leaf))
            if tuple(leaf.shape) != tuple(lead) + tuple(shape):
                raise ValueError(f"leaf {name!r}: shape {tuple(leaf.shape)}, "
                                 f"expected {tuple(lead) + tuple(shape)}")
            parts.append(leaf.reshape(tuple(lead) + (-1,)).float())
        return torch.cat(parts, -1).contiguous().to(device)
