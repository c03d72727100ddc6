"""Flat parameter buffers and their named views.

The port stores a model as one flat vector ``[..., n]`` (a whole sweep's
client models as ``[B, m, n]``) in the model's dtype (fp32 for the MLP, the
LM's ``ModelConfig.dtype``, bf16 at full width), so that local training
writes one buffer and the server update is one kernel launch over it. A
``ParamLayout`` names the leaves: each is a view into the buffer with the
reference's shape (``w1 [dim, hidden]`` stays ``[dim, hidden]``), in the
order the layout lists them.

Some leaves keep fp32 whatever the model's dtype (``ParamLayout.fp32``:
RWKV6's decay base, bonus and ``ln_x``, as in the reference). One buffer of
one dtype cannot hold them, so such a model is held leaf by leaf
(``ParamLayout.tensors``: a dict of named tensors, each in its own dtype);
``flatten`` refuses to round them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Mapping, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamLayout:
    leaves: Tuple[Tuple[str, Tuple[int, ...]], ...]   # (name, shape) in order
    fp32: FrozenSet[str] = frozenset()   # leaves kept in fp32 in any model

    def dtype_of(self, name: str, dtype: torch.dtype) -> torch.dtype:
        """A leaf's dtype in a model of ``dtype``."""
        return torch.float32 if name in self.fp32 else dtype

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

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Like :meth:`views`, but the gradient of ``flat`` is assembled in
        ONE buffer: autograd would otherwise give every leaf's slice a
        full-size zero gradient of ``flat`` and add them all up (for a
        bf16 LM, a few hundred passes over the whole client buffer)."""
        if not flat.requires_grad:
            return self.views(flat)
        return dict(zip([name for name, _ in self.leaves],
                        _Unflatten.apply(flat, self)))

    def tensors(self, tree: Mapping[str, object], lead: Tuple[int, ...] = (),
                device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Leaves (numpy, bf16 numpy included, or tensors, each
        ``[*lead, *shape]``) -> named tensors in layout order, each in its
        dtype (``dtype``, or fp32 for the ``fp32`` leaves)."""
        out = {}
        for name, shape in self.leaves:
            leaf = tree[name]
            if not isinstance(leaf, torch.Tensor):
                leaf = np.asarray(leaf)
                if leaf.dtype.name == "bfloat16":    # exact in fp32
                    leaf = leaf.astype(np.float32)
                leaf = torch.from_numpy(np.array(leaf))
            if tuple(leaf.shape) != tuple(lead) + tuple(shape):
                raise ValueError(f"leaf {name!r}: shape {tuple(leaf.shape)}, "
                                 f"expected {tuple(lead) + tuple(shape)}")
            out[name] = leaf.to(device=device,
                                dtype=self.dtype_of(name, dtype))
        return out

    def flatten(self, tree: Mapping[str, object], lead: Tuple[int, ...] = (),
                device=None, dtype=torch.float32) -> torch.Tensor:
        """Leaves (as for :meth:`tensors`) -> one contiguous ``[*lead, n]``
        buffer of ``dtype``, in layout order. Raises where that would round
        an ``fp32`` leaf."""
        if self.fp32 and dtype != torch.float32:
            raise ValueError(f"a {dtype} buffer would round the fp32 leaves "
                             f"{sorted(self.fp32)}; hold the model leaf by "
                             "leaf (ParamLayout.tensors)")
        parts = [leaf.reshape(tuple(lead) + (-1,)) for leaf in
                 self.tensors(tree, lead, dtype=dtype).values()]
        return torch.cat(parts, -1).contiguous().to(device)


class _Unflatten(torch.autograd.Function):
    """``flat [..., n]`` -> its leaves as views; the backward writes each
    leaf's gradient into its span of one ``[..., n]`` buffer."""

    @staticmethod
    def forward(ctx, flat, layout):
        ctx.layout = layout
        ctx.shape, ctx.dtype, ctx.device = flat.shape, flat.dtype, flat.device
        return tuple(layout.views(flat).values())

    @staticmethod
    def backward(ctx, *grads):
        out = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        for (_, _, a, b), g in zip(ctx.layout.spans(), grads):
            if g is None:
                out[..., a:b].zero_()
            else:
                out[..., a:b].copy_(g.reshape(ctx.shape[:-1] + (b - a,)))
        return out, None
