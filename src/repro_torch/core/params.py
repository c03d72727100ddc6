"""Flat parameter buffers and their named views.

The port stores a model as one flat vector ``[..., n]`` (a whole sweep's
client models as ``[B, m, n]``) in the model's dtype (fp32 for the MLP, the
LM's ``ModelConfig.dtype``, bf16 at full width), so that local training
writes one buffer and the server update is one kernel launch over it. A
``ParamLayout`` names the leaves: each is a view into the buffer with the
reference's shape (``w1 [dim, hidden]`` stays ``[dim, hidden]``), in the
order the layout lists them.

Some leaves keep fp32 whatever the model's dtype (``ParamLayout.fp32``:
RWKV6's decay base, bonus and ``ln_x``, the MoE router, the Mamba
``dt_proj``, ``dt_bias``, ``a_log`` and ``d_skip``, the cross gate, as in
the reference). One buffer of one dtype cannot hold them, so a narrower
model with such leaves is held in two *parameter groups*
(``ParamLayout.pack``): a ``Groups`` of two flat buffers ``[..., n_0]`` in
the model's dtype and ``[..., n_1]`` in fp32, each leaf in its dtype's
buffer in layout order. Every other model (no fp32 leaf, or an fp32 model)
keeps ONE buffer, a plain tensor, as before. The round engine maps its
parameter arithmetic over the groups (``gmap``), the reference's
``jax.tree.map`` over a pytree of mixed dtypes. ``flatten`` asks for a
single buffer and refuses to round the fp32 leaves; ``tensors`` gives the
leaves one by one, each in its own dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Mapping, Tuple, Union

import numpy as np
import torch


class Groups(tuple):
    """A model's parameter groups: flat buffers ``[..., n_g]``, the model
    dtype's first, then fp32's."""


class Leaves(Groups):
    """A model held leaf by leaf, one buffer a leaf in layout order, each
    with the engine's leading axes and the leaf's own shape (``[B, m,
    *shape]`` clients, ``[B, *shape]`` server): the round of a sharded
    mesh, where a leaf's spec places its own dims and no leaf is flattened
    (``repro_torch.launch.steps``). The engine's rules broadcast their
    per-client masks over the leaf's trailing dims (``lead_view``)."""


Flat = Union[torch.Tensor, Groups]


def gmap(fn: Callable, x: Flat, *others: Flat) -> Flat:
    """``fn`` over the groups of ``x`` (and ``others``, grouped alike), or
    ``fn(x, *others)`` on a single buffer; the result is grouped as
    ``x`` (``Groups`` or ``Leaves``)."""
    if isinstance(x, Groups):
        return type(x)(fn(*parts) for parts in zip(x, *others))
    return fn(x, *others)


def lead_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v [*lead]`` against ``x [*lead, ...]``: ``v`` with trailing unit
    dims up to ``x``'s rank (a flat buffer's ``unsqueeze(-1)``)."""
    return v.reshape(tuple(v.shape) + (1,) * (x.dim() - v.dim()))


def first(x: Flat) -> torch.Tensor:
    """The first buffer (the only one of a single-buffer model): its leading
    axes, device and the model's dtype."""
    return x[0] if isinstance(x, Groups) else x


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

    def grouped(self, dtype: torch.dtype) -> bool:
        """Whether a model of ``dtype`` takes two groups: it has fp32 leaves
        and is narrower than fp32."""
        return bool(self.fp32) and dtype != torch.float32

    def groups(self) -> Tuple["ParamLayout", "ParamLayout"]:
        """The two groups' layouts: the leaves of the model's dtype, then
        the fp32 leaves, each in layout order."""
        return (ParamLayout(tuple(x for x in self.leaves
                                  if x[0] not in self.fp32)),
                ParamLayout(tuple(x for x in self.leaves if x[0] in self.fp32),
                            self.fp32))

    def sizes(self, dtype: torch.dtype) -> Tuple[int, ...]:
        """Each buffer's length in a model of ``dtype``."""
        if not self.grouped(dtype):
            return (self.size,)
        return tuple(g.size for g in self.groups())

    def _merged(self, parts) -> Dict[str, torch.Tensor]:
        """Leaves of the groups' dicts, in layout order."""
        out = {}
        for part in parts:
            out.update(part)
        return {name: out[name] for name, _ in self.leaves}

    def views(self, flat: Flat) -> Dict[str, torch.Tensor]:
        """Named views ``[..., *shape]`` into ``flat [..., n]`` or into its
        groups (no copies; gradients flow back into the buffers)."""
        if isinstance(flat, Groups):
            return self._merged(g.views(x)
                                for g, x in zip(self.groups(), flat))
        lead = flat.shape[:-1]
        return {name: flat[..., a:b].reshape(lead + tuple(shape))
                for name, shape, a, b in self.spans()}

    def unflatten(self, flat: Flat) -> Dict[str, torch.Tensor]:
        """Like :meth:`views`, but the gradient of each buffer is assembled
        in ONE buffer: autograd would otherwise give every leaf's slice a
        full-size zero gradient of ``flat`` and add them all up (for a
        bf16 LM, a few hundred passes over the whole client buffer)."""
        if isinstance(flat, Groups):
            return self._merged(g.unflatten(x)
                                for g, x in zip(self.groups(), flat))
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

    def pack(self, tree: Mapping[str, object], lead: Tuple[int, ...] = (),
             device=None, dtype=torch.float32, cast=None) -> Flat:
        """Leaves (as for :meth:`tensors`) -> the buffers of a model of
        ``dtype``: one ``[*lead, n]`` buffer (:meth:`flatten`), or, where
        :meth:`grouped`, ``Groups`` of the ``dtype`` leaves and the fp32
        leaves, the latter carried bit for bit. ``cast``: store every
        group in this dtype instead (fp32 optimizer moments)."""
        if not self.grouped(dtype):
            return self.flatten(tree, lead, device, cast or dtype)
        return Groups(g.flatten(tree, lead, device, cast or gdt)
                      for g, gdt in zip(self.groups(),
                                        (dtype, torch.float32)))


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
