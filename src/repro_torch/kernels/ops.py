"""Public wrappers over the port's kernels (port of ``repro.kernels.ops``).

``masked_agg_pytree`` runs the aggregation kernel once per leaf of a dict of
``[m, ...]`` client-stacked tensors; ``gqa_flash_attention`` runs the flash
kernels on ``[B, T, H, D]`` queries against ``[B, T, KV, D]`` keys and
values. Both follow the tensor (``dispatch.resolve_backend``): the kernel
for CUDA tensors, with no quiet fallback, and the plain version for CPU
tensors. The re-exports are those of the reference's ``__all__`` that the
port has (no ``interpret=`` argument: a Pallas notion); the reference's
``fused_agg_pytree`` and ``resolve_attention_backend`` have no counterpart
(the engine aggregates one flat buffer, and the attention backend follows
the tensor).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.kernels.dispatch import (
    FUSED_OPS,
    attention,
    fused_agg,
    resolve_backend,
    resolve_use_kernel,
    use_kernel_default,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.masked_agg import (
    OP_ALL,
    OP_KNOWN_P,
    OP_MEAN,
    fused_masked_agg,
    masked_agg,
)
from repro_torch.kernels.ref import (
    flash_attention_ref,
    fused_masked_agg_ref,
    masked_agg_ref,
    rwkv6_chunk_ref,
)
from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk


def masked_agg_pytree(clients: Mapping, mask: torch.Tensor,
                      prev: Optional[Mapping] = None) -> dict:
    """FedPBC's aggregation over a dict (nested dicts allowed) of ``[m,
    ...]`` client-stacked tensors: one ``masked_agg`` per flattened leaf,
    each result ``[...]`` in its leaf's dtype. ``prev`` (a dict of the
    server's leaves) folds the empty-active-set guard into the kernel: a
    round with no active client returns ``prev`` unchanged instead of a
    zeroed model."""
    def leaf(x, pv):
        flat = x.reshape(x.shape[0], -1)
        pflat = None if pv is None else pv.reshape(-1).float()
        return masked_agg(flat, mask, pflat).reshape(x.shape[1:]).to(x.dtype)

    def walk(c, p):
        if isinstance(c, Mapping):
            return {k: walk(c[k], None if p is None else p[k]) for k in c}
        return leaf(c, p)

    return walk(clients, prev)


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0) -> torch.Tensor:
    """``q [B, T, H, D]``; ``k, v [B, T, KV, D]`` (GQA: ``H`` a multiple of
    ``KV``) -> ``[B, T, H, D]``: each KV head repeated for its ``H // KV``
    query heads, then ``flash_attention`` on ``[B, H, T, D]``."""
    rep = q.shape[2] // k.shape[2]
    kt = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    o = flash_attention(q.transpose(1, 2), kt, vt, causal=causal,
                        window=window, logit_softcap=logit_softcap)
    return o.transpose(1, 2)


__all__ = [
    "masked_agg",
    "masked_agg_pytree",
    "masked_agg_ref",
    "fused_masked_agg",
    "fused_masked_agg_ref",
    "fused_agg",
    "FUSED_OPS",
    "OP_MEAN",
    "OP_ALL",
    "OP_KNOWN_P",
    "resolve_backend",
    "resolve_use_kernel",
    "use_kernel_default",
    "attention",
    "flash_attention",
    "flash_attention_ref",
    "gqa_flash_attention",
    "rwkv6_chunk",
    "rwkv6_chunk_ref",
]
