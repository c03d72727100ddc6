"""Kernel dispatch for the fused aggregation, attention and the WKV6
recurrence (port of ``repro.kernels.dispatch``).

The backend follows the tensor, never a guess (:func:`resolve_backend`,
the one rule every kernel wrapper uses):

- ``"kernel"`` — CUDA tensors: the hand-written kernel, always (Triton in
  ``repro_torch.kernels.masked_agg``, CUDA C++ behind
  ``repro_torch.kernels.flash_attention`` and
  ``repro_torch.kernels.rwkv6_chunk``); there is no quiet fallback, so a
  kernel that cannot launch raises.
- ``"torch"`` — CPU tensors: the plain version
  (``repro_torch.kernels.ref``, ``repro_torch.models.attention``), which
  defines what the kernel computes.

Attention and the WKV6 recurrence take the plain version on the card only
when their caller passes ``backend="torch"`` (the kernel-vs-plain
comparisons do); no environment variable selects it.

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

from repro_torch.kernels.ref import OP_ALL, OP_KNOWN_P, OP_MEAN

__all__ = ["BACKENDS", "FUSED_OPS", "attention", "flash_shape_ok",
           "fused_agg", "resolve_backend", "resolve_use_kernel",
           "use_kernel_default", "wkv6"]

BACKENDS = ("kernel", "torch")

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


def resolve_backend(x: torch.Tensor) -> str:
    """``"kernel"`` for a CUDA tensor, ``"torch"`` (the plain version) for a
    CPU tensor; any other device raises."""
    if x.is_cuda:
        return "kernel"
    if x.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel backend for tensors on {x.device}")


def _backend(backend: Optional[str], x: torch.Tensor, what: str) -> str:
    """An explicit ``backend`` argument checked, or ``None`` resolved from
    the tensor (:func:`resolve_backend`)."""
    if backend is None:
        return resolve_backend(x)
    if backend not in BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}; available: "
                         f"{BACKENDS}")
    if backend == "kernel" and not x.is_cuda:
        raise ValueError(f"the {what} kernel takes CUDA tensors, got "
                         f"{x.device}")
    return backend


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
    from repro_torch.kernels.masked_agg import fused_masked_agg

    return fused_masked_agg(x, mask, op, prev, p)


def flash_shape_ok(kind: str, tq: int, tk: int, q_offset: int) -> bool:
    """Whether the flash kernels cover an attention call: ``kind`` full or
    swa, queries at ``q_offset`` against every key up to their last
    (``tk == q_offset + tq``: self-attention at ``q_offset == 0``, else the
    causal-offset route of a sequence-parallel rank's chunk), and ``t %
    min(128, t) == 0`` for ``t`` in ``tq`` and ``tk``."""
    return (kind in ("full", "swa") and q_offset >= 0
            and tk == q_offset + tq
            and all(t % min(128, t) == 0 for t in (tq, tk)))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kind: str = "full", window: int = 4096,
              logit_softcap: float = 0.0, chunk: int = 1024,
              q_offset: int = 0, backend: Optional[str] = None
              ) -> torch.Tensor:
    """Dispatched causal attention in the model stack's ``[B, T, H, D]``
    layout (``repro_torch.models.attention.attention``'s signature; that
    entry routes here).

    The kernel covers the reference's kernel shapes
    (:func:`flash_shape_ok`). Every other shape (block-local "chunked"
    masks, decode-style offsets with fewer keys, ragged lengths) takes the
    plain chunked version on any device, as in the reference; so do CPU
    tensors. Each call that takes the plain version adds one to
    ``plain_attention_calls`` (a run on the card can show that none
    did).
    ``backend``: ``None`` follows the tensor (:func:`resolve_backend`);
    ``"torch"`` takes the plain version on the card too (to compare the two
    paths); ``"kernel"`` insists on the kernel and raises for CPU tensors.
    On CUDA tensors the kernel path repeats GQA's KV heads, folds ``[B, H]``
    into the kernel's batch axis and makes one forward launch (two backward
    launches under autograd); autograd sums the KV gradient over the
    repeats. The head dim takes no part in the shape test: up to 256 the
    flash kernels take it, above 256 fp32 self-attention takes their
    wide-head route and anything else raises (``flash_attention``).
    """
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as ref

    backend = _backend(backend, q, "attention")
    if not flash_shape_ok(kind, q.shape[1], k.shape[1], q_offset) \
            or backend == "torch":
        global plain_attention_calls
        plain_attention_calls += 1
        return ref.attention_ref(q, k, v, kind=kind, window=window,
                                 logit_softcap=logit_softcap, chunk=chunk,
                                 q_offset=q_offset)
    n_rep = q.shape[2] // k.shape[2]
    kr = ref.repeat_kv(k, n_rep).transpose(1, 2)
    vr = ref.repeat_kv(v, n_rep).transpose(1, 2)
    out = fa.flash_attention(q.transpose(1, 2), kr, vr, causal=True,
                             window=window if kind == "swa" else 0,
                             logit_softcap=logit_softcap, q_offset=q_offset)
    return out.transpose(1, 2)


# calls of attention() that took the plain version, on any device
plain_attention_calls = 0


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
         backend: Optional[str] = None):
    """Dispatched WKV6 recurrence in the kernel's layout: ``r, k, v, w
    [B, H, T, D]`` fp32, ``u [H, D]``, ``s0 [B, H, D, D]`` -> ``(o
    [B, H, T, D], S_T [B, H, D, D])``.

    ``backend``: ``None`` follows the tensor (:func:`resolve_backend`: the
    CUDA kernels for CUDA tensors, the plain chunked version for CPU
    tensors); ``"torch"`` takes the plain version on the card too, under
    autograd as well (to compare the two paths); ``"kernel"`` insists on
    the kernels. On CUDA tensors a call under autograd (grad enabled and an
    input that requires grad) takes ``rwkv6_chunk_autograd``: the chunked
    forward and, in the backward, the two backward kernels; any other call
    takes ``rwkv6_chunk``, one forward route by T. All walk chunks of
    ``rwkv6_chunk.CHUNK`` steps; a head dim below 64, or between 64 and
    128, takes the kernels' zero-padded route, one above 128 their block
    route. Each call that takes the plain version adds one to
    ``plain_wkv6_calls``.
    """
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_chunk as rk

    if _backend(backend, r, "wkv6") == "torch":
        global plain_wkv6_calls
        plain_wkv6_calls += 1
        return ref.rwkv6_chunk_plain(r, k, v, w, u, s0, chunk=rk.CHUNK)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, w, u, s0)):
        return rk.rwkv6_chunk_autograd(r, k, v, w, u, s0)
    return rk.rwkv6_chunk(r, k, v, w, u, s0)


# calls of wkv6() that took the plain version, on any device
plain_wkv6_calls = 0
