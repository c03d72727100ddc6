"""Flash attention as a hand-written CUDA kernel for Hopper, forward and
backward.

Replaces ``repro/kernels/flash_attention.py``: ``flash_attention`` ->
``_kernel`` (the TPU kernel, which has no backward). The CUDA source is
``csrc/flash_attention.cu``; its header says what each kernel computes,
what bounds it and how it is laid out. Three kernels, each behind a wrapper
with its own launch counter:

- ``flash_attention_fwd``: ``o``, and the row log-sum-exp ``lse`` (fp32,
  ``[BH, T]``) kept for the backward;
- ``flash_attention_bwd_dq``: ``delta = rowsum(dO * O)`` and ``dQ``;
- ``flash_attention_bwd_dkdv``: ``dK`` and ``dV``.

``flash_attention(q, k, v)`` on ``[B, H, T, D]`` (the reference's entry) is
differentiable through them (``torch.autograd.Function``). On CPU tensors it
is the plain version (``repro_torch.kernels.ref.flash_attention_ref``); on
CUDA tensors it always launches the kernels, and a build or launch failure
raises. Any head dim from 1 to 256 (``MAX_HEAD_DIM``), fp32 or bf16, any
``T`` (ragged tiles are masked): the source instantiates ``HEAD_DIMS``, and
each wrapper zero-pads another ``D`` up to the next of them and slices its
outputs back (zero columns of q and k leave the scores unchanged, zero
columns of v only add output columns that are dropped), passing the true
``D ** -0.5`` as the score scale.

Build: at first launch ``nvcc`` compiles the source for the card
(``sm_90a`` on an H100) into ``build/cuda/``, a shared library with a plain
C interface loaded with ``ctypes`` (``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# the head dims the source instantiates (its BY_D switch): every published
# head dim of the repo's configs (64, 128, 256) and the LM sweep's 144
# (lm_d_model 576 over reduced()'s 4 heads)
HEAD_DIMS = (16, 32, 64, 128, 144, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]

__all__ = ["HEAD_DIMS", "MAX_HEAD_DIM", "flash_attention",
           "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkdv", "padded_head_dim"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (..., cap, scale, stream)
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_F, _F, _P],
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    "flash_attention_bwd_dkdv": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
}


def padded_head_dim(d: int) -> int:
    """The instantiated head dim that a ``[.., D]`` input runs at: the
    smallest of ``HEAD_DIMS`` at least ``d``; raises above
    ``MAX_HEAD_DIM``."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"the flash-attention kernels take head dims 1 to "
            f"{MAX_HEAD_DIM}, got {d}: a larger D needs tiles that split "
            f"the head dim (ROADMAP Queue 3)")
    return next(h for h in HEAD_DIMS if h >= d)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source version and card) and load the kernels."""
    return build.load(SOURCE, _SIGNATURES)


def _check(name: str, t: torch.Tensor, q: torch.Tensor, shape=None,
           dtype=None):
    """``t`` must have ``shape`` and ``dtype`` (default: ``q``'s), lie on
    ``q``'s card, and be contiguous and 16-byte aligned."""
    shape = tuple(q.shape if shape is None else shape)
    dtype = q.dtype if dtype is None else dtype
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{shape} {dtype}")
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_q(q: torch.Tensor):
    if not q.is_cuda:
        raise ValueError(f"the flash-attention kernels take CUDA tensors, "
                         f"got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [BH, T, D], got {tuple(q.shape)}")
    padded_head_dim(q.shape[-1])
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be fp32 or bf16, got {q.dtype}")
    _check("q", q, q)


def _pad(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x [.., D]`` zero-padded to ``[.., dp]`` (itself when ``D == dp``)."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor):
    """A per-row fp32 statistic ``[BH, T]`` (lse, delta)."""
    _check(name, t, q, q.shape[:-1], torch.float32)


def _call(name: str, *args):
    err = getattr(_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: "
                           + ("unsupported head dim" if err == -1
                              else f"cudaError_t {err}"))


def _common(q: torch.Tensor, dp: int, causal: bool, window: int,
            softcap: float):
    """The C interface's trailing arguments for ``q [BH, T, D]`` run at
    the instantiated head dim ``dp``, scaled by the true ``D ** -0.5``."""
    bh, t, d = q.shape
    return (bh, t, dp, int(q.dtype == torch.bfloat16), int(bool(causal)),
            int(window), float(softcap), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, logit_softcap=0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q, k, v [BH, T, D]`` on the card -> ``(o [BH, T, D], lse [BH, T]
    fp32)``; one kernel launch."""
    _check_q(q)
    _check("k", k, q)
    _check("v", v, q)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    qp, kp, vp = (_pad(x, dp) for x in (q, k, v))
    o = torch.empty_like(qp)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_attention_fwd", qp.data_ptr(), kp.data_ptr(),
              vp.data_ptr(), o.data_ptr(), lse.data_ptr(),
              *_common(q, dp, causal, window, logit_softcap))
    flash_attention_fwd.launches += 1
    return o[..., :d].contiguous() if dp != d else o, lse


def flash_attention_bwd_dq(q, k, v, o, do, lse, *, causal=True, window=0,
                           logit_softcap=0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (dq [BH, T, D], delta [BH, T] fp32)``; one kernel launch."""
    _check_q(q)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, t, q)
    _check_rows("lse", lse, q)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    qp, kp, vp, op, dop = (_pad(x, dp) for x in (q, k, v, o, do))
    dq = torch.empty_like(qp)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        _call("flash_attention_bwd_dq", qp.data_ptr(), kp.data_ptr(),
              vp.data_ptr(), op.data_ptr(), dop.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(),
              *_common(q, dp, causal, window, logit_softcap))
    flash_attention_bwd_dq.launches += 1
    return dq[..., :d].contiguous() if dp != d else dq, delta


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True,
                             window=0, logit_softcap=0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (dk, dv [BH, T, D])``; one kernel launch (after
    ``flash_attention_bwd_dq``, which writes ``delta``)."""
    _check_q(q)
    for name, t in (("k", k), ("v", v), ("do", do)):
        _check(name, t, q)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    qp, kp, vp, dop = (_pad(x, dp) for x in (q, k, v, do))
    dk = torch.empty_like(kp)
    dv = torch.empty_like(vp)
    with torch.cuda.device(q.device):
        _call("flash_attention_bwd_dkdv", qp.data_ptr(), kp.data_ptr(),
              vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *_common(q, dp, causal, window, logit_softcap))
    flash_attention_bwd_dkdv.launches += 1
    if dp != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkdv):
    _fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op on ``[BH, T, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     logit_softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        kw = dict(causal=causal, window=window, logit_softcap=softcap)
        do = do.contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """``q, k, v [B, H, T, D]`` (same head count; GQA is repeated by the
    caller) -> ``[B, H, T, D]`` in ``q.dtype``. CUDA tensors: one forward
    launch over ``[B*H, T, D]`` (and two backward launches under
    autograd); CPU tensors: the plain version."""
    if resolve_backend(q) == "torch":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap)
    b, h, t, d = q.shape
    flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v)]
    out = _FlashAttention.apply(*flat, bool(causal), int(window),
                                float(logit_softcap))
    return out.view(b, h, t, d)
