"""Flash attention as a hand-written CUDA kernel for Hopper, forward and
backward.

Replaces ``repro/kernels/flash_attention.py``: ``flash_attention`` ->
``_kernel`` (the TPU kernel, which has no backward). The CUDA source is
``csrc/flash_attention.cu``; its header says what each kernel computes,
what bounds it and how it is laid out. Three kernels, each behind a wrapper
with its own launch counter:

- ``flash_attention_fwd``: ``o``, and the row log-sum-exp ``lse`` (fp32,
  ``[BH, Tq]``) kept for the backward;
- ``flash_attention_bwd_dq``: ``delta = rowsum(dO * O)`` and ``dQ``;
- ``flash_attention_bwd_dkdv``: ``dK`` and ``dV``.

``flash_attention(q, k, v)`` on ``[B, H, T, D]`` (the reference's entry) is
differentiable through them (``torch.autograd.Function``). ``q_offset``
selects the causal-offset route: ``q [.., Tq, D]`` against ``k, v [..,
Tk, D]`` with ``Tk = q_offset + Tq``, query ``i`` at absolute position
``q_offset + i`` (a sequence-parallel rank's chunk against the gathered
prefix of its keys, ``models.model``); ``q_offset = 0`` with ``Tq = Tk``
is self-attention, the same kernels' code instantiated with the offset
fixed at 0 (the C interface picks the instantiation). Each wrapper's
``offset_launches``
counts its launches with ``q_offset > 0`` (they count in ``launches``
too). On CPU tensors it
is the plain version (``repro_torch.kernels.ref.flash_attention_ref``); on
CUDA tensors it always launches the kernels, and a build or launch failure
raises. Any head dim from 1 to 256 (``MAX_HEAD_DIM``), fp32 or bf16, any
``T`` (ragged tiles are masked): the source instantiates ``HEAD_DIMS``, and
each wrapper zero-pads another ``D`` up to the next of them and slices its
outputs back (zero columns of q and k leave the scores unchanged, zero
columns of v only add output columns that are dropped), passing the true
``D ** -0.5`` as the score scale.

Above 256, fp32 self-attention takes the wide-head route
(``WIDE_SOURCE``, ``csrc/flash_attention_wide.cu``): three kernels behind
``flash_attention_wide_fwd``, ``flash_attention_wide_bwd_dq`` and
``flash_attention_wide_bwd_dkdv``, each with its own ``launches``, which
zero-pad ``D`` to a multiple of ``WIDE_CHUNK`` (``wide_head_dim``) and form
each score over the whole head dim in 128-column chunks;
``flash_attention`` takes it for any ``D > MAX_HEAD_DIM``. bf16 inputs and
the causal-offset route above 256 raise (``padded_head_dim``,
``flash_attention``): no path reaches them (ROADMAP Queue 3, gaps).

Build: at first launch ``nvcc`` compiles the source for the card
(``sm_90a`` on an H100) into ``build/cuda/``, a shared library with a plain
C interface loaded with ``ctypes`` (``repro_torch.kernels.build``): one for
self-attention (``SOURCE``), one for the causal-offset route
(``OFFSET_SOURCE``, the same kernels at the other instantiation) and one
for the wide-head route (``WIDE_SOURCE``), each built at its route's first
launch, or all three at once by ``build.compile_all``.
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
# the causal-offset route's library (the same kernels at OFF = true, built
# from SOURCE beside its own library; its functions flash_attention_offset_*)
OFFSET_SOURCE = SOURCE.with_name("flash_attention_offset.cu")
# the head dims the source instantiates (its BY_D switch): every published
# head dim of the repo's configs (64, 128, 256) and the LM sweep's 144
# (lm_d_model 576 over reduced()'s 4 heads)
HEAD_DIMS = (16, 32, 64, 128, 144, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
# the wide-head route's library (fp32 self-attention above MAX_HEAD_DIM;
# its functions flash_attention_wide_*), and the columns of its chunks and
# output slices: it runs a head dim zero-padded to a multiple of them
WIDE_SOURCE = SOURCE.with_name("flash_attention_wide.cu")
WIDE_CHUNK = 128

__all__ = ["HEAD_DIMS", "MAX_HEAD_DIM", "WIDE_CHUNK", "WIDE_SOURCE",
           "flash_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkdv", "flash_attention_wide_fwd",
           "flash_attention_wide_bwd_dq", "flash_attention_wide_bwd_dkdv",
           "padded_head_dim", "wide_head_dim"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (pointers..., bh, tq, tk, q_off, d, bf16, causal, window, cap, scale,
# stream)
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 5 + [_I] * 8 + [_F, _F, _P],
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 8 + [_F, _F, _P],
    "flash_attention_bwd_dkdv": [_P] * 8 + [_I] * 8 + [_F, _F, _P],
}
_OFFSET_SIGNATURES = {
    name.replace("flash_attention_", "flash_attention_offset_"): sig
    for name, sig in _SIGNATURES.items()}
# the wide-head route: (pointers..., bh, t, ld, causal, window, cap, scale,
# stream)
_WIDE_SIGNATURES = {
    "flash_attention_wide_fwd": [_P] * 5 + [_I] * 5 + [_F, _F, _P],
    "flash_attention_wide_bwd_dq": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    "flash_attention_wide_bwd_dkdv": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
}


def wide_head_dim(d: int) -> int:
    """The head dim the wide-head route runs ``d`` at: the next multiple
    of ``WIDE_CHUNK``."""
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK


def padded_head_dim(d: int, dtype: torch.dtype = torch.float32) -> int:
    """The head dim that a ``[.., D]`` input of ``dtype`` runs at: up to
    ``MAX_HEAD_DIM`` the smallest of ``HEAD_DIMS`` at least ``d``, above it
    (fp32 only) ``wide_head_dim(d)``. Raises for ``d`` below 1, and for a
    bf16 ``d`` above ``MAX_HEAD_DIM``, which no path reaches."""
    if d < 1:
        raise ValueError(f"a head dim must be at least 1, got {d}")
    if d <= MAX_HEAD_DIM:
        return next(h for h in HEAD_DIMS if h >= d)
    if dtype != torch.float32:
        raise ValueError(
            f"the flash-attention kernels take {dtype} head dims 1 to "
            f"{MAX_HEAD_DIM}, got {d}: above that only fp32 has a route "
            f"(the wide-head kernels), as no path runs a wider {dtype} "
            f"head (ROADMAP Queue 3, gaps)")
    return wide_head_dim(d)


@functools.lru_cache(maxsize=None)
def _library(offset: bool) -> ctypes.CDLL:
    """Build (once per source version and card) and load the kernels of
    self-attention or, ``offset``, of the causal-offset route."""
    if offset:
        return build.load(OFFSET_SOURCE, _OFFSET_SIGNATURES)
    return build.load(SOURCE, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _wide_library() -> ctypes.CDLL:
    """Build (once per source version and card) and load the wide-head
    route's kernels."""
    return build.load(WIDE_SOURCE, _WIDE_SIGNATURES)


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


def _check_q(q: torch.Tensor, wide: bool = False):
    """``q [BH, T, D]`` on the card: fp32 or bf16 at a head dim 1 to
    ``MAX_HEAD_DIM``, or, on the wide-head route (``wide``), fp32 at any
    head dim."""
    if not q.is_cuda:
        raise ValueError(f"the flash-attention kernels take CUDA tensors, "
                         f"got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [BH, T, D], got {tuple(q.shape)}")
    if wide:
        if q.dtype != torch.float32 or q.shape[-1] < 1:
            raise ValueError(f"the wide-head route takes fp32 head dims of "
                             f"at least 1, got {q.shape[-1]} {q.dtype}")
    elif not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(
            f"these kernels take head dims 1 to {MAX_HEAD_DIM}, got "
            f"{q.shape[-1]}: an fp32 head above takes the wide-head route "
            f"(flash_attention_wide_*)")
    elif q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be fp32 or bf16, got {q.dtype}")
    _check("q", q, q)


def _key_shape(q: torch.Tensor, k: torch.Tensor, q_offset: int) -> tuple:
    """``[BH, Tk, D]`` of the keys of ``q [BH, Tq, D]`` at ``q_offset``:
    ``Tk = q_offset + Tq`` (``k``'s own length, checked)."""
    bh, tq, d = q.shape
    if q_offset < 0 or k.dim() != 3 or k.shape[1] != q_offset + tq:
        raise ValueError(
            f"q {tuple(q.shape)} at q_offset {q_offset} takes keys "
            f"[{bh}, {q_offset + tq}, {d}], got {tuple(k.shape)}")
    return (bh, q_offset + tq, d)


def _pad(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x [.., D]`` zero-padded to ``[.., dp]`` (itself when ``D == dp``)."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor):
    """A per-row fp32 statistic ``[BH, T]`` (lse, delta)."""
    _check(name, t, q, q.shape[:-1], torch.float32)


def _launch(lib: ctypes.CDLL, name: str, *args):
    """``name`` of ``lib`` on ``args``; raises if it did not launch."""
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: "
                           + ("unsupported head dim" if err == -1
                              else f"cudaError_t {err}"))


def _call(name: str, q_offset: int, *args):
    """``name`` of the library of ``q_offset``'s route (the offset one's
    ``flash_attention_offset_*`` at ``q_offset > 0``)."""
    if q_offset:
        name = name.replace("flash_attention_", "flash_attention_offset_")
    _launch(_library(q_offset > 0), name, *args)


def _common(q: torch.Tensor, q_offset: int, dp: int, causal: bool,
            window: int, softcap: float):
    """The C interface's trailing arguments for ``q [BH, Tq, D]`` at
    ``q_offset`` (keys ``Tk = q_offset + Tq``) run at the instantiated head
    dim ``dp``, scaled by the true ``D ** -0.5``."""
    bh, t, d = q.shape
    return (bh, t, q_offset + t, int(q_offset), dp,
            int(q.dtype == torch.bfloat16), int(bool(causal)), int(window),
            float(softcap), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                        q_offset=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q [BH, Tq, D]``, ``k, v [BH, Tk, D]`` (``Tk = q_offset + Tq``) on
    the card -> ``(o [BH, Tq, D], lse [BH, Tq] fp32)``; one kernel
    launch."""
    _check_q(q)
    kshape = _key_shape(q, k, q_offset)
    _check("k", k, q, kshape)
    _check("v", v, q, kshape)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    qp, kp, vp = (_pad(x, dp) for x in (q, k, v))
    o = torch.empty_like(qp)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _call("flash_attention_fwd", q_offset, qp.data_ptr(),
              kp.data_ptr(), vp.data_ptr(), o.data_ptr(), lse.data_ptr(),
              *_common(q, q_offset, dp, causal, window, logit_softcap))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.offset_launches += int(q_offset > 0)
    return o[..., :d].contiguous() if dp != d else o, lse


def flash_attention_bwd_dq(q, k, v, o, do, lse, *, causal=True, window=0,
                           logit_softcap=0.0, q_offset=0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (dq [BH, Tq, D], delta [BH, Tq] fp32)``; one kernel
    launch."""
    _check_q(q)
    kshape = _key_shape(q, k, q_offset)
    for name, t, shape in (("k", k, kshape), ("v", v, kshape), ("o", o, None),
                           ("do", do, None)):
        _check(name, t, q, shape)
    _check_rows("lse", lse, q)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    qp, kp, vp, op, dop = (_pad(x, dp) for x in (q, k, v, o, do))
    dq = torch.empty_like(qp)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        _call("flash_attention_bwd_dq", q_offset, qp.data_ptr(),
              kp.data_ptr(), vp.data_ptr(), op.data_ptr(), dop.data_ptr(),
              lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(),
              *_common(q, q_offset, dp, causal, window, logit_softcap))
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.offset_launches += int(q_offset > 0)
    return dq[..., :d].contiguous() if dp != d else dq, delta


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True,
                             window=0, logit_softcap=0.0, q_offset=0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (dk, dv [BH, Tk, D])``; one kernel launch (after
    ``flash_attention_bwd_dq``, which writes ``delta``)."""
    _check_q(q)
    kshape = _key_shape(q, k, q_offset)
    for name, t, shape in (("k", k, kshape), ("v", v, kshape),
                           ("do", do, None)):
        _check(name, t, q, shape)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    d, dp = q.shape[-1], padded_head_dim(q.shape[-1])
    qp, kp, vp, dop = (_pad(x, dp) for x in (q, k, v, do))
    dk = torch.empty_like(kp)
    dv = torch.empty_like(vp)
    with torch.cuda.device(q.device):
        _call("flash_attention_bwd_dkdv", q_offset, qp.data_ptr(),
              kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *_common(q, q_offset, dp, causal, window, logit_softcap))
    flash_attention_bwd_dkdv.launches += 1
    flash_attention_bwd_dkdv.offset_launches += int(q_offset > 0)
    if dp != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkdv):
    _fn.launches = 0
    _fn.offset_launches = 0


def _call_wide(name: str, q: torch.Tensor, ld: int, causal: bool,
               window: int, softcap: float, *ptrs):
    """``name`` of the wide-head library on ``q [BH, T, D]`` run at the
    padded head dim ``ld``, scaled by the true ``D ** -0.5``."""
    bh, t, d = q.shape
    _launch(_wide_library(), name, *ptrs, bh, t, ld, int(bool(causal)),
            int(window), float(softcap), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_wide_fwd(q, k, v, *, causal=True, window=0,
                             logit_softcap=0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wide-head route's forward: ``q, k, v [BH, T, D]`` fp32 on the
    card -> ``(o [BH, T, D], lse [BH, T] fp32)``; one kernel launch at
    ``wide_head_dim(D)``."""
    _check_q(q, wide=True)
    for name, t in (("k", k), ("v", v)):
        _check(name, t, q)
    d, ld = q.shape[-1], wide_head_dim(q.shape[-1])
    qp, kp, vp = (_pad(x, ld) for x in (q, k, v))
    o = torch.empty_like(qp)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _call_wide("flash_attention_wide_fwd", q, ld, causal, window,
                   logit_softcap, qp.data_ptr(), kp.data_ptr(),
                   vp.data_ptr(), o.data_ptr(), lse.data_ptr())
    flash_attention_wide_fwd.launches += 1
    return o[..., :d].contiguous() if ld != d else o, lse


def flash_attention_wide_bwd_dq(q, k, v, o, do, lse, *, causal=True,
                                window=0, logit_softcap=0.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (dq [BH, T, D], delta [BH, T] fp32)``; one kernel launch."""
    _check_q(q, wide=True)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, t, q)
    _check_rows("lse", lse, q)
    d, ld = q.shape[-1], wide_head_dim(q.shape[-1])
    qp, kp, vp, op, dop = (_pad(x, ld) for x in (q, k, v, o, do))
    dq = torch.empty_like(qp)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        _call_wide("flash_attention_wide_bwd_dq", q, ld, causal, window,
                   logit_softcap, qp.data_ptr(), kp.data_ptr(),
                   vp.data_ptr(), op.data_ptr(), dop.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    flash_attention_wide_bwd_dq.launches += 1
    return dq[..., :d].contiguous() if ld != d else dq, delta


def flash_attention_wide_bwd_dkdv(q, k, v, do, lse, delta, *, causal=True,
                                  window=0, logit_softcap=0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-> (dk, dv [BH, T, D])``; one kernel launch (after
    ``flash_attention_wide_bwd_dq``, which writes ``delta``)."""
    _check_q(q, wide=True)
    for name, t in (("k", k), ("v", v), ("do", do)):
        _check(name, t, q)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    d, ld = q.shape[-1], wide_head_dim(q.shape[-1])
    qp, kp, vp, dop = (_pad(x, ld) for x in (q, k, v, do))
    dk = torch.empty_like(kp)
    dv = torch.empty_like(vp)
    with torch.cuda.device(q.device):
        _call_wide("flash_attention_wide_bwd_dkdv", q, ld, causal, window,
                   logit_softcap, qp.data_ptr(), kp.data_ptr(),
                   vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    flash_attention_wide_bwd_dkdv.launches += 1
    if ld != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


for _fn in (flash_attention_wide_fwd, flash_attention_wide_bwd_dq,
            flash_attention_wide_bwd_dkdv):
    _fn.launches = 0

# each route's (forward, dq, dkdv) by name, looked up at each call, so that
# a wrapper that stands in for one on this module (a tally of launches by
# shape) is the one run
_ALIGNED = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv")
_WIDE = tuple(n.replace("attention_", "attention_wide_") for n in _ALIGNED)


class _FlashAttention(torch.autograd.Function):
    """A route's kernels (``fns``: ``_ALIGNED`` or ``_WIDE``) as one
    differentiable op on ``[BH, Tq, D]`` against ``[BH, Tk, D]``, with
    the route's keywords ``kw`` (the mask, and the aligned route's
    ``q_offset``)."""

    @staticmethod
    def forward(ctx, q, k, v, fns, kw):
        o, lse = globals()[fns[0]](q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.fns, ctx.kw = fns, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd_dq, bwd_dkdv = (globals()[n] for n in ctx.fns[1:])
        do = do.contiguous()
        dq, delta = bwd_dq(q, k, v, o, do, lse, **ctx.kw)
        dk, dv = bwd_dkdv(q, k, v, do, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, q_offset: int = 0
                    ) -> torch.Tensor:
    """``q [B, H, Tq, D]``, ``k, v [B, H, Tk, D]`` with ``Tk = q_offset +
    Tq`` (same head count; GQA is repeated by the caller) -> ``[B, H, Tq,
    D]`` in ``q.dtype``. CUDA tensors: one forward launch over ``[B*H, Tq,
    D]`` (and two backward launches under autograd), through the
    wide-head route where ``D > MAX_HEAD_DIM`` (fp32 self-attention only:
    bf16 or an offset there raises, naming the gap); CPU tensors: the
    plain version."""
    if resolve_backend(q) == "torch":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap,
                                   q_offset=q_offset)
    b, h, t, d = q.shape
    tk = k.shape[2]
    qf = q.reshape(b * h, t, d).contiguous()
    kf, vf = (x.reshape(b * h, tk, d).contiguous() for x in (k, v))
    kw = dict(causal=bool(causal), window=int(window),
              logit_softcap=float(logit_softcap))
    if d > MAX_HEAD_DIM:
        padded_head_dim(d, q.dtype)         # raises for bf16, naming the gap
        if q_offset:
            raise ValueError(
                f"the causal-offset route takes head dims 1 to "
                f"{MAX_HEAD_DIM}, got {d}: only the sequence split launches "
                f"it, and no path splits a wider head (ROADMAP Queue 3, "
                f"gaps)")
        out = _FlashAttention.apply(qf, kf, vf, _WIDE, kw)
    else:
        out = _FlashAttention.apply(qf, kf, vf, _ALIGNED,
                                    dict(kw, q_offset=int(q_offset)))
    return out.view(b, h, t, d)
