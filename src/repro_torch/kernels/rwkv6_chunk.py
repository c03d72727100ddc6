"""The WKV6 recurrence as hand-written CUDA kernels for Hopper: a
chunk-parallel forward on the tensor cores for prefill and training, a step
forward for decode, and the chunked forward's backward.

Replaces ``repro/kernels/rwkv6_chunk.py``: ``rwkv6_chunk`` -> ``_kernel``
(the TPU kernel, which is forward only; the reference trains through the
autodiff of its jnp chunk scan). The CUDA sources are
``csrc/rwkv6_chunk.cu`` (forward) and ``csrc/rwkv6_chunk_bwd.cu``
(backward); their headers say what the kernels compute, how they avoid the
TPU kernel's fp32 overflow at strong decay, what bounds them and how they
are laid out.

``rwkv6_chunk(r, k, v, w, u, s0)`` on ``[B, H, T, D]`` fp32 (the
reference's entry) returns ``(o [B, H, T, D], S_T [B, H, D, D])``. On CPU
tensors it is the plain version (``repro_torch.kernels.ref.
rwkv6_chunk_plain``). On CUDA tensors it always launches a kernel route,
and a build or launch failure raises. The route follows T (``route_for``):
``T <= STEP_MAX_T`` takes ``"step"`` (one CUDA launch, ``wkv6_step``), a
longer T ``"chunked"`` (two CUDA launches, ``wkv6_state`` then
``wkv6_output``, over a ``[B * H, ceil(T / CHUNK), D, D]`` fp32 workspace
allocated here with ``torch.empty``: the state entering each chunk). Either
route takes any ``T >= 1``; ``route=`` forces one. Each call counts one in
``rwkv6_chunk.launches`` and one in ``rwkv6_chunk.launches_by_route[route]``,
whatever the number of CUDA launches. The kernels are built for head dims
64 and 128 (``HEAD_DIMS``); a smaller ``D`` takes the zero-padded route
(``padded_head_dim``, ``pad_inputs``): ``r``, ``k``, ``v``, ``u`` padded
with zeros and ``w`` with ones to the next head dim the kernels take,
``s0`` with zero rows and columns, and ``o`` and ``S_T`` sliced back to
``D``. That is exact: a zero ``k`` column keeps its state row at zero
whatever ``w`` is, a zero ``v`` column gives a zero output column, and a
zero ``r`` column reads nothing. Under autograd the pads' own backward
slices every gradient back to ``D``. Each padded call also counts one in
``rwkv6_chunk.padded_launches["forward"]`` (its backward in
``["backward"]``).

A ``D`` above 128 takes the block route (``fold_blocks``): every state
element ``S[i, j]`` follows its own recurrence ``S <- w[i] S + k[i] v[j]``,
and ``o[t, j]`` sums over the key channels ``i`` terms of channel ``i``
alone (the state read, the intra-chunk scores, the bonus). So with ``D``
zero-padded (the pad route's rules) to ``n`` blocks of ``BLOCK_DIM``, the
call is ``n * n`` calls at ``BLOCK_DIM``, one for each (key block, value
block) pair: ``r``, ``k``, ``w``, ``u`` of the key block, ``v`` of the
value block, ``s0``'s block of the pair. They are folded into the head
axis and run as one call of the kernels; ``o`` sums over the key blocks
and ``S_T``'s blocks are the pairs' own. Under autograd the fold's own
backward sums ``dr``, ``dk``, ``dw``, ``du`` over the value blocks and
``dv`` over the key blocks. Each blocked call also counts one in
``rwkv6_chunk.blocked_launches["forward"]`` (its backward in
``["backward"]``); ``padded_head_dim`` then raises only for ``D < 1``.

``rwkv6_chunk_autograd`` is the same function under autograd: on CUDA
tensors its forward is the chunked route whatever T is, and it keeps the
workspace; its backward (``rwkv6_chunk_backward``, two CUDA launches,
``wkv6_bwd_state`` then ``wkv6_bwd_chunk``) reads the chunk-start states
from it instead of recomputing them and returns the gradients of all six
inputs. Each backward counts one in ``launches_by_route["backward"]``. On
CPU tensors it is the plain version under autograd.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.ref import rwkv6_chunk_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_chunk.cu"
BWD_SOURCE = SOURCE.with_name("rwkv6_chunk_bwd.cu")
HEAD_DIMS = (64, 128)
CHUNK = 64
# the block route's block size: 128 folds a quarter of 64's pairs, reads
# r, k, w half as often and does half the intra-chunk work;
# scripts/wkv6_block_dim.py times both on the card (PERF.md section 6)
BLOCK_DIM = 128
# the longest T that takes the step route: at [8, 40, T, 64] on an H100 the
# step route took 0.0196 ms at T = 8 against the chunked route's 0.0296, and
# 0.0358 against 0.0299 at T = 16 (chip_smoke.py phase 7 times both)
STEP_MAX_T = 8
ROUTES = ("chunked", "step")

__all__ = ["BLOCK_DIM", "BWD_KERNELS", "CHUNK", "COUNTED", "HEAD_DIMS",
           "KERNELS", "ROUTES", "STEP_MAX_T", "fold_blocks", "pad_inputs",
           "padded_head_dim", "reset_counts", "route_for", "rwkv6_chunk",
           "rwkv6_chunk_autograd", "rwkv6_chunk_backward", "shared_bytes"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# chunked: r, k, v, w, u, s0, o, s_out, workspace; step: without it
_SIGNATURES = {"rwkv6_chunk_fwd": [_P] * 9 + [_I] * 4 + [_P],
               "rwkv6_step_fwd": [_P] * 8 + [_I] * 4 + [_P],
               "rwkv6_shared_bytes": [_I, _I]}
# the kernels, in the order of rwkv6_shared_bytes's first argument
KERNELS = ("wkv6_state", "wkv6_output", "wkv6_step")
# backward: r, k, v, w, u, ws, do, dS_T, dws, dr, dk, dv, dw, du partials,
# ds0
_BWD_SIGNATURES = {"rwkv6_chunk_bwd": [_P] * 15 + [_I] * 4 + [_P],
                   "rwkv6_bwd_shared_bytes": [_I, _I]}
# the backward's kernels, in the order of rwkv6_bwd_shared_bytes's first
# argument
BWD_KERNELS = ("wkv6_bwd_state", "wkv6_bwd_chunk")
# the keys of launches_by_route: the forward routes, then the backward
COUNTED = ROUTES + ("backward",)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source version and card) and load the kernel."""
    return build.load(SOURCE, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """Build (once per source version and card) and load the backward."""
    return build.load(BWD_SOURCE, _BWD_SIGNATURES)


def _check(name: str, t: torch.Tensor, r: torch.Tensor, shape):
    """``t`` must be fp32 of ``shape`` on ``r``'s card, contiguous and
    16-byte aligned."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} torch.float32")
    if t.device != r.device:
        raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def shared_bytes(kernel: str, d: int) -> int:
    """The dynamic shared memory of ``kernel`` (one of ``KERNELS`` or
    ``BWD_KERNELS``) at head dim ``d``, from the built library."""
    if kernel in BWD_KERNELS:
        return _bwd_library().rwkv6_bwd_shared_bytes(
            BWD_KERNELS.index(kernel), d)
    return _library().rwkv6_shared_bytes(KERNELS.index(kernel), d)


def route_for(t_len: int) -> str:
    """The route a sequence of ``t_len`` steps takes."""
    return "step" if t_len <= STEP_MAX_T else "chunked"


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: ``d`` itself when it is one
    of ``HEAD_DIMS``, the next one above below 128 (the zero-padded route),
    ``BLOCK_DIM`` above 128 (the block route); raises for ``d`` below 1."""
    if d < 1:
        raise ValueError(f"a WKV6 head dim must be at least 1, got {d}")
    if d in HEAD_DIMS:
        return d
    if d > HEAD_DIMS[-1]:
        return BLOCK_DIM
    return next(h for h in HEAD_DIMS if h > d)


def pad_inputs(r, k, v, w, u, s0, dp: int):
    """The zero-padded route's inputs at head dim ``dp``: ``r``, ``k``,
    ``v``, ``u`` with zero columns, ``w`` with ones, ``s0`` with zero rows
    and columns (differentiable pads, so under autograd each gradient is
    sliced back to the given head dim)."""
    pd = dp - r.shape[-1]
    F = torch.nn.functional
    return (*(F.pad(x, (0, pd)) for x in (r, k, v)),
            F.pad(w, (0, pd), value=1.0), F.pad(u, (0, pd)),
            F.pad(s0, (0, pd, 0, pd)))


def fold_blocks(fn, r, k, v, w, u, s0):
    """WKV6 at head dim ``D`` as one call of ``fn`` (a WKV6 function of
    ``(r, k, v, w, u, s0)`` at head dim ``BLOCK_DIM``, e.g. the kernels'
    wrapper, or the plain version) over the (key block, value block) pairs
    of ``D`` zero-padded to ``n`` blocks of ``BLOCK_DIM`` (``pad_inputs``'
    rules), folded into the head axis: ``[B, H * n * n, T, BLOCK_DIM]`` in
    (head, key block, value block) order. Returns ``(o [B, H, T, D], S_T
    [B, H, D, D])``: ``o`` summed over the key blocks (in block order),
    ``S_T``'s blocks the pairs' own. Differentiable: the fold's backward
    sums ``dr``, ``dk``, ``dw``, ``du`` over the value blocks and ``dv``
    over the key blocks."""
    b, h, t, d = r.shape
    db = BLOCK_DIM
    dp = -(-d // db) * db
    if dp != d:
        r, k, v, w, u, s0 = pad_inputs(r, k, v, w, u, s0, dp)
    n = dp // db

    def blocks(x, key: bool):
        """``x [B, H, T, dp]`` as ``[B, H * n * n, T, db]``: block ``kb``
        of the pair (``key``) or block ``vb``, repeated over the other."""
        x = x.reshape(b, h, t, n, db).permute(0, 1, 3, 2, 4)
        x = x.unsqueeze(3 if key else 2)
        return x.expand(b, h, n, n, t, db).reshape(b, h * n * n, t, db)

    uf = u.reshape(h, n, 1, db).expand(h, n, n, db).reshape(h * n * n, db)
    sf = s0.reshape(b, h, n, db, n, db).permute(0, 1, 2, 4, 3, 5)
    o, s_t = fn(blocks(r, True), blocks(k, True), blocks(v, False),
                blocks(w, True), uf, sf.reshape(b, h * n * n, db, db))
    o = o.reshape(b, h, n, n, t, db).sum(2).permute(0, 1, 3, 2, 4)
    s_t = s_t.reshape(b, h, n, n, db, db).permute(0, 1, 2, 4, 3, 5)
    return (o.reshape(b, h, t, dp)[..., :d],
            s_t.reshape(b, h, dp, dp)[..., :d, :d])


def _check_inputs(r, k, v, w, u, s0=None):
    """The kernels' inputs: ``r, k, v, w [B, H, T >= 1, D]`` with ``D`` in
    ``HEAD_DIMS``, ``u [H, D]``, ``s0 [B, H, D, D]`` (where given)."""
    if r.dim() != 4 or r.shape[-1] not in HEAD_DIMS or r.shape[2] < 1:
        raise ValueError(f"r must be [B, H, T >= 1, D] with D in "
                         f"{HEAD_DIMS} (a D below {HEAD_DIMS[-1]} through "
                         f"rwkv6_chunk's zero-padded route), got "
                         f"{tuple(r.shape)}")
    b, h, t, d = r.shape
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, x, r, r.shape)
    _check("u", u, r, (h, d))
    if s0 is not None:
        _check("s0", s0, r, (b, h, d, d))


def _raise(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"rwkv6 {what} failed to launch: "
                           + ("unsupported head dim" if err == -1
                              else f"cudaError_t {err}"))


def _forward(r, k, v, w, u, s0, route: str):
    """The kernels of ``route`` on checked CUDA inputs: ``(o, S_T,
    workspace)``, the workspace None for the step route."""
    b, h, t, d = r.shape
    o = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    ws = None
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, o, s_out)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        if route == "chunked":
            ws = torch.empty((b * h, -(-t // CHUNK), d, d),
                             dtype=torch.float32, device=r.device)
            err = _library().rwkv6_chunk_fwd(*ptrs, ws.data_ptr(), b * h, h,
                                             t, d, stream)
        else:
            err = _library().rwkv6_step_fwd(*ptrs, b * h, h, t, d, stream)
    _raise(err, f"{route} route")
    rwkv6_chunk.launches += 1
    rwkv6_chunk.launches_by_route[route] += 1
    return o, s_out, ws


def rwkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                route: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r, k, v, w [B, H, T, D]``, ``u [H, D]``, ``s0 [B, H, D, D]``, all
    fp32 -> ``(o [B, H, T, D], S_T [B, H, D, D])`` fp32. CUDA tensors: the
    kernels of ``route`` (by default ``route_for(T)``); CPU tensors: the
    plain version."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if resolve_backend(r) == "torch":
        return rwkv6_chunk_plain(r, k, v, w, u, s0, chunk=CHUNK)
    d = r.shape[-1]
    if r.dim() == 4 and d > HEAD_DIMS[-1]:
        o, s_out = fold_blocks(
            functools.partial(rwkv6_chunk, route=route), r, k, v, w, u, s0)
        rwkv6_chunk.blocked_launches["forward"] += 1
        return o.contiguous(), s_out.contiguous()
    if r.dim() == 4 and d not in HEAD_DIMS:
        o, s_out = rwkv6_chunk(*pad_inputs(r, k, v, w, u, s0,
                                           padded_head_dim(d)), route=route)
        rwkv6_chunk.padded_launches["forward"] += 1
        return o[..., :d].contiguous(), s_out[..., :d, :d].contiguous()
    _check_inputs(r, k, v, w, u, s0)
    o, s_out, _ = _forward(r, k, v, w, u, s0, route or route_for(r.shape[2]))
    return o, s_out


def rwkv6_chunk_backward(r, k, v, w, u, ws, do, ds_t):
    """The gradients of the chunked route: ``r, k, v, w [B, H, T, D]``,
    ``u [H, D]``, the forward's workspace ``ws [B * H, ceil(T / CHUNK), D,
    D]``, the gradients ``do [B, H, T, D]`` of ``o`` and ``ds_t [B, H, D,
    D]`` of ``S_T`` (zeros where it is unused), all fp32 on the card ->
    ``(dr, dk, dv, dw, du [H, D], ds0 [B, H, D, D])``. Two CUDA launches;
    ``du`` sums the kernel's per-(batch * head, chunk) partials here, in a
    fixed order."""
    _check_inputs(r, k, v, w, u)
    b, h, t, d = r.shape
    n_chunks = -(-t // CHUNK)
    _check("ws", ws, r, (b * h, n_chunks, d, d))
    do = do.float().contiguous()
    _check("do", do, r, r.shape)
    ds_t = ds_t.float().contiguous()
    _check("ds_t", ds_t, r, (b, h, d, d))
    grads = [torch.empty_like(r) for _ in range(4)]
    du_part = torch.empty((b * h, n_chunks, d), dtype=torch.float32,
                          device=r.device)
    ds0 = torch.empty_like(ds_t)
    dws = torch.empty_like(ws)
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, ws, do, ds_t, dws,
                                   *grads, du_part, ds0)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _bwd_library().rwkv6_chunk_bwd(*ptrs, b * h, h, t, d, stream)
    _raise(err, "backward")
    rwkv6_chunk.launches_by_route["backward"] += 1
    du = du_part.view(b, h, n_chunks, d).sum((0, 2))
    return (*grads, du, ds0)


class _ChunkedWKV6(torch.autograd.Function):
    """The chunked route forward, its workspace kept for the backward
    kernels."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, counted):
        o, s_out, ws = _forward(r, k, v, w, u, s0, "chunked")
        ctx.save_for_backward(r, k, v, w, u, ws)
        ctx.counted = counted
        return o, s_out

    @staticmethod
    def backward(ctx, do, ds_t):         # an unused output's gradient: zeros
        r, k, v, w, u, ws = ctx.saved_tensors
        if ctx.counted is not None:
            getattr(rwkv6_chunk, f"{ctx.counted}_launches")["backward"] += 1
        return (*rwkv6_chunk_backward(r, k, v, w, u, ws, do, ds_t), None)


def _chunked_apply(counted: Optional[str]):
    """``_ChunkedWKV6`` on checked inputs, its backward counted in
    ``rwkv6_chunk.<counted>_launches`` (``"padded"``, ``"blocked"``, or
    None for no route's count)."""

    def apply(r, k, v, w, u, s0):
        _check_inputs(r, k, v, w, u, s0)
        return _ChunkedWKV6.apply(r, k, v, w, u, s0, counted)

    return apply


def rwkv6_chunk_autograd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rwkv6_chunk`` under autograd: CUDA tensors take the chunked route
    (any T) and the backward kernels; CPU tensors the plain version."""
    if resolve_backend(r) == "torch":
        return rwkv6_chunk_plain(r, k, v, w, u, s0, chunk=CHUNK)
    d = r.shape[-1]
    if r.dim() == 4 and d > HEAD_DIMS[-1]:
        out = fold_blocks(_chunked_apply("blocked"), r, k, v, w, u, s0)
        rwkv6_chunk.blocked_launches["forward"] += 1
        return out
    if r.dim() == 4 and d not in HEAD_DIMS:
        padded = pad_inputs(r, k, v, w, u, s0, padded_head_dim(d))
        o, s_out = _chunked_apply("padded")(*padded)
        rwkv6_chunk.padded_launches["forward"] += 1
        return o[..., :d], s_out[..., :d, :d]
    return _chunked_apply(None)(r, k, v, w, u, s0)


def reset_counts():
    """Every count to 0: calls, calls by route and the backward's, and the
    zero-padded and block routes' by direction."""
    rwkv6_chunk.launches = 0
    rwkv6_chunk.launches_by_route = dict.fromkeys(COUNTED, 0)
    rwkv6_chunk.padded_launches = {"forward": 0, "backward": 0}
    rwkv6_chunk.blocked_launches = {"forward": 0, "backward": 0}


reset_counts()
