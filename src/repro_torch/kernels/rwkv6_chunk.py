"""The WKV6 recurrence as hand-written CUDA kernels for Hopper, forward
only: a chunk-parallel route on the tensor cores for prefill and a step
route for decode.

Replaces ``repro/kernels/rwkv6_chunk.py``: ``rwkv6_chunk`` -> ``_kernel``
(the TPU kernel, which has no backward either). The CUDA source is
``csrc/rwkv6_chunk.cu``; its header says what the kernels compute, how they
avoid the TPU kernel's fp32 overflow at strong decay, what bounds them and
how they are laid out.

``rwkv6_chunk(r, k, v, w, u, s0)`` on ``[B, H, T, D]`` fp32 (the
reference's entry) returns ``(o [B, H, T, D], S_T [B, H, D, D])``. On CPU
tensors it is the plain version (``repro_torch.kernels.ref.
rwkv6_chunk_plain``). On CUDA tensors it always launches a kernel route,
and a build or launch failure raises. The route follows T (``route_for``):
``T <= STEP_MAX_T`` takes ``"step"`` (one CUDA launch, ``wkv6_step``), a
longer T ``"chunked"`` (two CUDA launches, ``wkv6_state`` then
``wkv6_output``, over a ``[B * H, ceil(T / CHUNK), D, D]`` fp32 workspace
allocated here with ``torch.empty``). Either route takes any ``T >= 1``;
``route=`` forces one. Each call counts one in ``rwkv6_chunk.launches``
and one in ``rwkv6_chunk.launches_by_route[route]``, whatever the number of
CUDA launches. Head dims 64 and 128.
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
HEAD_DIMS = (64, 128)
CHUNK = 64
# the longest T that takes the step route: at [8, 40, T, 64] on an H100 the
# step route took 0.0196 ms at T = 8 against the chunked route's 0.0296, and
# 0.0358 against 0.0299 at T = 16 (chip_smoke.py phase 7 times both)
STEP_MAX_T = 8
ROUTES = ("chunked", "step")

__all__ = ["CHUNK", "HEAD_DIMS", "KERNELS", "ROUTES", "STEP_MAX_T",
           "route_for", "rwkv6_chunk", "shared_bytes"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# chunked: r, k, v, w, u, s0, o, s_out, workspace; step: without it
_SIGNATURES = {"rwkv6_chunk_fwd": [_P] * 9 + [_I] * 4 + [_P],
               "rwkv6_step_fwd": [_P] * 8 + [_I] * 4 + [_P],
               "rwkv6_shared_bytes": [_I, _I]}
# the kernels, in the order of rwkv6_shared_bytes's first argument
KERNELS = ("wkv6_state", "wkv6_output", "wkv6_step")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source version and card) and load the kernel."""
    return build.load(SOURCE, _SIGNATURES)


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
    """The dynamic shared memory of ``kernel`` (one of ``KERNELS``) at head
    dim ``d``, from the built library."""
    return _library().rwkv6_shared_bytes(KERNELS.index(kernel), d)


def route_for(t_len: int) -> str:
    """The route a sequence of ``t_len`` steps takes."""
    return "step" if t_len <= STEP_MAX_T else "chunked"


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
    if r.dim() != 4 or r.shape[-1] not in HEAD_DIMS or r.shape[2] < 1:
        raise ValueError(f"r must be [B, H, T >= 1, D] with D in "
                         f"{HEAD_DIMS}, got {tuple(r.shape)}")
    b, h, t, d = r.shape
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, x, r, r.shape)
    _check("u", u, r, (h, d))
    _check("s0", s0, r, (b, h, d, d))
    route = route or route_for(t)
    o = torch.empty_like(r)
    s_out = torch.empty_like(s0)
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
    if err != 0:
        raise RuntimeError(f"rwkv6 {route} route failed to launch: "
                           + ("unsupported head dim" if err == -1
                              else f"cudaError_t {err}"))
    rwkv6_chunk.launches += 1
    rwkv6_chunk.launches_by_route[route] += 1
    return o, s_out


rwkv6_chunk.launches = 0
rwkv6_chunk.launches_by_route = dict.fromkeys(ROUTES, 0)
