"""The WKV6 chunk recurrence as a hand-written CUDA kernel for Hopper,
forward only.

Replaces ``repro/kernels/rwkv6_chunk.py``: ``rwkv6_chunk`` -> ``_kernel``
(the TPU kernel, which has no backward either). The CUDA source is
``csrc/rwkv6_chunk.cu``; its header says what the kernel computes, how it
avoids the TPU kernel's fp32 overflow at strong decay, what bounds it and
how it is laid out.

``rwkv6_chunk(r, k, v, w, u, s0)`` on ``[B, H, T, D]`` fp32 (the
reference's entry) returns ``(o [B, H, T, D], S_T [B, H, D, D])``. On CPU
tensors it is the plain version (``repro_torch.kernels.ref.
rwkv6_chunk_plain``); on CUDA tensors it always launches the kernel, one
launch per call, counted in ``rwkv6_chunk.launches``, and a build or
launch failure raises. Head dims 64 and 128, any ``T >= 1``,
chunks of ``CHUNK`` steps (the last one masked in the kernel).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.ref import rwkv6_chunk_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_chunk.cu"
HEAD_DIMS = (64, 128)
CHUNK = 64

__all__ = ["CHUNK", "HEAD_DIMS", "rwkv6_chunk"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rwkv6_chunk_fwd": [_P] * 8 + [_I] * 4 + [_P]}


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


def rwkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r, k, v, w [B, H, T, D]``, ``u [H, D]``, ``s0 [B, H, D, D]``, all
    fp32 -> ``(o [B, H, T, D], S_T [B, H, D, D])`` fp32. CUDA tensors: one
    kernel launch; CPU tensors: the plain version."""
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
    o = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    with torch.cuda.device(r.device):
        err = _library().rwkv6_chunk_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_out.data_ptr(),
            b * h, h, t, d, torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rwkv6_chunk_fwd failed to launch: "
                           + ("unsupported head dim" if err == -1
                              else f"cudaError_t {err}"))
    rwkv6_chunk.launches += 1
    return o, s_out


rwkv6_chunk.launches = 0
