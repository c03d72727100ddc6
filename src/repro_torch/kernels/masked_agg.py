"""The server update of Alg. 1 line 11 as a Triton kernel for Hopper.

Replaces ``repro/kernels/masked_agg.py``: ``fused_masked_agg``
(``_fused_call_3d`` / ``_fused_batched_kernel`` and the 2-D
``_fused_call_2d`` / ``_fused_kernel``) and ``masked_agg``
(``_mean_kernel`` / ``_guarded_mean_kernel``): all four ``pallas_call``
sites are one kernel here.

What it computes, for each trajectory b of ``x [B, m, n]`` (fp32 or bf16)
with ``mask [B, m]``, ``p [B, m]``, ``prev [B, n]`` and opcode ``op [B]``
(see ``repro_torch.kernels.ref``):

- ``OP_MEAN``: ``sum(mask * x) / max(|A|, 1)``, or ``prev`` when no client
  is active (``masked_agg(prev=None)`` gives zeros there instead);
- ``OP_ALL``: ``prev + sum((x - prev) * mask / m)``;
- ``OP_KNOWN_P``: ``prev + sum((x - prev) * mask / max(p, 1e-3) / m)``.

Accumulation is fp32 and the output is fp32 ``[B, n]``.

Bound: device-memory bandwidth. The kernel must read the active clients'
rows of ``x`` once (plus ``prev`` where the result reads it, ``mask``,
``p``) and write ``B * n``; it does no tensor-core work and ~3 flops per
element read. Design: a single streamed read. The grid is
``(cdiv(n, BLOCK_N), B)``: the column blocks sit on grid axis 0 (CUDA's
``gridDim.x``, up to 2^31 - 1 blocks) and the trajectory on axis 1
(``gridDim.y``, at most 65,535), so a 134.5M-parameter LM buffer launches.
Offsets are 64-bit. Each program owns ``BLOCK_N`` columns of one
trajectory and walks the client axis in ``BLOCK_M``-row tiles with
coalesced masked loads, keeping one fp32 accumulator row in registers.
``op[b]`` is uniform per program, so the branch only picks the weight of
each row (``mask``, ``mask / m`` or ``mask / max(p, 1e-3) / m``) and the
delta base (0 or ``prev``): one sum is accumulated, never three. The
program counts the active clients from the ``[m]`` mask before it reads
``x``, and loads ``prev`` only where the result uses it (``OP_ALL``,
``OP_KNOWN_P``, or no active client): under ``OP_MEAN`` with an active
client it reads ``x`` and writes the output, nothing else of size ``n``.
Every client row is read, inactive ones too: the plain version multiplies
by the mask, so a non-finite value there reaches the result in both. The
masks of the loads cover the ragged ``n`` and ``m`` edges, so nothing is
padded or copied (the TPU wrapper pads with ``jnp.pad``). The zero-active
guard is folded into the epilogue: an empty active set returns ``prev``;
``masked_agg(prev=None)`` passes a zero ``prev``, so there it returns
zeros, as the TPU kernel does.

Block sizes (``block_sizes``, a pure function of ``m`` and the dtype):
``BLOCK_M`` is ``m`` rounded up to a power of two, at most 16, so the LM's
8 clients fill one 8-row tile with no masked lanes. Each of a program's 64
threads (2 warps) loads 16 contiguous bytes of every row of a tile (8 bf16
or 4 fp32 columns), so ``BLOCK_N`` is 512 bf16 or 256 fp32 columns, and a
warp reads 512 contiguous bytes of a row. On an H100 (80GB HBM3, 700 W;
``scripts/bench_masked_agg.py``) this was within 1 % of the fastest of
twelve (warps, loads a thread) pairs at both shapes of ``chip_smoke.py``
phase 1: the LM's ``[1, 8, 134.5M]`` bf16 at 0.881 ms, 3.05 TB/s of the
20 bytes a column it reads and writes (the old 16 x 256 tiles of 4 warps
took 5.30 ms), and ``[12, 100, 2762]`` fp32 at 0.0123 ms, where it is
latency-bound. Wider tiles, more warps or more loads a thread did not
help at either shape, so ``n`` does not enter the choice.

The wrapper runs the plain version for CPU tensors only; a CUDA tensor
always launches the kernel, and any other input raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.ref import (
    OP_ALL,
    OP_KNOWN_P,
    OP_MEAN,
    fused_masked_agg_ref,
    masked_agg_ref,
)

# warps of a program; each of its threads loads 16 bytes of every row of a
# tile (scripts/bench_masked_agg.py: the fastest or within 1 % of it at both
# of chip_smoke.py's shapes, PERF.md)
NUM_WARPS = 2

__all__ = ["OP_MEAN", "OP_ALL", "OP_KNOWN_P", "block_sizes",
           "fused_masked_agg", "masked_agg"]


def block_sizes(m: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(BLOCK_M, BLOCK_N, num_warps)`` of a launch on ``x [B, m, n]`` of
    ``dtype``: powers of two, ``BLOCK_M`` the least one ``>= m`` up to 16,
    and ``BLOCK_N`` the columns of one 16-byte load for each of the
    ``32 * num_warps`` threads (512 bf16, 256 fp32)."""
    block_m = min(16, 1 << max(m - 1, 0).bit_length())
    return block_m, 32 * NUM_WARPS * 16 // dtype.itemsize, NUM_WARPS


@functools.lru_cache(maxsize=None)
def _kernel():
    """Define the Triton kernel on first launch (``triton`` is imported
    here, never at module import, so CPU-only machines can import this)."""
    import triton
    import triton.language as tl

    @triton.jit
    def fused_agg_kernel(x_ptr, mask_ptr, p_ptr, prev_ptr, op_ptr, out_ptr,
                         m, n, m_f,
                         BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr):
        b = tl.program_id(1).to(tl.int64)
        offs_n = tl.program_id(0).to(tl.int64) * BLOCK_N + tl.arange(0, BLOCK_N)
        n_ok = offs_n < n
        op = tl.load(op_ptr + b)
        is_mean = op == 0
        cnt = tl.zeros([BLOCK_M], dtype=tl.float32)
        for m0 in range(0, m, BLOCK_M):
            offs_m = m0 + tl.arange(0, BLOCK_M)
            cnt += tl.load(mask_ptr + b * m + offs_m, mask=offs_m < m,
                           other=0).to(tl.float32)
        n_active = tl.sum(cnt, axis=0)
        # prev only where the result reads it: OP_ALL, OP_KNOWN_P, or no
        # active client
        prev = tl.load(prev_ptr + b * n + offs_n,
                       mask=n_ok & ((op != 0) | (n_active == 0)), other=0.0)
        # delta base: 0 for the mean (x - 0 is exact), prev otherwise
        base = tl.where(is_mean, 0.0, prev)
        acc = tl.zeros([BLOCK_N], dtype=tl.float32)
        for m0 in range(0, m, BLOCK_M):
            offs_m = m0 + tl.arange(0, BLOCK_M)
            m_ok = offs_m < m
            mk = tl.load(mask_ptr + b * m + offs_m, mask=m_ok,
                         other=0).to(tl.float32)
            pp = tl.load(p_ptr + b * m + offs_m, mask=m_ok, other=1.0)
            # row weights: OP_KNOWN_P (2), OP_ALL (1), OP_MEAN (0)
            w = tl.where(op == 2, mk / tl.maximum(pp, 1e-3) / m_f,
                         tl.where(op == 1, mk / m_f, mk))
            rows = (b * m + offs_m[:, None]) * n + offs_n[None, :]
            x = tl.load(x_ptr + rows, mask=m_ok[:, None] & n_ok[None, :],
                        other=0.0).to(tl.float32)
            acc += tl.sum((x - base[None, :]) * w[:, None], axis=0)
        mean = tl.where(n_active > 0, acc / tl.maximum(n_active, 1.0), prev)
        out = tl.where(is_mean, mean, prev + acc)
        tl.store(out_ptr + b * n + offs_n, out, mask=n_ok)

    return fused_agg_kernel


def compiled_specializations() -> Optional[int]:
    """How many specialisations of the Triton kernel this process has
    compiled: 0 before its first launch; ``None`` where the installed
    Triton keeps its JIT cache under another name than ``device_caches``
    (``{device: (kernel_cache, ...)}``) or ``cache`` (``{device:
    kernel_cache}``)."""
    if _kernel.cache_info().currsize == 0:
        return 0
    fn = _kernel()
    caches = getattr(fn, "device_caches", None)
    if isinstance(caches, dict):
        return sum(len(c[0]) for c in caches.values())
    cache = getattr(fn, "cache", None)
    if isinstance(cache, dict):
        return sum(len(c) for c in cache.values())
    return None


def _check(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if not t.is_cuda:
        raise ValueError(f"{name} is on {t.device}, x is on the card")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x, mask, op, prev, p) -> torch.Tensor:
    """Validate the ``[B, m, n]`` operands and launch the kernel once on the
    current stream."""
    B, m, n = x.shape
    if m == 0 or n == 0:
        raise ValueError(f"x has an empty axis: {tuple(x.shape)}")
    _check("x", x, (B, m, n), (torch.float32, torch.bfloat16))
    _check("mask", mask, (B, m), (torch.bool, torch.float32))
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)        # same bytes, loadable as u8
    _check("prev", prev, (B, n), (torch.float32,))
    _check("op", op, (B,), (torch.int32,))
    _check("p", p, (B, m), (torch.float32,))
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    block_m, block_n, num_warps = block_sizes(m, x.dtype)
    grid = (-(-n // block_n), B)
    with torch.cuda.device(x.device):
        _kernel()[grid](
            x, mask, p, prev, op, out, m, n, float(m),
            BLOCK_M=block_m, BLOCK_N=block_n, num_warps=num_warps)
    fused_masked_agg.launches += 1
    return out


def fused_masked_agg(x: torch.Tensor, mask: torch.Tensor, op: torch.Tensor,
                     prev: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Fused family aggregation over stacked client params.

    Shapes: single trajectory ``x [m, n]``, ``mask [m]``, ``op`` scalar,
    ``prev [n]``, ``p [m]``; sweep layout ``x [B, m, n]``, ``mask [B, m]``,
    ``op [B]`` int32, ``prev [B, n]``, ``p [B, m]``. Returns fp32 ``[n]`` /
    ``[B, n]``. CPU tensors go to the plain version; CUDA tensors launch the
    kernel (one launch, counted in ``fused_masked_agg.launches``).
    """
    if resolve_backend(x) == "torch":
        return fused_masked_agg_ref(x, mask, op, prev, p)
    if x.dim() == 2:
        op = torch.as_tensor(op, dtype=torch.int32, device=x.device)
        return _launch(x[None], mask[None], op.reshape(1), prev[None],
                       p[None])[0]
    return _launch(x, mask, op, prev, p)


fused_masked_agg.launches = 0


def masked_agg(x: torch.Tensor, mask: torch.Tensor,
               prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [m, n]; mask: [m]. Returns [n] fp32: the active-client mean.

    With ``prev=None`` an empty active set gives the zero vector; with
    ``prev`` ([n]) it gives ``prev``. The ``OP_MEAN`` case of
    ``fused_masked_agg`` with ``B = 1``, through the same kernel and counter.
    """
    if resolve_backend(x) == "torch":
        return masked_agg_ref(x, mask, prev)
    m, n = x.shape
    dev = x.device
    if prev is None:
        prev = torch.zeros(n, dtype=torch.float32, device=dev)
    op = torch.zeros(1, dtype=torch.int32, device=dev)
    p = torch.ones((1, m), dtype=torch.float32, device=dev)
    return _launch(x[None], mask[None], op, prev[None], p)[0]
