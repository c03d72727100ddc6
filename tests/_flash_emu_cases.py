"""The emulated flash-attention cases and their check, shared by
``tests/test_torch_flash_emulated.py`` (fp32), ``..._bf16.py`` and
``..._wide.py`` (head dims 144 and 256, and one the wrapper pads): the
kernels' own source (``csrc/flash_attention.cu``), compiled for the host
with ``g++`` against the stand-in for the CUDA runtime
(``tests/_cuda_emu.py``, ``tests/cuda_emu``: one thread per CUDA thread, a
barrier for ``__syncthreads``, warp collectives through a buffer) and
called through the same C interface and ``ctypes`` signatures as on the
card, both libraries: self-attention's and the causal-offset route's
(``csrc/flash_attention_offset.cu``: the same source at the other
instantiation). Split over three files so that the test run's ``--dist
loadfile`` spreads them over workers.

Routes: all three kernels of both dtypes run on the tensor cores (128
threads and some ``mma`` calls: 3xTF32 ``mma_tf32`` for fp32, bf16
``mma_bf16``).

A case is ``(bh, t, d, dtype, causal, window, softcap, q_offset)``: ``t``
queries at ``q_offset`` against ``q_offset + t`` keys. ``q_offset > 0`` is
the causal-offset route (a sequence-parallel rank's chunk against its
gathered key prefix, ``tq < tk``); those cases are held against the model
stack's plain ``models.attention.attention_ref(..., q_offset=...)``, the
others against ``flash_attention_ref``. A case's test id is its first
seven fields, with the offset appended only where it is not 0 (``ID``).

Tolerance vs the plain version and its autograd: fp32 1e-5
(fp32-accurate products: 3xTF32 keeps about 21 bits of each operand and
sums in fp32, P and dS stay fp32; the stand-in reads each tf32 operand to
its top 19 bits, as the card does); bf16 3e-2 (the reference's kernel
tolerance: bf16 outputs, and P and dS rounded to bf16 before their
products, in the forward as in the backward).
"""
import ctypes
import shutil

import torch

import _cuda_emu
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.attention import attention_ref

FP32 = [  # (bh, t, d, dtype, causal, window, softcap, q_offset)
    (2, 128, 64, "float32", True, 0, 0.0, 0),
    (1, 128, 128, "float32", True, 0, 0.0, 0),
    (1, 256, 64, "float32", True, 100, 0.0, 0),   # window: skipped tiles
    (1, 128, 64, "float32", True, 0, 50.0, 0),    # softcap
    (2, 80, 16, "float32", True, 0, 0.0, 0),      # ragged T
    (1, 96, 32, "float32", True, 0, 0.0, 0),
    (1, 40, 64, "float32", False, 0, 0.0, 0),     # not causal, T < tile
    (1, 192, 64, "float32", False, 70, 5.0, 0),
    (1, 200, 128, "float32", False, 0, 0.0, 0),   # ragged, not causal
    (2, 40, 16, "float32", True, 0, 0.0, 0),      # T < one 64-row tile
    # the causal-offset route: rank 1 of 2 (keys below the offset seen by
    # every query), a window and softcap over a ragged chunk, rank 3 of 4
    (2, 64, 64, "float32", True, 0, 0.0, 64),
    (1, 48, 32, "float32", True, 40, 5.0, 80),
    (1, 64, 16, "float32", True, 0, 0.0, 192),
]
BF16 = [  # the tensor-core kernels at every head dim up to 128
    (1, 128, 64, "bfloat16", True, 0, 0.0, 0),
    (2, 80, 16, "bfloat16", True, 0, 0.0, 0),     # ragged T
    (1, 200, 32, "bfloat16", True, 0, 0.0, 0),    # ragged T
    (1, 256, 64, "bfloat16", True, 100, 0.0, 0),  # window: skipped tiles
    (1, 128, 64, "bfloat16", True, 0, 50.0, 0),   # softcap
    (1, 40, 64, "bfloat16", False, 0, 0.0, 0),    # not causal, T < tile
    (1, 192, 64, "bfloat16", False, 70, 5.0, 0),  # not causal, window, cap
    (1, 128, 128, "bfloat16", True, 0, 0.0, 0),
    (1, 200, 128, "bfloat16", False, 0, 0.0, 0),  # ragged T, not causal
    (1, 256, 128, "bfloat16", True, 100, 5.0, 0),  # window, softcap
    (2, 40, 16, "bfloat16", True, 0, 0.0, 0),     # T < one 64-row tile
    # the causal-offset route: rank 1 of 2; a window and softcap over a
    # ragged chunk at D = 128
    (1, 64, 64, "bfloat16", True, 0, 0.0, 64),
    (1, 80, 128, "bfloat16", True, 100, 50.0, 176),
]
# D = 144 (the LM sweep at lm_d_model 576) and 256 (gemma2-9b): 32-key
# forward tiles and 32-row fp32 backward tiles; bf16 Q reloaded from shared
# memory in the forward and the backward's output columns split over grid z
# (dq 144 | 128 + 128, dkdv 3 x 48 | 2 x 128); and a head dim padded inside
# the wrapper
WIDE = [
    (1, 96, 144, "float32", True, 0, 0.0, 0),
    (1, 80, 144, "bfloat16", True, 0, 0.0, 0),    # ragged T
    (1, 72, 256, "float32", True, 40, 50.0, 0),   # window, softcap, ragged
    (1, 128, 256, "bfloat16", True, 50, 50.0, 0),  # gemma2's masks
    (1, 64, 40, "float32", True, 0, 0.0, 0),      # padded to 64
    (1, 72, 40, "bfloat16", False, 0, 5.0, 0),    # padded to 64
    # the causal-offset route at a padded head dim and at D = 144
    (1, 32, 40, "float32", True, 0, 0.0, 32),
    (1, 32, 144, "bfloat16", True, 0, 0.0, 96),
]
PARAMS = "bh,t,d,dtype,causal,window,cap,q_offset"


def ID(case) -> str:
    """A case's test id: its first seven fields (``q_offset`` too where it
    is not 0), as pytest writes them."""
    return "-".join(str(x) for x in (case if case[7] else case[:7]))


def _offset_source(tmp):
    """The offset route's source as ``csrc/flash_attention_offset.cu``
    makes it (``flash_attention.cu`` under ``FLASH_OFFSET_ROUTE``), written
    out whole so that the build can rewrite its launch, beside copies of
    its headers but ``warp_mma.cuh`` (whose stand-in takes its place)."""
    wrapper = tflash.OFFSET_SOURCE.read_text()
    assert "#define FLASH_OFFSET_ROUTE 1" in wrapper
    assert '#include "flash_attention.cu"' in wrapper
    src = tmp / tflash.OFFSET_SOURCE.name
    src.write_text("#define FLASH_OFFSET_ROUTE 1\n"
                   + tflash.SOURCE.read_text())
    for header in tflash.SOURCE.parent.glob("*.cuh"):
        if header.name != "warp_mma.cuh":
            shutil.copyfile(header, tmp / header.name)
    return src


def build(tmp_path_factory):
    """The emulated self-attention library, with its route counters bound,
    and the offset route's as its ``offset`` attribute."""
    lib = _cuda_emu.build(tflash.SOURCE, tflash._SIGNATURES,
                          tmp_path_factory.mktemp("flash_emu"))
    tmp = tmp_path_factory.mktemp("flash_emu_offset")
    lib.offset = _cuda_emu.build(_offset_source(tmp),
                                 tflash._OFFSET_SIGNATURES, tmp)
    for one in (lib, lib.offset):
        one.emu_mma_calls.restype = ctypes.c_long
        one.emu_block_threads.restype = ctypes.c_int
    return lib


def _route(lib, launch):
    """(threads per block, mma calls) of what ``launch()`` ran."""
    before = lib.emu_mma_calls()
    assert launch() == 0
    return lib.emu_block_threads(), lib.emu_mma_calls() - before


def run_kernels(lib, q, k, v, do, d, causal, window, cap, q_offset=0):
    """Forward, dq and dkdv through the C interface at the instantiated
    head dim (inputs zero-padded as the wrapper pads, with the true D's
    scale), ``q, do [bh, t, d]`` at ``q_offset`` against ``k, v [bh,
    q_offset + t, d]``; returns (o, lse, dq, delta, dk, dv) and the three
    launches' routes (the offset route's library at ``q_offset > 0``)."""
    if q_offset:
        lib = lib.offset
    name = "flash_attention_offset_" if q_offset else "flash_attention_"
    fwd, bwd_dq, bwd_dkdv = (getattr(lib, name + n)
                             for n in ("fwd", "bwd_dq", "bwd_dkdv"))
    bh, t = q.shape[:2]
    dp = tflash.padded_head_dim(d)
    q, k, v, do = (torch.nn.functional.pad(x, (0, dp - d)).contiguous()
                   for x in (q, k, v, do))
    common = (bh, t, k.shape[1], q_offset, dp, int(q.dtype == torch.bfloat16),
              int(causal), window, cap, d ** -0.5, None)
    o, lse = torch.empty_like(q), torch.empty(bh, t)
    routes = [_route(lib, lambda: fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *common))]
    dq, delta = torch.empty_like(q), torch.empty(bh, t)
    routes.append(_route(lib, lambda: bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *common)))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    routes.append(_route(lib, lambda: bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *common)))
    # the padding columns of every output are zero
    for got in (o, dq, dk, dv):
        assert not got[..., d:].any()
    o, dq, dk, dv = (x[..., :d] for x in (o, dq, dk, dv))
    return (o, lse, dq, delta, dk, dv), routes


def _plain(q, k, v, causal, window, cap, q_offset):
    """The plain version of a case on ``[bh, T, D]``: ``flash_attention_ref``,
    or at an offset the model stack's ``attention_ref`` (causal; heads
    as its batch, one head each)."""
    if not q_offset:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_softcap=cap)
    assert causal
    return attention_ref(q[:, :, None], k[:, :, None], v[:, :, None],
                         kind="swa" if window else "full", window=window,
                         logit_softcap=cap, q_offset=q_offset)[:, :, 0]


def check_case(lib, bh, t, d, dtype, causal, window, cap, q_offset=0):
    """One case: the routes, then every output against the plain version
    and its autograd at the true D."""
    dt = getattr(torch, dtype)
    tk = q_offset + t
    gen = torch.Generator().manual_seed(t + d + window + q_offset)
    q, do = (torch.randn(bh, t, d, generator=gen).to(dt) for _ in range(2))
    k, v = (torch.randn(bh, tk, d, generator=gen).to(dt) for _ in range(2))
    (o, lse, dq, delta, dk, dv), routes = run_kernels(
        lib, q, k, v, do, d, causal, window, cap, q_offset)
    # forward, dq, dkdv: all on the tensor cores
    assert all(th == 128 and mmas > 0 for th, mmas in routes), routes
    rs = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = _plain(*rs, causal, window, cap, q_offset)
    grads = torch.autograd.grad(want, rs, do.float())
    tol = 1e-5 if dtype == "float32" else 3e-2
    for got, ref in zip((o, dq, dk, dv), (want,) + grads):
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), ref.detach(), rtol=tol,
                                   atol=tol)
    # the log-sum-exp the backward reuses, and delta = rowsum(dO * O)
    s = (rs[0] @ rs[1].transpose(-1, -2)).detach() * d ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    pos, kpos = q_offset + torch.arange(t), torch.arange(tk)
    allow = torch.ones(t, tk, dtype=torch.bool)
    if causal:
        allow &= pos[:, None] >= kpos[None, :]
    if window:
        allow &= pos[:, None] - kpos[None, :] < window
    torch.testing.assert_close(lse, torch.logsumexp(
        s.masked_fill(~allow, float("-inf")), -1), rtol=tol, atol=tol)
    torch.testing.assert_close(delta, (do.float() * o.float()).sum(-1),
                               rtol=tol, atol=tol)


__all__ = ["BF16", "FP32", "ID", "PARAMS", "WIDE", "build", "check_case",
           "run_kernels"]
