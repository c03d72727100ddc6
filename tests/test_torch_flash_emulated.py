"""The CUDA flash-attention kernels' own source, compiled for the host with
``g++`` against a stand-in for the CUDA runtime (``tests/_cuda_emu.py``
and ``tests/cuda_emu``: one thread per CUDA thread, a barrier for
``__syncthreads``, shuffles through a buffer) and called through the same
C interface and ``ctypes`` signatures as on the card. This checks the kernels' tiling, indexing,
masks and arithmetic on the CPU; whether they compile for ``sm_90a``, and
their speed, only a card can show (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

bf16 inputs take the tensor-core backward (``flash_bwd_dq_tc``,
``flash_bwd_dkdv_tc``: ``mma``, ``ldmatrix`` and ``cp.async`` through the
warp-collective stand-ins of ``tests/cuda_emu/warp_mma.cuh``); fp32 inputs,
and the forward in both dtypes, the CUDA-core kernels. Each case checks the
route by the threads per block of the backward launches (128 against 256)
and by the ``mma`` calls they made (some against none).

Tolerance vs the plain ``flash_attention_ref`` and its autograd: fp32 1e-5
(the same fp32 arithmetic, summed in tiles); bf16 3e-2 (the reference's
kernel tolerance: bf16 outputs, and P and dS rounded to bf16 before their
products).
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

import _cuda_emu  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

CASES = [  # (bh, t, d, dtype, causal, window, softcap)
    (2, 128, 64, "float32", True, 0, 0.0),
    (1, 128, 128, "float32", True, 0, 0.0),
    (1, 256, 64, "float32", True, 100, 0.0),      # window: skipped tiles
    (1, 128, 64, "float32", True, 0, 50.0),       # softcap
    (1, 128, 64, "bfloat16", True, 0, 0.0),
    (2, 80, 16, "float32", True, 0, 0.0),         # ragged T
    (1, 96, 32, "float32", True, 0, 0.0),
    (1, 40, 64, "float32", False, 0, 0.0),        # not causal, T < tile
    (1, 192, 64, "float32", False, 70, 5.0),
    # bf16: the tensor-core backward at every head dim
    (2, 80, 16, "bfloat16", True, 0, 0.0),        # ragged T
    (1, 200, 32, "bfloat16", True, 0, 0.0),       # ragged T
    (1, 256, 64, "bfloat16", True, 100, 0.0),     # window: skipped tiles
    (1, 128, 64, "bfloat16", True, 0, 50.0),      # softcap
    (1, 40, 64, "bfloat16", False, 0, 0.0),       # not causal, T < tile
    (1, 192, 64, "bfloat16", False, 70, 5.0),     # not causal, window, cap
    (1, 128, 128, "bfloat16", True, 0, 0.0),
    (1, 200, 128, "bfloat16", False, 0, 0.0),     # ragged T, not causal
    (1, 256, 128, "bfloat16", True, 100, 5.0),    # window, softcap
]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = _cuda_emu.build(tflash.SOURCE, tflash._SIGNATURES,
                          tmp_path_factory.mktemp("flash_emu"))
    lib.emu_mma_calls.restype = ctypes.c_long
    lib.emu_block_threads.restype = ctypes.c_int
    return lib


def _route(lib, launch):
    """(threads per block, mma calls) of what ``launch()`` ran."""
    before = lib.emu_mma_calls()
    assert launch() == 0
    return lib.emu_block_threads(), lib.emu_mma_calls() - before


@pytest.mark.parametrize("bh,t,d,dtype,causal,window,cap", CASES)
def test_emulated_kernels_match_plain_version(emulated, bh, t, d, dtype,
                                              causal, window, cap):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(t + d + window)
    q, k, v, do = (torch.randn(bh, t, d, generator=gen).to(dt)
                   for _ in range(4))
    common = (bh, t, d, int(dt == torch.bfloat16), int(causal), window, cap,
              None)
    o, lse = torch.empty_like(q), torch.empty(bh, t)
    assert emulated.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *common) == 0
    dq, delta = torch.empty_like(q), torch.empty(bh, t)
    routes = [_route(emulated, lambda: emulated.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *common))]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    routes.append(_route(emulated, lambda: emulated.flash_attention_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *common)))
    for threads, mmas in routes:    # tensor cores for bf16 only
        if dtype == "bfloat16":
            assert threads == 128 and mmas > 0
        else:
            assert threads == 256 and mmas == 0
    rs = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = flash_attention_ref(*rs, causal=causal, window=window,
                               logit_softcap=cap)
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
    pos = torch.arange(t)
    allow = torch.ones(t, t, dtype=torch.bool)
    if causal:
        allow &= pos[:, None] >= pos[None, :]
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    torch.testing.assert_close(lse, torch.logsumexp(
        s.masked_fill(~allow, float("-inf")), -1), rtol=tol, atol=tol)
    torch.testing.assert_close(delta, (do.float() * o.float()).sum(-1),
                               rtol=tol, atol=tol)


def test_emulated_launch_refuses_an_unsupported_head_dim(emulated):
    x = torch.zeros(1, 64, 48)
    lse = torch.empty(1, 64)
    assert emulated.flash_attention_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), 1, 64, 48, 0, 1, 0, 0.0, None) == -1
