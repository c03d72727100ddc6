"""The CUDA flash-attention kernels' own source, compiled for the host with
``g++`` against a stand-in for the CUDA runtime (``tests/_cuda_emu.py``
and ``tests/cuda_emu``: one thread per CUDA thread, a barrier for
``__syncthreads``, shuffles through a buffer) and called through the same
C interface and ``ctypes`` signatures as on the card. This checks the kernels' tiling, indexing,
masks and arithmetic on the CPU; whether they compile for ``sm_90a``, and
their speed, only a card can show (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

bf16 inputs take the tensor-core kernels (``flash_fwd_tc``,
``flash_bwd_dq_tc``, ``flash_bwd_dkdv_tc``: ``mma``, ``ldmatrix`` and
``cp.async`` through the warp-collective stand-ins of
``tests/cuda_emu/warp_mma.cuh``); fp32 inputs the CUDA-core kernels. Each
case checks the route of all three launches by their threads per block
(128 against 256) and by the ``mma`` calls they made (some against none).

Tolerance vs the plain ``flash_attention_ref`` and its autograd: fp32 1e-5
(the same fp32 arithmetic, summed in tiles); bf16 3e-2 (the reference's
kernel tolerance: bf16 outputs, and P and dS rounded to bf16 before their
products, in the forward as in the backward).
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
    # bf16: the tensor-core kernels at every head dim
    (2, 80, 16, "bfloat16", True, 0, 0.0),        # ragged T
    (1, 200, 32, "bfloat16", True, 0, 0.0),       # ragged T
    (1, 256, 64, "bfloat16", True, 100, 0.0),     # window: skipped tiles
    (1, 128, 64, "bfloat16", True, 0, 50.0),      # softcap
    (1, 40, 64, "bfloat16", False, 0, 0.0),       # not causal, T < tile
    (1, 192, 64, "bfloat16", False, 70, 5.0),     # not causal, window, cap
    (1, 128, 128, "bfloat16", True, 0, 0.0),
    (1, 200, 128, "bfloat16", False, 0, 0.0),     # ragged T, not causal
    (1, 256, 128, "bfloat16", True, 100, 5.0),    # window, softcap
    (2, 40, 16, "bfloat16", True, 0, 0.0),        # T < one 64-row tile
    # D = 144 (the LM sweep at lm_d_model 576) and 256 (gemma2-9b): 32-row
    # fp32 tiles; bf16 Q reloaded from shared memory in the forward and the
    # backward's output columns split over grid z (dq 144 | 128 + 128, dkdv
    # 3 x 48 | 2 x 128); and a head dim padded inside the wrapper
    (1, 96, 144, "float32", True, 0, 0.0),
    (1, 80, 144, "bfloat16", True, 0, 0.0),       # ragged T
    (1, 72, 256, "float32", True, 40, 50.0),      # window, softcap, ragged
    (1, 128, 256, "bfloat16", True, 50, 50.0),    # gemma2's masks
    (1, 64, 40, "float32", True, 0, 0.0),         # padded to 64
    (1, 72, 40, "bfloat16", False, 0, 5.0),       # padded to 64
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
    # the C interface at the instantiated head dim, zero-padded as the
    # wrapper pads, with the true D's scale
    dp = tflash.padded_head_dim(d)
    q, k, v, do = (torch.nn.functional.pad(x, (0, dp - d)) for x in
                   (q, k, v, do))
    common = (bh, t, dp, int(dt == torch.bfloat16), int(causal), window, cap,
              d ** -0.5, None)
    o, lse = torch.empty_like(q), torch.empty(bh, t)
    routes = [_route(emulated, lambda: emulated.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *common))]
    dq, delta = torch.empty_like(q), torch.empty(bh, t)
    routes.append(_route(emulated, lambda: emulated.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *common)))
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
    # the padding columns of every output are zero; the rest is the plain
    # version's at the true D
    for got in (o, dq, dk, dv):
        assert not got[..., d:].any()
    q, k, v, do, o, dq, dk, dv = (x[..., :d] for x in
                                  (q, k, v, do, o, dq, dk, dv))
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
    """Past the largest instantiation the C interface refuses (-1) and the
    wrapper raises before any launch, naming the gap."""
    x = torch.zeros(1, 64, 272)
    lse = torch.empty(1, 64)
    assert emulated.flash_attention_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), 1, 64, 272, 0, 1, 0, 0.0, 272 ** -0.5, None) == -1
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        tflash.padded_head_dim(272)
