"""The flash kernels' wide-head route (``csrc/flash_attention_wide.cu``:
forward, dq, dkdv) on the CPU, built for the host with ``g++`` against the
stand-in for the CUDA runtime (``tests/_cuda_emu.py``) and called through
the same C interface and ``ctypes`` signatures as on the card: at head
dims 288 (the LM sweep at ``lm_d_model`` 1152) and 512 (at 2048),
zero-padded to multiples of 128 as the wrapper pads them and scaled by the
true ``D ** -0.5``, against the model stack's plain ``attention_ref``
(causal; ``flash_attention_ref`` where not causal) and its autograd, with
the log-sum-exp and ``delta``; all three launches on the tensor cores (128
threads, ``mma`` calls). The WKV6 block route's emulated case is in
``tests/test_torch_rwkv_pad_emulated.py``, beside the pad route's.

Tolerance: fp32 1e-5 (``tests/_flash_emu_cases.py``'s: 3xTF32 products, P
and dS fp32).
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

import _cuda_emu  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models.attention import attention_ref  # noqa: E402

FLASH_TOL = 1e-5
# (bh, t, d, causal, window, softcap)
WIDE_CASES = [
    (1, 72, 288, True, 0, 0.0),     # the LM sweep's head dim, 2 row tiles
    (1, 40, 512, True, 24, 50.0),   # window, softcap, T below one row tile
    (1, 40, 288, False, 0, 5.0),    # not causal
]


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    lib = _cuda_emu.build(tflash.WIDE_SOURCE, tflash._WIDE_SIGNATURES,
                          tmp_path_factory.mktemp("flash_wide_emu"))
    lib.emu_mma_calls.restype = ctypes.c_long
    lib.emu_block_threads.restype = ctypes.c_int
    return lib


def _route(lib, launch):
    """(threads per block, mma calls) of what ``launch()`` ran."""
    before = lib.emu_mma_calls()
    assert launch() == 0
    return lib.emu_block_threads(), lib.emu_mma_calls() - before


@pytest.mark.parametrize("bh,t,d,causal,window,cap", WIDE_CASES)
def test_wide_flash_kernels_match_plain_version(wide, bh, t, d, causal,
                                                window, cap):
    gen = torch.Generator().manual_seed(t + d + window)
    q, k, v, do = (torch.randn(bh, t, d, generator=gen) for _ in range(4))
    ld = tflash.wide_head_dim(d)
    assert ld % 128 == 0 and ld == tflash.padded_head_dim(d)
    qp, kp, vp, dop = (torch.nn.functional.pad(x, (0, ld - d)).contiguous()
                       for x in (q, k, v, do))
    common = (bh, t, ld, int(causal), window, cap, d ** -0.5, None)
    o, lse = torch.empty_like(qp), torch.empty(bh, t)
    dq, delta = torch.empty_like(qp), torch.empty(bh, t)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    routes = [
        _route(wide, lambda: wide.flash_attention_wide_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *common)),
        _route(wide, lambda: wide.flash_attention_wide_bwd_dq(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            dop.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *common)),
        _route(wide, lambda: wide.flash_attention_wide_bwd_dkdv(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *common))]
    assert all(th == 128 and mmas > 0 for th, mmas in routes), routes
    for got in (o, dq, dk, dv):     # the padding columns stay zero
        assert not got[..., d:].any()
    rs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    if causal:
        want = attention_ref(*(x[:, :, None] for x in rs),
                             kind="swa" if window else "full",
                             window=window, logit_softcap=cap)[:, :, 0]
    else:
        want = flash_attention_ref(*rs, causal=False, window=window,
                                   logit_softcap=cap)
    grads = torch.autograd.grad(want, rs, do)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                              (want,) + grads):
        torch.testing.assert_close(got[..., :d], ref.detach(),
                                   rtol=FLASH_TOL, atol=FLASH_TOL,
                                   msg=lambda m: f"{name}: {m}")
    s = (q @ k.transpose(-1, -2)) * d ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(t)
    allow = torch.ones(t, t, dtype=torch.bool)
    if causal:
        allow &= pos[:, None] >= pos[None, :]
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    torch.testing.assert_close(lse, torch.logsumexp(
        s.masked_fill(~allow, float("-inf")), -1), rtol=FLASH_TOL,
        atol=FLASH_TOL)
    torch.testing.assert_close(delta, (do * want.detach()).sum(-1),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_wide_library_refuses_a_head_dim_off_its_chunks(wide):
    """The C interface takes only a positive multiple of 128 (-1 else);
    the wrapper pads to one."""
    x = torch.zeros(1, 64, 288)
    lse = torch.empty(1, 64)
    assert wide.flash_attention_wide_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), 1, 64, 288, 1, 0, 0.0, 288 ** -0.5, None) == -1
