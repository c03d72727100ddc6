"""The CUDA WKV6 kernel's own source (``csrc/rwkv6_chunk.cu``), compiled
for the host with ``g++`` against the stand-in for the CUDA runtime
(``tests/_cuda_emu.py``, ``tests/cuda_emu``) and called through the same C
interface and ``ctypes`` signature as on the card. This checks the
kernel's chunking, indexing, masks and arithmetic on the CPU; whether it
compiles for ``sm_90a``, and its speed, only a card can show
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Inputs as in ``tests/test_kernels.py::test_rwkv6_chunk_sweep`` (r, k, v
~ 0.5 N(0, 1), w = exp(-exp(-3 + 0.5 N(0, 1))), u ~ 0.3 N, s0 ~ 0.1 N),
plus strong decay (w uniform in [1e-3, 0.1]), ragged T and T = 1.
Tolerance vs the plain chunked version and the step scan: fp32 atol and
rtol 1e-4 (the same fp32 arithmetic in another order, ``expf`` for the
card's ``__expf``; the reference's kernel tolerance is 3e-3).
"""
import pytest

torch = pytest.importorskip("torch")

import _cuda_emu  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as trwkv  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    rwkv6_chunk_plain,
    rwkv6_chunk_ref,
)

TOL = 1e-4
CASES = [  # (b, h, t, d, decay)
    (1, 1, 64, 64, "ref"),
    (2, 2, 128, 64, "ref"),
    (1, 2, 256, 128, "ref"),
    (1, 1, 192, 64, "ref"),
    (1, 2, 128, 64, "strong"),
    (2, 1, 100, 64, "ref"),          # ragged T
    (1, 3, 70, 64, "strong"),        # ragged T, strong decay
    (3, 2, 1, 64, "ref"),            # T = 1 (a decode step)
]


def wkv_inputs(b, h, t, d, decay, seed=0):
    """The inputs of one case (torch's generator; numpy in the tests that
    also feed JAX)."""
    gen = torch.Generator().manual_seed(seed + b * t + d)
    r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen)
               for _ in range(3))
    if decay == "ref":
        w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(
            b, h, t, d, generator=gen)))
    else:
        w = 1e-3 + (0.1 - 1e-3) * torch.rand(b, h, t, d, generator=gen)
    u = 0.3 * torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    return r, k, v, w, u, s0


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _cuda_emu.build(trwkv.SOURCE, trwkv._SIGNATURES,
                           tmp_path_factory.mktemp("rwkv_emu"))


@pytest.mark.parametrize("b,h,t,d,decay", CASES)
def test_emulated_kernel_matches_plain_version(emulated, b, h, t, d, decay):
    r, k, v, w, u, s0 = wkv_inputs(b, h, t, d, decay)
    o = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    assert emulated.rwkv6_chunk_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_out.data_ptr(),
        b * h, h, t, d, None) == 0
    assert torch.isfinite(o).all() and torch.isfinite(s_out).all()
    o_plain, s_plain = rwkv6_chunk_plain(r, k, v, w, u, s0)
    o_ref, s_ref = rwkv6_chunk_ref(r, k, v, w, u, s0)
    for got, want in ((o, o_plain), (s_out, s_plain), (o, o_ref),
                      (s_out, s_ref)):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [32, 48])
def test_emulated_launch_refuses_an_unsupported_head_dim(emulated, d):
    x = torch.zeros(1, 1, 4, d)
    s = torch.zeros(1, 1, d, d)
    u = torch.zeros(1, d)
    assert emulated.rwkv6_chunk_fwd(
        *(t.data_ptr() for t in (x, x, x, x, u, s, x, s)),
        1, 1, 4, d, None) == -1
