"""The CUDA WKV6 kernels' own source (``csrc/rwkv6_chunk.cu``), compiled
for the host with ``g++`` against the stand-in for the CUDA runtime
(``tests/_cuda_emu.py``, ``tests/cuda_emu``) and called through the same C
interface and ``ctypes`` signatures as on the card. This checks both routes'
chunking, indexing, masks and arithmetic on the CPU; whether they compile
for ``sm_90a``, and their speed, only a card can show
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Inputs as in ``tests/test_kernels.py::test_rwkv6_chunk_sweep`` (r, k, v
~ 0.5 N(0, 1), w = exp(-exp(-3 + 0.5 N(0, 1))), u ~ 0.3 N, s0 ~ 0.1 N),
plus strong decay (w uniform in [1e-3, 0.1]), ragged T, short T and T = 1,
each through both routes (the chunked one on the tensor cores, the step
one on the CUDA cores). Tolerance vs the plain chunked version and the step
scan: fp32 atol and rtol 1e-4 (the same fp32 arithmetic in another order,
exact ``exp2``/``log2`` for the card's ``ex2.approx``/``__log2f``, and the
chunked route's products as 3xTF32, whose host stand-in of the tensor
core reads only the top 19 bits of each operand, as the card does; the
reference's kernel tolerance is 3e-3).
"""
import ctypes

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
    (2, 2, 2, 64, "ref"),            # T = 2
    (1, 2, 63, 64, "ref"),           # one step short of a chunk
    (2, 1, 65, 64, "strong"),        # one step past a chunk
    (1, 2, 512, 64, "strong"),       # 8 chunks at strong decay
    (2, 3, 1, 128, "ref"),           # a decode step at D = 128
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


def run(lib, route, r, k, v, w, u, s0):
    """One call of ``route``'s C function (the chunked one with its
    workspace); returns its code, o and S_T."""
    b, h, t, d = r.shape
    o = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, o, s_out)]
    if route == "chunked":
        ws = torch.empty(b * h, -(-t // trwkv.CHUNK), d, d)
        err = lib.rwkv6_chunk_fwd(*ptrs, ws.data_ptr(), b * h, h, t, d, None)
    else:
        err = lib.rwkv6_step_fwd(*ptrs, b * h, h, t, d, None)
    return err, o, s_out


@pytest.mark.parametrize("b,h,t,d,decay", CASES)
def test_emulated_kernel_matches_plain_version(emulated, b, h, t, d, decay):
    """Both routes, each on its own kernels: the chunked one's last launch
    (the output pass) has 256 threads and tensor-core products, the step
    one 128 threads and none."""
    ins = wkv_inputs(b, h, t, d, decay)
    o_plain, s_plain = rwkv6_chunk_plain(*ins)
    o_ref, s_ref = rwkv6_chunk_ref(*ins)
    for route in trwkv.ROUTES:
        mma_before = emulated.emu_mma_calls()
        err, o, s_out = run(emulated, route, *ins)
        assert err == 0
        assert emulated.emu_block_threads() == (256 if route == "chunked"
                                                else 128)
        assert (emulated.emu_mma_calls() > mma_before) == (route == "chunked")
        assert torch.isfinite(o).all() and torch.isfinite(s_out).all()
        for got, want in ((o, o_plain), (s_out, s_plain), (o, o_ref),
                          (s_out, s_ref)):
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL,
                                       msg=lambda m: f"{route}: {m}")


@pytest.mark.parametrize("d", [32, 48])
def test_emulated_launch_refuses_an_unsupported_head_dim(emulated, d):
    ins = [torch.zeros(1, 1, 4, d)] * 4 + [torch.zeros(1, d),
                                           torch.zeros(1, 1, d, d)]
    for route in trwkv.ROUTES:
        assert run(emulated, route, *ins)[0] == -1


def test_emulated_shared_memory_fits_a_block(emulated):
    """Each kernel's dynamic shared memory at D = 64 and 128 fits Hopper's
    232,448 bytes a block (the stand-in's cudaFuncSetAttribute refuses
    more), and an unknown head dim or kernel answers -1."""
    for d in trwkv.HEAD_DIMS:
        sizes = [emulated.rwkv6_shared_bytes(i, d)
                 for i in range(len(trwkv.KERNELS))]
        assert all(0 <= x <= 232448 for x in sizes), sizes
    assert emulated.rwkv6_shared_bytes(0, 32) == -1
    assert emulated.rwkv6_shared_bytes(len(trwkv.KERNELS), 64) == -1


# A 16 x 8 product over K = 64 of fp32 data through the tf32 stand-ins, as
# one tf32 product and as the 3xTF32 split the chunked route takes (the
# kernel's mma3): one warp, A [16][64] and B [64][8] row-major, C [16][8].
TF32_PRODUCT = r"""
#include <cuda_runtime.h>
#include "warp_mma.cuh"

template <int NT>
__global__ void product(const float* a, const float* b, float* c, int split) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kk = 0; kk < 64; kk += 8) {
    const float x[4] = {a[g * 64 + kk + t], a[(g + 8) * 64 + kk + t],
                        a[g * 64 + kk + t + 4], a[(g + 8) * 64 + kk + t + 4]};
    const float y[2] = {b[(kk + t) * 8 + g], b[(kk + t + 4) * 8 + g]};
    uint32_t xh[4], xl[4], yh[2], yl[2];
    for (int i = 0; i < 4; ++i) split_tf32(x[i], xh[i], xl[i]);
    for (int i = 0; i < 2; ++i) split_tf32(y[i], yh[i], yl[i]);
    if (split) {
      mma_tf32(d, xl, yh[0], yh[1]);
      mma_tf32(d, xh, yl[0], yl[1]);
    }
    mma_tf32(d, xh, yh[0], yh[1]);
  }
  for (int i = 0; i < 4; ++i)
    c[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = d[i];
}

template <auto Kernel, int NT, typename... Args>
void go(dim3 grid, int bytes, cudaStream_t stream, Args... args) {
  Kernel<<<grid, NT, bytes, stream>>>(args...);
}

extern "C" int tf32_product(const float* a, const float* b, float* c,
                            int split) {
  go<product<32>, 32>(dim3(1), 0, nullptr, a, b, c, split);
  return 0;
}
"""


@pytest.fixture(scope="module")
def tf32_product(tmp_path_factory):
    out = tmp_path_factory.mktemp("tf32_emu")
    source = out / "tf32_product.cu"
    source.write_text(TF32_PRODUCT)
    p = ctypes.c_void_p
    return _cuda_emu.build(source, {"tf32_product": [p, p, p, ctypes.c_int]},
                           out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_tf32_product_misses_where_the_3xtf32_split_meets(tf32_product,
                                                             seed):
    """Plain TF32 keeps ~3 decimal digits, so the stand-in of one tf32
    product misses TOL on fp32 data, and the split's three products meet it
    (the host stand-ins must round like the card, not be exact)."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(16, 64, generator=gen)
    b = torch.randn(64, 8, generator=gen)
    want = (a.double() @ b.double()).float()
    errs = []
    for split in (0, 1):
        c = torch.empty(16, 8)
        tf32_product.tf32_product(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  split)
        errs.append((c - want).abs().max().item())
    assert errs[0] > TOL, errs
    torch.testing.assert_close(c, want, rtol=TOL, atol=TOL)
