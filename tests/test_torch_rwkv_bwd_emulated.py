"""The CUDA WKV6 backward's own source (``csrc/rwkv6_chunk_bwd.cu``),
compiled for the host with ``g++`` against the stand-in for the CUDA
runtime (``tests/_cuda_emu.py``, ``tests/cuda_emu``) and called through the
same C interface and ``ctypes`` signatures as on the card, from the
chunk-start states that the emulated forward (``csrc/rwkv6_chunk.cu``)
writes to its workspace, as the autograd ``Function`` of
``kernels/rwkv6_chunk.py`` hands them over. This checks the two backward
launches' chunking, indexing, masks and arithmetic on the CPU; whether they
compile for ``sm_90a``, and their speed, only a card can show
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 19). Both launches do
their products on the tensor cores (3xTF32 ``mma_tf32``): the chunk pass
runs 8 warps (256 threads) and makes ``mma`` calls, which the stand-in
counts. Head dim 64 throughout, and one case at 128, where the chunk pass's
shared memory is tightest.

Inputs as ``tests/test_torch_rwkv_emulated.py``'s (r, k, v ~ 0.5 N(0, 1),
w = exp(-exp(-3 + 0.5 N(0, 1))) or strong decay w uniform in [1e-3, 0.1],
u ~ 0.3 N, s0 ~ 0.1 N), the output gradients do ~ N(0, 1) and dS_T ~ 0.1
N (or none, S_T unused). Cases: one chunk, a ragged last chunk and three
chunks at both decays, and the models folded into the head axis as the
model stack lays them out (``[b, G * H, T, D]`` with another u per model).
Tolerance against the autograd of the plain chunked version
(``ref.rwkv6_chunk_grads``), each gradient scaled by its largest
magnitude: fp32 atol = rtol = 1e-4 for dr, dk, dv, du, ds0 and the
log-decay gradient dw * w: the same fp32 arithmetic in another order, exact
``exp2``/``log2`` for the card's ``ex2.approx``/``__log2f``, and 3xTF32
products in both directions, whose operands the emulated tensor core
rounds as the card does. dw itself is dlog w / w: at strong decay (w down
to 1e-3) that division magnifies dlog w's fp32 rounding, in the plain
version's own autograd too (its dw lies 3.5e-5 to 5.7e-5 of the largest
|dw| from the same function in float64 in these cases), so dw is held to
the card's 1e-3 (``chip_smoke.py`` phase 19a). The same bars hold the
backward against ``jax.vjp`` of the JAX reference's step scan
(``repro.kernels.ref.rwkv6_chunk_ref``) on the same numpy inputs.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _cuda_emu  # noqa: E402
from repro.kernels.ref import rwkv6_chunk_ref as jrwkv6_chunk_ref  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as trwkv  # noqa: E402
from repro_torch.kernels.ref import rwkv6_chunk_grads  # noqa: E402

TOL = 1e-4
DW_TOL = 1e-3
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
CASES = [  # (b, h, t, decay, with dS_T)
    (1, 2, 64, "ref", True),           # one chunk
    (2, 1, 100, "ref", False),         # a ragged last chunk, S_T unused
    (1, 2, 130, "ref", True),          # three chunks, the last of 2 steps
    (1, 2, 64, "strong", True),
    (2, 1, 100, "strong", True),
    (1, 1, 130, "strong", False),
]


def wkv_inputs(b, h, t, d, decay, seed=0):
    """One case's inputs and output gradients (torch's generator)."""
    gen = torch.Generator().manual_seed(seed + 7 * b + t)
    r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen)
               for _ in range(3))
    if decay == "ref":
        w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(
            b, h, t, d, generator=gen)))
    else:
        w = 1e-3 + (0.1 - 1e-3) * torch.rand(b, h, t, d, generator=gen)
    u = 0.3 * torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    do = torch.randn(b, h, t, d, generator=gen)
    ds_t = 0.1 * torch.randn(b, h, d, d, generator=gen)
    return (r, k, v, w, u, s0), do, ds_t


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    out = tmp_path_factory.mktemp("rwkv_bwd_emu")
    libs = (_cuda_emu.build(trwkv.SOURCE, trwkv._SIGNATURES, out),
            _cuda_emu.build(trwkv.BWD_SOURCE, trwkv._BWD_SIGNATURES, out))
    libs[1].emu_mma_calls.restype = ctypes.c_long
    return libs


def run(libs, r, k, v, w, u, s0, do, ds_t):
    """The emulated forward (for its workspace), then the emulated
    backward; returns its code and the six gradients (``du`` summed over
    the batch and the chunks, as the wrapper does)."""
    fwd, bwd = libs
    b, h, t, d = r.shape
    n_chunks = -(-t // trwkv.CHUNK)
    o, s_out = torch.empty_like(r), torch.empty_like(s0)
    ws = torch.empty(b * h, n_chunks, d, d)
    err = fwd.rwkv6_chunk_fwd(*[x.data_ptr() for x in (
        r, k, v, w, u, s0, o, s_out, ws)], b * h, h, t, d, None)
    assert err == 0
    if ds_t is None:
        ds_t = torch.zeros_like(s0)
    grads = [torch.empty_like(r) for _ in range(4)]
    du_part = torch.empty(b * h, n_chunks, d)
    ds0, dws = torch.empty_like(s0), torch.empty_like(ws)
    err = bwd.rwkv6_chunk_bwd(*[x.data_ptr() for x in (
        r, k, v, w, u, ws, do, ds_t, dws, *grads, du_part, ds0)],
        b * h, h, t, d, None)
    du = du_part.view(b, h, n_chunks, d).sum((0, 2))
    return err, (*grads, du, ds0)


def assert_grads_close(got, want, w, label):
    """Each gradient, scaled by its largest magnitude, within TOL; dw as
    dw * w (dlog w) within TOL and as itself within DW_TOL."""
    got, want = list(got), list(want)
    checks = list(zip(NAMES, got, want, [TOL] * len(NAMES)))
    checks[3] = ("dw", got[3], want[3], DW_TOL)
    checks.append(("dw * w", got[3] * w, want[3] * w, TOL))
    for name, g, x, tol in checks:
        assert torch.isfinite(g).all(), f"{label} {name} not finite"
        scale = max(1.0, x.abs().max().item())
        torch.testing.assert_close(
            g / scale, x / scale, rtol=tol, atol=tol,
            msg=lambda m: f"{label} {name} (scaled by {scale:.3g}): {m}")


def check_against_plain(libs, b, h, t, d, decay, with_ds):
    """All six gradients against the plain autograd; the chunk pass runs 8
    warps a block and the backward makes mma calls."""
    ins, do, ds_t = wkv_inputs(b, h, t, d, decay)
    ds_t = ds_t if with_ds else None
    want = rwkv6_chunk_grads(*ins, do, ds_t)
    before = libs[1].emu_mma_calls()
    err, got = run(libs, *ins, do, ds_t)
    assert err == 0
    assert libs[1].emu_block_threads() == 256
    assert libs[1].emu_mma_calls() > before
    assert_grads_close(got, want, ins[3], f"[{b}, {h}, {t}, {d}] {decay}")


@pytest.mark.parametrize("b,h,t,decay,with_ds", CASES)
def test_emulated_backward_matches_autograd_of_plain_version(
        emulated, b, h, t, decay, with_ds):
    check_against_plain(emulated, b, h, t, 64, decay, with_ds)


def test_emulated_backward_at_head_dim_128(emulated):
    """D = 128, a ragged last chunk at strong decay: the chunk pass's
    205,312 bytes of shared memory, and its 16-row slabs of S_c and dS'
    eight times over."""
    check_against_plain(emulated, 1, 1, 100, 128, "strong", True)


def test_emulated_backward_matches_jax_vjp_of_reference(emulated):
    """``[1, 2, 100, 64]`` at the reference decay, numpy inputs: the six
    gradients against ``jax.vjp`` of ``repro.kernels.ref.rwkv6_chunk_ref``
    for the cotangents (do, dS_T), at the bars above."""
    rng = np.random.default_rng(3)
    b, h, t, d = 1, 2, 100, 64
    r, k, v = (0.5 * rng.normal(size=(b, h, t, d)) for _ in range(3))
    w = np.exp(-np.exp(-3.0 + 0.5 * rng.normal(size=(b, h, t, d))))
    u = 0.3 * rng.normal(size=(h, d))
    s0 = 0.1 * rng.normal(size=(b, h, d, d))
    do = rng.normal(size=(b, h, t, d))
    ds_t = 0.1 * rng.normal(size=(b, h, d, d))
    ins = [x.astype(np.float32) for x in (r, k, v, w, u, s0)]
    do, ds_t = do.astype(np.float32), ds_t.astype(np.float32)
    _, vjp = jax.vjp(jrwkv6_chunk_ref, *map(jnp.asarray, ins))
    want = [torch.as_tensor(np.array(x))
            for x in vjp((jnp.asarray(do), jnp.asarray(ds_t)))]
    err, got = run(emulated, *map(torch.as_tensor, ins),
                   torch.as_tensor(do), torch.as_tensor(ds_t))
    assert err == 0
    assert_grads_close(got, want, torch.as_tensor(ins[3]), "vs jax.vjp")


def test_emulated_backward_folds_models_into_the_head_axis(emulated):
    """The model stack's layout: G = 2 models of H = 2 heads as
    ``[b, G * H, T, D]`` with ``u [G * H, D]``, another u per model; each
    model's gradients equal those of its own call."""
    G, H, b, t = 2, 2, 2, 100
    parts = [wkv_inputs(b, H, t, 64, "ref", seed=s) for s in (1, 2)]

    def fold(i):
        return torch.stack([p[0][i] for p in parts], 1).reshape(
            b, G * H, t, 64).contiguous()

    r, k, v, w = (fold(i) for i in range(4))
    u = torch.cat([p[0][4] for p in parts]).contiguous()
    s0 = torch.stack([p[0][5] for p in parts], 1).reshape(
        b, G * H, 64, 64).contiguous()
    do = torch.stack([p[1] for p in parts], 1).reshape(
        b, G * H, t, 64).contiguous()
    err, got = run(emulated, r, k, v, w, u, s0, do, None)
    assert err == 0
    for g, (ins, do_g, _) in enumerate(parts):
        want = rwkv6_chunk_grads(*ins, do_g)
        mine = [x.reshape(b, G, H, *x.shape[2:])[:, g] for x in
                (got[0], got[1], got[2], got[3])]
        mine += [got[4].reshape(G, H, 64)[g],
                 got[5].reshape(b, G, H, 64, 64)[:, g]]
        assert_grads_close(mine, want, ins[3], f"model {g}")


@pytest.mark.parametrize("d", [32, 48])
def test_emulated_backward_refuses_an_unsupported_head_dim(emulated, d):
    z = torch.zeros(1, 1, 4, d)
    ws = torch.zeros(1, 1, d, d)
    args = [z] * 4 + [torch.zeros(1, d), ws, z, ws[:, 0], ws,
                      *([z] * 4), torch.zeros(1, 1, d), ws[:, 0]]
    assert emulated[1].rwkv6_chunk_bwd(*[x.data_ptr() for x in args],
                                       1, 1, 4, d, None) == -1


def test_emulated_backward_shared_memory_fits_a_block(emulated):
    """Each backward kernel's dynamic shared memory at D = 64 and 128 fits
    Hopper's 232,448 bytes a block; an unknown head dim or kernel answers
    -1."""
    bwd = emulated[1]
    for d in trwkv.HEAD_DIMS:
        sizes = [bwd.rwkv6_bwd_shared_bytes(i, d)
                 for i in range(len(trwkv.BWD_KERNELS))]
        assert all(0 < x <= 232448 for x in sizes), sizes
    assert bwd.rwkv6_bwd_shared_bytes(0, 32) == -1
    assert bwd.rwkv6_bwd_shared_bytes(len(trwkv.BWD_KERNELS), 64) == -1
