"""The WKV6 kernels' zero-padded head-dim route
(``kernels/rwkv6_chunk.py``: ``padded_head_dim``, ``pad_inputs``), which
the RWKV6 LM takes on the card at a head dim outside the kernels' 64 and
128 (the LM sweep's ``reduced(rwkv6-3b, d_model=64)`` has heads of 16):
the kernels' own sources (``csrc/rwkv6_chunk.cu``,
``csrc/rwkv6_chunk_bwd.cu``) compiled for the host with ``g++`` against
the stand-in for the CUDA runtime (``tests/_cuda_emu.py``), called at the
padded head dim as the wrapper's autograd route composes them, against the
plain version at the given head dim; the block route above 128
(``fold_blocks`` over the same emulated kernels at D = 256, rwkv6-3b at
``lm_d_model`` 1024); and the padding's exactness in the plain version
itself.

Tolerance: ``WKV_TOL`` = 1e-4 scaled by each output's largest magnitude,
``tests/test_torch_rwkv_bwd_emulated.py``'s bar (the same fp32 arithmetic
in another order, 3xTF32 products on the emulated tensor cores); 1e-6
for the padding in the plain version (the padded columns add exact
zeros).
"""
import pytest

torch = pytest.importorskip("torch")

from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import _cuda_emu  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as trwkv  # noqa: E402
from repro_torch.kernels.ref import rwkv6_chunk_grads, rwkv6_chunk_plain  # noqa: E402

WKV_TOL = 1e-4

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated forward and backward libraries (the two compilers run
    at once)."""
    out = tmp_path_factory.mktemp("rwkv_pad_emu")
    with ThreadPoolExecutor(2) as pool:
        fwd = pool.submit(_cuda_emu.build, trwkv.SOURCE, trwkv._SIGNATURES,
                          out)
        bwd = pool.submit(_cuda_emu.build, trwkv.BWD_SOURCE,
                          trwkv._BWD_SIGNATURES, out)
        return fwd.result(), bwd.result()


class _EmulatedWKV6(torch.autograd.Function):
    """The chunked route's forward and backward C functions, emulated,
    in the wrapper's ``_ChunkedWKV6`` shape."""

    @staticmethod
    def forward(ctx, libs, r, k, v, w, u, s0):
        b, h, t, d = r.shape
        o, s_out = torch.empty_like(r), torch.empty_like(s0)
        ws = torch.empty(b * h, -(-t // trwkv.CHUNK), d, d)
        assert libs[0].rwkv6_chunk_fwd(*[x.data_ptr() for x in (
            r, k, v, w, u, s0, o, s_out, ws)], b * h, h, t, d, None) == 0
        ctx.libs = libs
        ctx.save_for_backward(r, k, v, w, u, ws)
        return o, s_out

    @staticmethod
    def backward(ctx, do, ds_t):
        r, k, v, w, u, ws = ctx.saved_tensors
        b, h, t, d = r.shape
        do, ds_t = do.contiguous(), ds_t.contiguous()
        grads = [torch.empty_like(r) for _ in range(4)]
        du_part = torch.empty(b * h, ws.shape[1], d)
        ds0, dws = torch.empty(b, h, d, d), torch.empty_like(ws)
        assert ctx.libs[1].rwkv6_chunk_bwd(*[x.data_ptr() for x in (
            r, k, v, w, u, ws, do, ds_t, dws, *grads, du_part, ds0)],
            b * h, h, t, d, None) == 0
        du = du_part.view(b, h, -1, d).sum((0, 2))
        return (None, *grads, du, ds0)


@pytest.mark.parametrize("d", [16, 32])
def test_wkv6_pad_route_emulated(emulated, d):
    """Head dim ``d`` through the pad route as the wrapper's autograd path
    composes it (``pad_inputs`` to ``padded_head_dim(d)`` = 64, the
    chunked kernels there, ``o`` and ``S_T`` sliced back to ``d``), from a
    non-zero ``s0`` with a non-zero ``dS_T``, on the emulated kernels:
    ``o``, ``S_T`` and all six gradients against the plain version at
    ``d`` (and its autograd) within ``WKV_TOL``; ``T`` = 70, a ragged
    second chunk."""
    assert trwkv.padded_head_dim(d) == 64
    b, h, t = 1, 2, 70
    gen = torch.Generator().manual_seed(d)
    r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen)
               for _ in range(3))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(b, h, t, d,
                                                      generator=gen)))
    u = 0.3 * torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    do = torch.randn(b, h, t, d, generator=gen)
    ds_t = 0.1 * torch.randn(b, h, d, d, generator=gen)
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s0)]
    o, s_t = _EmulatedWKV6.apply(emulated, *trwkv.pad_inputs(*ins, 64))
    o, s_t = o[..., :d], s_t[..., :d, :d]
    grads = torch.autograd.grad((o, s_t), ins, (do, ds_t))
    want_o, want_s = rwkv6_chunk_plain(r, k, v, w, u, s0,
                                       chunk=trwkv.CHUNK)
    want = rwkv6_chunk_grads(r, k, v, w, u, s0, do, ds_t)
    for name, a, x in zip(("o", "S_T", "dr", "dk", "dv", "dw", "du", "ds0"),
                          (o, s_t) + grads, (want_o, want_s) + tuple(want)):
        scale = max(1.0, x.abs().max().item())
        torch.testing.assert_close(
            a.detach() / scale, x / scale, rtol=WKV_TOL, atol=WKV_TOL,
            msg=lambda m: f"d = {d} {name} (scaled by {scale:.3g}): {m}")


def test_wkv6_block_route_emulated(emulated):
    """D = 256 through ``fold_blocks`` over the emulated chunked kernels at
    ``BLOCK_DIM`` (the wrapper's autograd route: 4 block pairs folded into
    the head axis), from a non-zero ``s0`` with a non-zero ``dS_T``:
    ``o``, ``S_T`` and all six gradients against the plain version at 256
    within ``WKV_TOL``; T = 40, one partial chunk (the fold does not touch
    the time axis; ``test_wkv6_pad_route_emulated`` carries a state across
    chunks in these kernels, ``tests/test_torch_wide_heads.py`` across
    chunks through the fold)."""
    b, h, t, d = 1, 1, 40, 256
    gen = torch.Generator().manual_seed(d)
    r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen)
               for _ in range(3))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(b, h, t, d,
                                                      generator=gen)))
    u = 0.3 * torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    do = torch.randn(b, h, t, d, generator=gen)
    ds_t = 0.1 * torch.randn(b, h, d, d, generator=gen)
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s0)]
    o, s_t = trwkv.fold_blocks(lambda *x: _EmulatedWKV6.apply(emulated, *x),
                               *ins)
    grads = torch.autograd.grad((o, s_t), ins, (do, ds_t))
    want = (rwkv6_chunk_plain(r, k, v, w, u, s0, chunk=trwkv.CHUNK)
            + tuple(rwkv6_chunk_grads(r, k, v, w, u, s0, do, ds_t)))
    for name, a, x in zip(("o", "S_T", "dr", "dk", "dv", "dw", "du", "ds0"),
                          (o, s_t) + grads, want):
        scale = max(1.0, x.abs().max().item())
        torch.testing.assert_close(
            a.detach() / scale, x / scale, rtol=WKV_TOL, atol=WKV_TOL,
            msg=lambda m: f"{name} (scaled by {scale:.3g}): {m}")


@pytest.mark.parametrize("d,want", [(8, 64), (16, 64), (32, 64), (48, 64),
                                    (64, 64), (96, 128), (128, 128)])
def test_padded_head_dim(d, want):
    """The head dim each ``D`` runs at: itself in ``HEAD_DIMS``, else the
    next one above; past 128 the block route's ``BLOCK_DIM``."""
    assert trwkv.padded_head_dim(d) == want


def test_padded_head_dim_refuses_past_128():
    """Past 128 a head dim no longer raises: it takes the block route, in
    blocks of ``BLOCK_DIM`` (``tests/test_torch_wide_heads.py``,
    ``..._emulated.py``); a head dim below 1 still raises."""
    assert trwkv.padded_head_dim(160) == trwkv.BLOCK_DIM
    with pytest.raises(ValueError, match="at least 1"):
        trwkv.padded_head_dim(0)


def test_pad_inputs_are_exact_in_the_plain_version():
    """The padded inputs through the plain version at 64, sliced back,
    equal the plain version at the given head dim: the zero ``k`` columns
    keep their state rows zero under ``w`` = 1, the zero ``v`` columns
    give zero outputs, the zero ``r`` columns read nothing."""
    gen = torch.Generator().manual_seed(5)
    b, h, t, d = 2, 3, 40, 16
    r, k, v = (torch.randn(b, h, t, d, generator=gen) for _ in range(3))
    w = torch.rand(b, h, t, d, generator=gen) * 0.9 + 0.05
    u = torch.randn(h, d, generator=gen)
    s0 = torch.randn(b, h, d, d, generator=gen)
    o, s = rwkv6_chunk_plain(*trwkv.pad_inputs(r, k, v, w, u, s0, 64))
    want_o, want_s = rwkv6_chunk_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(o[..., :d], want_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s[..., :d, :d], want_s, rtol=1e-6, atol=1e-6)
    assert not o[..., d:].any() and not s[..., d:, :].any() \
        and not s[..., :, d:].any()

