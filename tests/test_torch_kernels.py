"""The port's fused aggregation (``repro_torch.kernels``) against the JAX
reference: its plain version (what the wrapper runs on CPU tensors, and
what the Triton kernel is held to on the card) vs the reference's Pallas
kernel in interpret mode and vs ``repro.kernels.ref``.

Tolerance: rtol 1e-5 / atol 1e-6. Both sides compute in fp32 from the same
inputs (bf16 inputs are upcast to the same fp32 values on both sides); the
only difference is the order of the sums over at most B*m = 32 terms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import masked_agg as jmasked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.kernels import masked_agg as tmasked  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _inputs(B, m, n, seed, mask_kind="random", ops=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, m, n)).astype(np.float32)
    prev = rng.normal(size=(B, n)).astype(np.float32)
    p = rng.uniform(0.0, 1.0, size=(B, m)).astype(np.float32)
    p[:, 0] = 1e-4                      # exercises the max(p, 1e-3) clip
    if mask_kind == "random":
        mask = rng.uniform(size=(B, m)) < 0.5
    elif mask_kind == "none":
        mask = np.zeros((B, m), bool)
    else:
        mask = np.ones((B, m), bool)
    if ops is None:
        ops = np.arange(B) % 3
    return x, mask, np.asarray(ops, np.int32), prev, p


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("B,m,n", [(4, 8, 300), (3, 5, 128), (2, 16, 7)])
@pytest.mark.parametrize("mask_kind", ["random", "none", "all"])
def test_fused_ref_matches_interpret_kernel_and_ref(B, m, n, mask_kind):
    """Every op, ragged n, zero-active and all-active trajectories, batched
    form: port plain version vs Pallas interpret and vs the jnp oracle."""
    x, mask, ops, prev, p = _inputs(B, m, n, seed=B * 100 + m + n,
                                    mask_kind=mask_kind)
    got = tref.fused_masked_agg_ref(_t(x), _t(mask), _t(ops), _t(prev),
                                    _t(p)).numpy()
    kern = np.asarray(jmasked.fused_masked_agg(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ops),
        jnp.asarray(prev), jnp.asarray(p), block_n=128, interpret=True))
    oracle = np.asarray(jref.fused_masked_agg_ref(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ops),
        jnp.asarray(prev), jnp.asarray(p)))
    assert got.dtype == np.float32 and got.shape == (B, n)
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    if mask_kind == "none":   # zero-active: mean branch keeps prev exactly
        mean_rows = ops == tref.OP_MEAN
        np.testing.assert_array_equal(got[mean_rows], prev[mean_rows])


@pytest.mark.parametrize("op", [0, 1, 2])
def test_fused_ref_two_dim_form_matches_batched(op):
    """The ``[m, n]`` single-trajectory form with a scalar op equals row 0
    of the batched form, and the reference's 2-D interpret kernel."""
    x, mask, _, prev, p = _inputs(1, 6, 200, seed=7 + op)
    got = tref.fused_masked_agg_ref(_t(x[0]), _t(mask[0]), op, _t(prev[0]),
                                    _t(p[0])).numpy()
    batched = tref.fused_masked_agg_ref(_t(x), _t(mask),
                                        _t(np.array([op], np.int32)),
                                        _t(prev), _t(p)).numpy()[0]
    kern = np.asarray(jmasked.fused_masked_agg(
        jnp.asarray(x[0]), jnp.asarray(mask[0]), op, jnp.asarray(prev[0]),
        jnp.asarray(p[0]), block_n=128, interpret=True))
    np.testing.assert_array_equal(got, batched)
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)


def test_fused_ref_bf16_input_accumulates_in_fp32():
    """bf16 client params: both sides upcast the same bf16 values to fp32
    and accumulate in fp32, so fp32 tolerance holds."""
    x, mask, ops, prev, p = _inputs(3, 8, 260, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xb32 = np.asarray(xb.astype(jnp.float32))
    got = tref.fused_masked_agg_ref(_t(xb32).to(torch.bfloat16), _t(mask),
                                    _t(ops), _t(prev), _t(p))
    assert got.dtype == torch.float32
    kern = np.asarray(jmasked.fused_masked_agg(
        xb, jnp.asarray(mask), jnp.asarray(ops), jnp.asarray(prev),
        jnp.asarray(p), block_n=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("mask_kind", ["random", "none"])
def test_masked_agg_ref_matches_reference(with_prev, mask_kind):
    """``masked_agg``: prev=None gives zeros on an empty set, prev gives
    prev; vs the Pallas interpret kernel and the jnp oracle."""
    x, mask, _, prev, _ = _inputs(1, 9, 333, seed=3, mask_kind=mask_kind)
    x, mask, prev = x[0], mask[0], prev[0]
    pv = prev if with_prev else None
    got = tref.masked_agg_ref(_t(x), _t(mask),
                              None if pv is None else _t(pv)).numpy()
    jpv = None if pv is None else jnp.asarray(pv)
    kern = np.asarray(jmasked.masked_agg(jnp.asarray(x), jnp.asarray(mask),
                                         jpv, block_n=128, interpret=True))
    oracle = np.asarray(jref.masked_agg_ref(jnp.asarray(x),
                                            jnp.asarray(mask), jpv))
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    if mask_kind == "none":
        np.testing.assert_array_equal(got, prev if with_prev else 0 * prev)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    """On CPU tensors the wrapper IS the plain version, launches nothing,
    and ``masked_agg`` is its OP_MEAN case."""
    x, mask, ops, prev, p = _inputs(3, 8, 100, seed=5)
    before = tmasked.fused_masked_agg.launches
    got = tmasked.fused_masked_agg(_t(x), _t(mask), _t(ops), _t(prev), _t(p))
    want = tref.fused_masked_agg_ref(_t(x), _t(mask), _t(ops), _t(prev),
                                     _t(p))
    assert torch.equal(got, want)
    assert torch.equal(tmasked.masked_agg(_t(x[0]), _t(mask[0])),
                       tref.masked_agg_ref(_t(x[0]), _t(mask[0])))
    assert torch.equal(tdispatch.fused_agg(_t(x), _t(mask), _t(ops),
                                           _t(prev), _t(p)), want)
    assert tmasked.fused_masked_agg.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 37, 100, 1000])
def test_block_sizes_are_powers_of_two_with_16_byte_rows(m, dtype):
    """The launch's block sizes: powers of two, every client row of a tile
    in use up to 16 rows (m = 8 takes one 8-row tile), and each thread of
    the program loading 16 contiguous bytes of every row of a tile."""
    block_m, block_n, num_warps = tmasked.block_sizes(m, dtype)
    for size in (block_m, block_n, num_warps):
        assert size > 0 and size & (size - 1) == 0
    assert min(m, 16) <= block_m <= 16
    assert block_m < 2 * m or m >= 16
    assert block_n * dtype.itemsize == 32 * num_warps * 16


def test_wrapper_and_dispatch_refuse_other_devices():
    """No quiet fallback: a tensor that is neither on the CPU nor on a card
    raises instead of running anything."""
    x = torch.empty((2, 4, 8), device="meta")
    mask = torch.empty((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tmasked.fused_masked_agg(x, mask, mask, x[:, 0], mask)
    with pytest.raises(ValueError):
        tdispatch.resolve_backend(x)
    assert tdispatch.resolve_backend(torch.zeros(1)) == "torch"


def test_dispatch_use_kernel_env_and_ops_table(monkeypatch):
    from repro.kernels import dispatch as jdispatch

    monkeypatch.delenv("REPRO_USE_KERNEL", raising=False)
    assert tdispatch.resolve_use_kernel() is False
    monkeypatch.setenv("REPRO_USE_KERNEL", "1")
    assert tdispatch.resolve_use_kernel() is True
    assert tdispatch.resolve_use_kernel(False) is False
    assert tdispatch.FUSED_OPS == jdispatch.FUSED_OPS
    assert (tref.OP_MEAN, tref.OP_ALL, tref.OP_KNOWN_P) == (
        jmasked.OP_MEAN, jmasked.OP_ALL, jmasked.OP_KNOWN_P)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,n", [(12, 100, 2762), (3, 37, 1000)])
def test_triton_kernel_matches_plain_version_on_card(cuda, B, m, n):
    """The kernel vs its plain version on the card: fp32 1e-5 (summation
    order over <= 100 terms), bf16 input 2e-2."""
    x, mask, ops, prev, p = _inputs(B, m, n, seed=1)
    mask[0] = False
    args = [_t(a).to(cuda) for a in (x, mask, ops, prev, p)]
    got = tmasked.fused_masked_agg(*args)
    want = tref.fused_masked_agg_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    xb = args[0].to(torch.bfloat16)
    got = tmasked.fused_masked_agg(xb, *args[1:])
    want = tref.fused_masked_agg_ref(xb, *args[1:])
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    got = tmasked.masked_agg(args[0][0], args[1][0])
    torch.testing.assert_close(got, tref.masked_agg_ref(args[0][0],
                                                        args[1][0]),
                               rtol=1e-5, atol=1e-5)
