"""The CUDA flash-attention kernels' own source on the CPU, fp32 inputs
(``tests/_flash_emu_cases.py`` says how the source is built and called, and
why each tolerance): the 3xTF32 tensor-core forward ``flash_fwd`` and
backward ``flash_bwd_dq`` and ``flash_bwd_dkdv``, against the plain
``flash_attention_ref`` and its autograd at 1e-5. Also the forward against
the JAX reference's Pallas kernel in interpret mode, the backward against
``jax.grad`` of the reference's plain attention, and the C interface's
refusal of a head dim it does not instantiate. bf16 cases are in
``test_torch_flash_emulated_bf16.py``, head dims 144, 256 and a padded one
in ``test_torch_flash_emulated_wide.py``. Whether the kernels compile for
``sm_90a``, and their speed, only a card can show
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _flash_emu_cases as cases  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402

# the emulated kernels vs the reference (the forward vs its Pallas kernel in
# interpret mode on the CPU, the backward vs jax.grad of its plain
# attention): fp32 throughout, the kernels' products 3xTF32 (about 21 bits
# of each operand) against XLA's fp32 dots
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return cases.build(tmp_path_factory)


@pytest.mark.parametrize(cases.PARAMS, cases.FP32,
                         ids=[cases.ID(c) for c in cases.FP32])
def test_emulated_kernels_match_plain_version(emulated, bh, t, d, dtype,
                                              causal, window, cap, q_offset):
    cases.check_case(emulated, bh, t, d, dtype, causal, window, cap,
                     q_offset)


def test_emulated_fp32_forward_matches_jax_kernel(emulated):
    """``[1, 128, 64]`` causal with a 48-step window: the 3xTF32 forward
    against ``repro.kernels.flash_attention.flash_attention`` on the same
    numpy inputs, within ``JAX_TOL``."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.normal(size=(1, 128, 64)).astype(np.float32)
                   for _ in range(4))
    (o, *_), routes = cases.run_kernels(
        emulated, *(torch.as_tensor(x) for x in (q, k, v, do)), 64,
        causal=True, window=48, cap=0.0)
    assert routes[0][0] == 128 and routes[0][1] > 0
    want = jflash.flash_attention(*(jnp.asarray(x)[None] for x in (q, k, v)),
                                  causal=True, window=48)
    np.testing.assert_allclose(o.numpy(), np.asarray(want)[0],
                               rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_emulated_fp32_backward_matches_jax_grad(emulated, cap):
    """``[1, 128, 64]`` causal with a 48-step window, without and with
    softcap 50: the 3xTF32 dq, dk and dv against ``jax.grad`` of
    ``repro.kernels.ref.flash_attention_ref`` on the same numpy inputs,
    within ``JAX_TOL``."""
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.normal(size=(1, 128, 64)).astype(np.float32)
                   for _ in range(4))
    (_, _, dq, _, dk, dv), routes = cases.run_kernels(
        emulated, *(torch.as_tensor(x) for x in (q, k, v, do)), 64,
        causal=True, window=48, cap=cap)
    assert all(th == 128 and mmas > 0 for th, mmas in routes), routes

    def loss(q, k, v):
        o = jref.flash_attention_ref(q, k, v, causal=True, window=48,
                                     logit_softcap=cap)
        return jnp.sum(o * jnp.asarray(do)[None])

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x)[None] for x in (q, k, v)))
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0],
                                   rtol=JAX_TOL, atol=JAX_TOL)


def test_emulated_launch_refuses_an_unsupported_head_dim(emulated):
    """Past the largest instantiation the C interface refuses (-1): an
    fp32 head dim above 256 runs in the wide-head route's library, padded
    to a multiple of 128, and a bf16 one raises before any launch, naming
    the gap; the self-attention library refuses an offset call (-2: the
    offset route's library takes it)."""
    x = torch.zeros(1, 64, 272)
    lse = torch.empty(1, 64)
    assert emulated.flash_attention_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), 1, 64, 64, 0, 272, 0, 1, 0, 0.0, 272 ** -0.5,
        None) == -1
    assert emulated.flash_attention_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
        lse.data_ptr(), 1, 32, 64, 32, 64, 0, 1, 0, 0.0, 0.125, None) == -2
    assert tflash.padded_head_dim(272) == 384
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        tflash.padded_head_dim(272, torch.bfloat16)
