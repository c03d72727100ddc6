"""The CUDA flash-attention kernels' own source on the CPU, bf16 inputs:
the tensor-core kernels ``flash_fwd_tc``, ``flash_bwd_dq_tc`` and
``flash_bwd_dkdv_tc`` (``mma_bf16``, ``ldmatrix``, ``cp.async``) at head
dims 16 to 128, against the plain ``flash_attention_ref`` and its autograd
at the reference's kernel tolerance 3e-2 (``tests/_flash_emu_cases.py``
says how the source is built and called)."""
import pytest

torch = pytest.importorskip("torch")

import _flash_emu_cases as cases  # noqa: E402


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return cases.build(tmp_path_factory)


@pytest.mark.parametrize(cases.PARAMS, cases.BF16,
                         ids=[cases.ID(c) for c in cases.BF16])
def test_emulated_kernels_match_plain_version(emulated, bh, t, d, dtype,
                                              causal, window, cap, q_offset):
    cases.check_case(emulated, bh, t, d, dtype, causal, window, cap,
                     q_offset)
