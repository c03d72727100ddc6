"""The CUDA flash-attention kernels' own source on the CPU at head dims 144
(the LM sweep at lm_d_model 576) and 256 (gemma2-9b), both dtypes, and at a
head dim (40) that the wrapper zero-pads to 64, against the plain
``flash_attention_ref`` and its autograd (fp32 1e-5, bf16 3e-2;
``tests/_flash_emu_cases.py`` says how the source is built and called)."""
import pytest

torch = pytest.importorskip("torch")

import _flash_emu_cases as cases  # noqa: E402


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return cases.build(tmp_path_factory)


@pytest.mark.parametrize(cases.PARAMS, cases.WIDE,
                         ids=[cases.ID(c) for c in cases.WIDE])
def test_emulated_kernels_match_plain_version(emulated, bh, t, d, dtype,
                                              causal, window, cap, q_offset):
    cases.check_case(emulated, bh, t, d, dtype, causal, window, cap,
                     q_offset)
