"""The port's attention (``repro_torch.kernels.ref.flash_attention_ref``,
``repro_torch.models.attention``, ``repro_torch.kernels.dispatch``) against
the JAX reference, on the CPU.

Tolerances, each with its reason:
- the plain ``flash_attention_ref`` vs the reference's ``flash_attention_ref``:
  fp32 1e-5 (the same naive softmax, products summed in another order);
  bf16 one bf16 step at the output's magnitude, 1e-2 (both round the same
  fp32 result to bf16; a sum order difference can flip one rounding);
- vs the reference's Pallas kernel in interpret mode: the reference's own
  test tolerance, fp32 2e-3 / bf16 3e-2 (online vs full softmax);
- the chunked ``attention_ref`` and its gradients vs the reference's:
  fp32 1e-5 (the same chunked recurrence).

The CUDA kernels are held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import dispatch as tdispatch  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# the shapes of tests/test_kernels.py::test_flash_attention_sweep
KERNEL_CASES = [
    (2, 2, 256, 64, 0, 0.0, "float32"),
    (1, 3, 256, 128, 0, 0.0, "float32"),
    (1, 2, 256, 64, 128, 0.0, "float32"),     # sliding window
    (1, 2, 128, 64, 0, 50.0, "float32"),      # gemma softcap
    (1, 2, 256, 64, 0, 0.0, "bfloat16"),
]


def _qkv(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _pair(x, dtype):
    """The same values in both frameworks (bf16 rounds identically)."""
    return (jnp.asarray(x).astype(dtype),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,h,t,d,win,cap,dtype", KERNEL_CASES)
def test_flash_attention_ref_matches_reference(b, h, t, d, win, cap, dtype):
    """The plain version vs the reference's oracle and its Pallas kernel in
    interpret mode, at the reference's kernel-test shapes."""
    pairs = [_pair(x, dtype) for x in _qkv((b, h, t, d), seed=t + d + win)]
    jq, jk, jv = (p[0] for p in pairs)
    tq, tk, tv = (p[1] for p in pairs)
    got = tref.flash_attention_ref(tq, tk, tv, window=win, logit_softcap=cap)
    assert got.dtype == tq.dtype and got.shape == (b, h, t, d)
    oracle = jref.flash_attention_ref(jq, jk, jv, window=win,
                                      logit_softcap=cap)
    kernel = jflash.flash_attention(jq, jk, jv, window=win, logit_softcap=cap)
    fp32 = dtype == "float32"
    tol = 1e-5 if fp32 else 1e-2
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=tol, atol=tol)
    tol = 2e-3 if fp32 else 3e-2
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol, atol=tol)
    # on CPU tensors the kernel's entry IS the plain version
    before = tflash.flash_attention_fwd.launches
    routed = tflash.flash_attention(tq, tk, tv, window=win, logit_softcap=cap)
    assert torch.equal(routed, got)
    assert tflash.flash_attention_fwd.launches == before


GQA_CASES = [
    dict(kind="full"),
    dict(kind="swa", window=24),
    dict(kind="full", logit_softcap=30.0),
    dict(kind="chunked", window=16),
    dict(kind="full", chunk=24),              # ragged last chunk
]


def _gqa(b=2, t=64, h=4, kv=2, d=16, tq=None, seed=0):
    q = _qkv((b, tq or t, h, d), seed, 1)[0]
    k, v = _qkv((b, t, kv, d), seed + 1, 2)
    return q, k, v


@pytest.mark.parametrize("kw", GQA_CASES)
def test_attention_ref_matches_reference_gqa(kw):
    """``[B, T, H, D]`` GQA, every mask kind, softcap, ragged chunks; the
    dispatched entry on CPU tensors is exactly the plain version."""
    q, k, v = _gqa()
    ref = jattn.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    got = tattn.attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(tattn.attention(tq, tk, tv, **kw), got)


def test_attention_ref_matches_reference_with_q_offset():
    """A prefill continuation (``q_offset``, ``Tq < Tk``): the plain path on
    any device, as in the reference."""
    q, k, v = _gqa(tq=16)
    ref = jattn.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_offset=48)
    got = tdispatch.attention(*(torch.as_tensor(x) for x in (q, k, v)),
                              q_offset=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", GQA_CASES[:3])
def test_attention_ref_gradients_match_jax_grad(kw):
    """Autograd through the plain chunked version vs ``jax.grad`` of the
    reference's ``attention_ref``: dq, dk, dv of ``sum(out * g)``."""
    q, k, v = _gqa(seed=3)
    g = _qkv(q.shape, 7, 1)[0]

    def jloss(q_, k_, v_):
        return (jattn.attention_ref(q_, k_, v_, **kw) * g).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = tattn.attention_ref(*ts, **kw)
    tgrads = torch.autograd.grad((out * torch.as_tensor(g)).sum(), ts)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)


def test_dispatch_kernel_gate_and_layout(monkeypatch):
    """Which shapes go to the kernel, and the wrapper's GQA repeat and
    ``[B, T, H, D] <-> [B, H, T, D]`` transposes: the kernel entry is
    replaced by the plain ``flash_attention_ref`` on CPU tensors, so the
    kernel path must reproduce the reference's attention exactly up to
    the chunking (1e-5)."""
    calls = []

    def fake_kernel(q, k, v, *, causal, window, logit_softcap):
        calls.append((tuple(q.shape), window, logit_softcap))
        return tref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window,
                                        logit_softcap=logit_softcap)

    monkeypatch.setattr(tdispatch, "resolve_backend", lambda x: "kernel")
    monkeypatch.setattr(tflash, "flash_attention", fake_kernel)
    q, k, v = _gqa()
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    for kw in (dict(kind="full"), dict(kind="swa", window=24),
               dict(kind="full", logit_softcap=30.0)):
        calls.clear()
        got = tdispatch.attention(tq, tk, tv, **kw)
        assert len(calls) == 1 and calls[0][0] == (2, 4, 64, 16)
        ref = jattn.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    # the reference's plain-path shapes never reach the kernel
    calls.clear()
    tdispatch.attention(tq, tk, tv, kind="chunked", window=16)
    tdispatch.attention(tq[:, :16], tk, tv, q_offset=48)
    q2, k2, v2 = (torch.as_tensor(x) for x in _gqa(t=200))
    tdispatch.attention(q2, k2, v2)              # 200 % 128 != 0
    assert calls == []
    q3, k3, v3 = (torch.as_tensor(x) for x in _gqa(t=96))
    tdispatch.attention(q3, k3, v3)              # 96 % min(128, 96) == 0
    assert len(calls) == 1
    # only the explicit argument selects the plain version; the reference's
    # environment variable does not reach the port
    tdispatch.attention(q3, k3, v3, backend="torch")
    assert len(calls) == 1
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "xla")
    tdispatch.attention(q3, k3, v3)
    assert len(calls) == 2
    with pytest.raises(ValueError, match="unknown attention backend"):
        tdispatch.attention(q3, k3, v3, backend="xla")


def test_kernel_wrappers_refuse_cpu_and_meta_tensors():
    """No quiet fallback: the kernel wrappers take CUDA tensors only, and
    the entry refuses a device that is neither CPU nor CUDA."""
    x = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_fwd(x, x, x)
    m = torch.empty((1, 2, 64, 64), device="meta")
    with pytest.raises(ValueError):
        tflash.flash_attention(m, m, m)
    assert tdispatch.resolve_backend(x) == "torch"
    x4 = x.reshape(1, 64, 2, 64)                  # [B, T, H, D]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdispatch.attention(x4, x4, x4, backend="kernel")
