"""The Mamba block and cross-attention of the port against the JAX
reference on the CPU: ``repro_torch.models.ssm`` against
``repro.models.ssm`` and ``repro_torch.models.attention.cross_attention``
against ``repro.models.attention.cross_attention``, at jamba's reduced
widths (d_model 256, d_inner 512, N 8, dt rank 16, conv width 4).

Tolerances, each with its reason:
- fp32 ``ssm_apply`` (output, ``h_T``, conv state) and ``cross_attention``:
  atol = rtol = 1e-5, the same fp32 products in another order (the
  doubling scan combines the steps in another tree than
  ``lax.associative_scan``);
- the doubling scan against the port's own step recurrence: 1e-5, the
  same reason;
- bf16 ``ssm_apply``: 2e-2 of the largest output, a bf16 step or two
  (``tests/test_torch_decode.py``'s bf16 bar);
- the port's own init of the deterministic leaves: within one fp32 ulp
  (rtol 2e-7) of the reference's: ``log`` of XLA and of PyTorch round
  ``log(7)`` to neighbouring floats (weights carried across by
  ``convert`` are bit for bit).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np_tree  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5


def _cfgs(dtype="float32"):
    return [dataclasses.replace(red(get(ARCH)), dtype=dtype)
            for get, red in ((jget_config, jreduced), (get_config, reduced))]


def _block(dtype="float32", seed=1):
    """The reference's SSM leaves at ``seed`` and the port's copy (the fp32
    leaves in fp32, the rest in ``dtype``)."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg)
    tp = {}
    for name, leaf in np_tree(jp).items():
        arr = np.array(leaf, dtype=np.float32)
        dt = torch.float32 if name in tssm.FP32_LEAVES else getattr(torch,
                                                                    dtype)
        tp[name] = torch.as_tensor(arr).to(dt)
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def test_leaves_and_init_match_reference():
    """Leaf names, shapes and dtypes (fp32 leaves in a bf16 model) as the
    reference's ``ssm_init``; the deterministic leaves equal its values."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = np_tree(jssm.ssm_init(jax.random.PRNGKey(0), jcfg))
    tp = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg)
    assert list(tp) == [n for n, _ in tssm.ssm_leaves(tcfg)]
    assert sorted(tp) == sorted(jp)
    for name, leaf in tp.items():
        assert tuple(leaf.shape) == jp[name].shape, name
        want = torch.float32 if name in tssm.FP32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, name
    for name in ("conv_bias", "dt_bias", "a_log", "d_skip"):
        np.testing.assert_allclose(tp[name].float().numpy(),
                                   np.asarray(jp[name], np.float32),
                                   rtol=2e-7, atol=0)
    assert tssm._dims(tcfg) == jssm._dims(jcfg)


def test_ssm_apply_prefill_with_a_ragged_chunk_matches_reference():
    """T = 40 in chunks of 16 (a ragged last chunk of 8), state None:
    output, ``h_T`` and the conv state."""
    jcfg, tcfg, jp, tp = _block()
    x = np.random.default_rng(0).normal(size=(2, 40, tcfg.d_model)).astype(
        np.float32)
    want, wst = jssm.ssm_apply(jp, jnp.asarray(x), jcfg, chunk=16)
    got, st = tssm.ssm_apply(tp, torch.as_tensor(x), tcfg, chunk=16)
    _close(got, want)
    _close(st["h"], wst["h"])
    _close(st["conv"], wst["conv"])
    # the same sequence in one chunk
    got1, st1 = tssm.ssm_apply(tp, torch.as_tensor(x), tcfg, chunk=128)
    torch.testing.assert_close(got1, got, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st1["h"], st["h"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 5])
def test_ssm_apply_from_a_given_state_matches_reference(t):
    """The decode carry: a random ``conv`` / ``h`` state, then T = 1 (the
    decode step, a chunk of 1) and T = 5."""
    jcfg, tcfg, jp, tp = _block(seed=2)
    di, n, _, cw = tssm._dims(tcfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, t, tcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, cw - 1, di)).astype(np.float32)
    h = rng.normal(size=(2, di, n)).astype(np.float32)
    want, wst = jssm.ssm_apply(jp, jnp.asarray(x), jcfg,
                               state={"conv": jnp.asarray(conv),
                                      "h": jnp.asarray(h)})
    got, st = tssm.ssm_apply(tp, torch.as_tensor(x), tcfg,
                             state={"conv": torch.as_tensor(conv),
                                    "h": torch.as_tensor(h)})
    _close(got, want)
    _close(st["h"], wst["h"])
    _close(st["conv"], wst["conv"])


def test_ssm_init_state_matches_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    want = jssm.ssm_init_state(jcfg, 3)
    got = tssm.ssm_init_state(tcfg, 3)
    for k in ("conv", "h"):
        assert tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
    assert got["conv"].dtype == torch.bfloat16
    assert got["h"].dtype == torch.float32


def test_ssm_apply_in_bf16_matches_reference():
    """bf16 activations with the fp32 leaves: T = 40, chunks of 16."""
    jcfg, tcfg, jp, tp = _block("bfloat16", seed=3)
    x = np.random.default_rng(2).normal(size=(2, 40, tcfg.d_model))
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    tx = torch.as_tensor(np.array(jx, dtype=np.float32)).bfloat16()
    want, wst = jssm.ssm_apply(jp, jx, jcfg, chunk=16)
    got, st = tssm.ssm_apply(tp, tx, tcfg, chunk=16)
    assert got.dtype == torch.bfloat16 and st["conv"].dtype == torch.bfloat16
    w = np.asarray(want, dtype=np.float32)
    assert np.abs(got.float().numpy() - w).max() / np.abs(w).max() < 2e-2
    h = np.asarray(wst["h"])
    assert np.abs(st["h"].numpy() - h).max() / np.abs(h).max() < 2e-2


@pytest.mark.parametrize("t,chunk", [(1, 128), (37, 8), (64, 16), (50, 64)])
def test_doubling_scan_matches_the_step_recurrence(t, chunk):
    """``selective_scan`` (chunks, doubling scan inside each) against the
    plain step-by-step recurrence, from a nonzero state, at ragged and
    whole chunks."""
    rng = np.random.default_rng(t)
    b, di, n = 2, 24, 8

    def f(*shape, lo=None, hi=None):
        a = (rng.uniform(lo, hi, size=shape) if lo is not None
             else rng.normal(size=shape))
        return torch.as_tensor(a, dtype=torch.float32)

    xc, b_in, c_in = f(b, t, di), f(b, t, n), f(b, t, n)
    dt = f(b, t, di, lo=1e-3, hi=0.5)
    a = -f(di, n, lo=0.5, hi=8.0)
    h0 = f(b, di, n)
    y, h = tssm.selective_scan(xc, dt, b_in, c_in, a, h0, chunk)
    y_ref, h_ref = tssm.selective_scan_steps(xc, dt, b_in, c_in, a, h0)
    torch.testing.assert_close(y, y_ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(h, h_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tq,q_chunk,dtype", [
    (40, 16, "float32"),        # ragged: 16 + 16 + 8
    (12, 512, "float32"),       # one chunk
    (40, 16, "bfloat16")])      # bf16 queries against fp32 memory k / v
def test_cross_attention_matches_reference(tq, q_chunk, dtype):
    """GQA (4 query heads on 2 KV heads), 24 memory tokens; the output in
    ``q.dtype``."""
    rng = np.random.default_rng(tq)
    q = rng.normal(size=(2, tq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 32)).astype(np.float32)
            for _ in range(2))
    jq = jnp.asarray(q, dtype=dtype)
    tq_ = torch.as_tensor(np.array(jq, dtype=np.float32)).to(
        getattr(torch, dtype))
    want = jattn.cross_attention(jq, jnp.asarray(k), jnp.asarray(v),
                                 q_chunk=q_chunk)
    got = tattn.cross_attention(tq_, torch.as_tensor(k), torch.as_tensor(v),
                                q_chunk=q_chunk)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    # bf16: the fp32 results agree, then each rounds to bf16 (one ulp)
    tol = TOL if dtype == "float32" else 1e-2
    _close(got, want, tol)
