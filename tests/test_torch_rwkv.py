"""The port's RWKV6 serving slice (``configs``, ``kernels.ref`` /
``dispatch.wkv6``, ``models.rwkv``, the rwkv family of ``models.model``,
``convert.lm_leaves_from_jax``, ``launch.serve``) against the JAX reference
on the CPU, at ``reduced(rwkv6-3b)`` (2 layers, d_model 256, 4 heads of 64)
in fp32. On the CPU the WKV6 recurrence is the kernel's plain chunked
version; the kernel itself is checked in ``test_torch_rwkv_emulated.py``
and on the card.

Inputs are numpy, made from seeds, and handed to both packages. The WKV
inputs follow ``tests/test_kernels.py::test_rwkv6_chunk_sweep`` (r, k, v ~
0.5 N(0, 1), w = exp(-exp(-3 + 0.5 N(0, 1))), u ~ 0.3 N, s0 ~ 0.1 N);
"strong" decay draws w uniform in [1e-3, 0.1].

Tolerances, each with its reason:
- configs, converted leaves: exact (the same numbers);
- the WKV function: fp32 atol and rtol 1e-4, the reference's kernel
  tolerance (3e-3) tightened to ten times the largest error measured
  (8.6e-6 at |o| up to 22: the same arithmetic in another order);
- the mixes, logits, decode logits: fp32 1e-4 (products and reductions in
  another order through 2 layers; 2.0e-5 measured at most);
- decode against forward: relative 2e-3, the reference's own bar
  (``tests/test_decode_consistency.py``).
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
from repro.kernels.ref import rwkv6_chunk_ref as jrwkv6_chunk_ref  # noqa: E402
from repro.kernels.rwkv6_chunk import rwkv6_chunk as jrwkv6_chunk  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as kwkv  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    rwkv6_chunk_plain,
    rwkv6_chunk_ref,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

ARCH = "rwkv6-3b"
WKV_TOL = 1e-4
TOL = 1e-4


def _cfgs(dtype="float32"):
    j = dataclasses.replace(jreduced(jget_config(ARCH)), dtype=dtype)
    t = dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype)
    return j, t


def wkv_inputs(b, h, t, d, decay="ref", seed=0):
    rng = np.random.default_rng(seed + 7 * t + d)
    r, k, v = (0.5 * rng.standard_normal((b, h, t, d)) for _ in range(3))
    if decay == "ref":
        w = np.exp(-np.exp(-3.0 + 0.5 * rng.standard_normal((b, h, t, d))))
    else:
        w = rng.uniform(1e-3, 0.1, (b, h, t, d))
    u = 0.3 * rng.standard_normal((h, d))
    s0 = 0.1 * rng.standard_normal((b, h, d, d))
    return tuple(x.astype(np.float32) for x in (r, k, v, w, u, s0))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=tol, atol=tol)


def _tr(x):                                  # [B,H,T,D] <-> [B,T,H,D]
    return x.transpose(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_config_matches_reference():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert tc.param_count() == jc.param_count() == 3_072_494_080
    assert [tc.layer_kind(i) for i in range(3)] == ["rwkv"] * 3
    tr, jr = reduced(tc), jreduced(jc)
    assert dataclasses.asdict(tr.rwkv) == dataclasses.asdict(jr.rwkv)
    assert tr.rwkv.head_dim == 64 and tr.rwkv.decay_lora == 16
    assert tr.param_count() == jr.param_count()


# ---------------------------------------------------------------------------
# the WKV function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,t,d", [(1, 1, 64, 64), (2, 2, 128, 64),
                                     (1, 2, 256, 128), (1, 1, 192, 64)])
def test_plain_wkv_matches_the_reference_implementations(b, h, t, d):
    """The port's plain chunked WKV (what dispatch.wkv6 runs on CPU
    tensors) vs the JAX Pallas kernel in interpret mode, the reference
    model's ``_wkv_chunk_scan`` and the step scan, at the reference's
    kernel-test shapes and decays; the port's step scan vs the JAX one."""
    ins = wkv_inputs(b, h, t, d)
    o, s = dispatch.wkv6(*map(torch.as_tensor, ins))
    jins = tuple(map(jnp.asarray, ins))
    ok, sk = jrwkv6_chunk(*jins, chunk=64)
    om, sm = jrwkv._wkv_chunk_scan(*map(_tr, jins[:4]), jins[4], jins[5])
    orf, srf = jrwkv6_chunk_ref(*jins)
    for want_o, want_s in ((ok, sk), (_tr(om), sm), (orf, srf)):
        _close(o, want_o, WKV_TOL)
        _close(s, want_s, WKV_TOL)
    o2, s2 = rwkv6_chunk_ref(*map(torch.as_tensor, ins))
    _close(o2, orf, WKV_TOL)
    _close(s2, srf, WKV_TOL)


def test_plain_wkv_is_finite_at_strong_decay_where_the_reference_overflows():
    """w in [1e-3, 0.1]: the port's chunked version (exponents <= 0) stays
    finite and matches the step scan; the reference's chunked code, whose
    ``k * exp(-cumsum(log w))`` overflows fp32 within a 64-step chunk,
    returns NaN (a fact of the reference, ROADMAP Queue 3)."""
    ins = wkv_inputs(1, 2, 128, 64, decay="strong")
    o, s = rwkv6_chunk_plain(*map(torch.as_tensor, ins))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    jins = tuple(map(jnp.asarray, ins))
    orf, srf = jrwkv6_chunk_ref(*jins)
    _close(o, orf, WKV_TOL)
    _close(s, srf, WKV_TOL)
    ok, _ = jrwkv6_chunk(*jins, chunk=64)
    om, _ = jrwkv._wkv_chunk_scan(*map(_tr, jins[:4]), jins[4], jins[5])
    assert not np.isfinite(np.asarray(ok)).all()
    assert not np.isfinite(np.asarray(om)).all()


@pytest.mark.parametrize("t,decay", [(1, "ref"), (80, "ref"), (100, "strong"),
                                     (37, "ref")])
def test_plain_wkv_ragged_and_single_step(t, decay):
    """Any T >= 1 with no padding: against the step scan, and against the
    reference model's scan (which pads with w = 1) where it is finite."""
    ins = wkv_inputs(2, 2, t, 64, decay=decay)
    o, s = rwkv6_chunk_plain(*map(torch.as_tensor, ins))
    jins = tuple(map(jnp.asarray, ins))
    orf, srf = jrwkv6_chunk_ref(*jins)
    _close(o, orf, WKV_TOL)
    _close(s, srf, WKV_TOL)
    if decay == "ref":
        om, sm = jrwkv._wkv_chunk_scan(*map(_tr, jins[:4]), jins[4],
                                       jins[5])
        _close(o, _tr(om), WKV_TOL)
        _close(s, sm, WKV_TOL)


def test_wkv6_dispatch_backends_on_cpu():
    ins = tuple(map(torch.as_tensor, wkv_inputs(1, 2, 16, 64)))
    want = rwkv6_chunk_plain(*ins)
    for got in (dispatch.wkv6(*ins), dispatch.wkv6(*ins, backend="torch")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dispatch.wkv6(*ins, backend="kernel")
    with pytest.raises(ValueError, match="unknown"):
        dispatch.wkv6(*ins, backend="xla")



def test_wkv6_routes_by_length_and_cpu_tensors_take_the_plain_version():
    """``route_for`` sends T <= STEP_MAX_T to the step kernel and longer T
    to the chunked one; on CPU tensors either route is the plain version,
    and an unknown route raises."""
    assert [kwkv.route_for(t) for t in (1, kwkv.STEP_MAX_T,
                                        kwkv.STEP_MAX_T + 1, 4096)] == \
        ["step", "step", "chunked", "chunked"]
    ins = tuple(map(torch.as_tensor, wkv_inputs(1, 2, 16, 64)))
    want = rwkv6_chunk_plain(*ins)
    for route in kwkv.ROUTES:
        got = kwkv.rwkv6_chunk(*ins, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="route"):
        kwkv.rwkv6_chunk(*ins, route="scan")


# ---------------------------------------------------------------------------
# the mixes and the model
# ---------------------------------------------------------------------------


def _ref_params(dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(dtype)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, convert.lm_leaves_from_jax(np_tree(params),
                                                          tcfg)


def _layer0(jparams):
    """The reference's first layer's tmix dict, and the port's."""
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][0]["tmix"])
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_time_and_channel_mix_match_reference(with_state):
    jcfg, tcfg, jparams, _ = _ref_params()
    jp, tp = _layer0(jparams)
    # the reference's init leaves the decay LoRA near decay_base; give it
    # data-dependent decays as trained weights would
    rng = np.random.default_rng(3)
    for name in ("decay_base", "bonus_u", "ln_x"):
        jp[name] = jp[name] + 0.5 * rng.standard_normal(
            jp[name].shape).astype(np.float32)
        tp[name] = torch.as_tensor(np.asarray(jp[name]))
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    jstate = tstate = None
    cstate = None
    if with_state:
        nh = tcfg.d_model // tcfg.rwkv.head_dim
        hd = tcfg.rwkv.head_dim
        s = 0.1 * rng.standard_normal((2, nh, hd, hd)).astype(np.float32)
        last = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jstate = {"s": jnp.asarray(s), "last": jnp.asarray(last)}
        tstate = {"s": torch.as_tensor(s), "last": torch.as_tensor(last)}
        cstate = last
    jo, jst = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), jcfg, state=jstate)
    to, tst = trwkv.rwkv_time_mix(tp, torch.as_tensor(x), tcfg, state=tstate)
    _close(to, jo)
    _close(tst["s"], jst["s"])
    _close(tst["last"], jst["last"])
    jc, jlast = jrwkv.rwkv_channel_mix(
        jp, jnp.asarray(x), state=None if cstate is None
        else jnp.asarray(cstate))
    tc, tlast = trwkv.rwkv_channel_mix(
        tp, torch.as_tensor(x), state=None if cstate is None
        else torch.as_tensor(cstate))
    _close(tc, jc)
    _close(tlast, jlast)


def test_converted_fp32_leaves_are_bit_equal_in_a_bf16_model():
    """A bf16 reference model: every leaf converts exactly, and the fp32
    leaves (decay base, bonus, ln_x) stay fp32, bit for bit; one flat bf16
    buffer would round them, so ``flatten`` refuses."""
    jcfg, tcfg, jparams, leaves = _ref_params("bfloat16")
    rng = np.random.default_rng(1)
    for name in ("decay_base", "bonus_u", "ln_x"):          # not bf16-exact
        jparams["blocks"][0]["tmix"][name] = jnp.asarray(
            rng.standard_normal(jparams["blocks"][0]["tmix"][name].shape),
            jnp.float32)
    leaves = convert.lm_leaves_from_jax(np_tree(jparams), tcfg)
    layout = tmodel.param_layout(tcfg)
    ref = convert.flatten_tree(np_tree(jparams))
    assert set(ref) == set(leaves)
    for name, got in leaves.items():
        want = np.asarray(ref[name])
        if name in layout.fp32:
            assert got.dtype == torch.float32 and want.dtype == np.float32
            assert np.array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32)), name
        else:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
    assert {n.rsplit(".", 1)[-1] for n in layout.fp32} == {
        "decay_base", "bonus_u", "ln_x"}
    with pytest.raises(ValueError, match="fp32 leaves"):
        convert.lm_params_from_jax(np_tree(jparams), tcfg)
    with pytest.raises(NotImplementedError, match="WKV6 backward"):
        tmodel.make_loss(tcfg)


def test_forward_logits_match_reference():
    jcfg, tcfg, jparams, leaves = _ref_params()
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 96))
    jl, _ = jmodel.forward(jparams, jcfg, jnp.asarray(toks))
    tl, aux = tmodel.forward(leaves, tcfg, torch.as_tensor(toks))
    assert tl.shape == (2, 96, tcfg.vocab_size) and tl.dtype == torch.float32
    assert float(aux) == 0.0
    _close(tl, jl)


def test_decode_step_matches_reference_token_by_token():
    jcfg, tcfg, jparams, leaves = _ref_params(seed=1)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12))
    jcache = jmodel.make_cache(jcfg, 2, 12)
    tcache = tmodel.make_cache(tcfg, 2, 12)
    jstep = jax.jit(lambda tok, c, p: jmodel.decode_step(jparams, jcfg, tok,
                                                         c, p))
    for t in range(12):
        jl, jcache = jstep(jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        tl, tcache = tmodel.decode_step(leaves, tcfg,
                                        torch.as_tensor(toks[:, t:t + 1]),
                                        tcache, t)
        _close(tl, jl)
    for key in ("s", "last", "clast"):
        _close(tcache[0][key], jcache[0][key])


def test_decode_matches_forward_teacher_forced():
    """The port on its own, as ``tests/test_decode_consistency.py`` does
    for rwkv6-3b: decode token by token reproduces forward, T = 80."""
    _, tcfg = _cfgs()
    params = tmodel.init_leaves(torch.Generator().manual_seed(1), tcfg)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (1, 80)))
    ref, _ = tmodel.forward(params, tcfg, toks)
    cache = tmodel.make_cache(tcfg, 1, 80)
    outs = []
    for t in range(80):
        lg, cache = tmodel.decode_step(params, tcfg, toks[:, t:t + 1], cache,
                                       t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 2e-3, rel


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


def test_serve_matches_the_reference_greedy_loop():
    """``serve.main`` on injected prompts and converted weights against the
    reference's loop (``repro.launch.serve``: prefill through sequential
    decode_step, then greedy): every step's logits within TOL, and the
    same ids wherever the reference's top-2 margin exceeds it."""
    jcfg, tcfg, jparams, leaves = _ref_params(seed=2)
    b, p_len, gen = 2, 6, 5
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                                (b, p_len))
    out = serve.main(["--arch", ARCH, "--batch", str(b), "--prompt-len",
                      str(p_len), "--gen", str(gen)], device="cpu",
                     prompts=prompts, params=leaves, keep_logits=True)
    assert out["ids"].shape == (b, gen)
    assert torch.equal(out["prompts"], torch.as_tensor(prompts))
    assert len(out["logits"]) == p_len + gen
    step = jax.jit(lambda tok, c, pos: jmodel.decode_step(jparams, jcfg, tok,
                                                          c, pos))
    cache = jmodel.make_cache(jcfg, b, p_len + gen)
    jp = jnp.asarray(prompts)
    ref_logits = []
    for i in range(p_len):
        logits, cache = step(jp[:, i:i + 1], cache, jnp.int32(i))
        ref_logits.append(logits[:, -1])
    ids = []
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(gen):
        ids.append(tok)
        logits, cache = step(tok, cache, jnp.int32(p_len + i))
        ref_logits.append(logits[:, -1])
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    ids = np.asarray(jnp.concatenate(ids, 1))
    for i, (got, want) in enumerate(zip(out["logits"], ref_logits)):
        _close(got, want)
        if i >= p_len - 1 and i < p_len + gen - 1:
            top2 = np.sort(np.asarray(want), -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > TOL
            j = i - (p_len - 1)
            np.testing.assert_array_equal(out["ids"][clear, j].numpy(),
                                          ids[clear, j])


def test_serve_refuses_families_without_a_ported_decode():
    """The dense and MoE families decode (tests/test_torch_decode.py,
    tests/test_torch_zoo.py); an arch of the model zoo's unported families
    still raises, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        serve.main(["--arch", "jamba-1.5-large-398b", "--batch", "1",
                    "--prompt-len", "2", "--gen", "1"], device="cpu")
