"""The port's dense decode (``models.attention.decode_attention``, the KV
cache of ``models.model.make_cache`` and the dense ``decode_step``) and the
serving launcher at its default arch, against the JAX reference on the CPU
at ``reduced(smollm-135m)`` in fp32, for the patterns full, swa,
local_global and chunked (the config replaced on both sides; window 64 <
T = 96, so the swa and chunked rings wrap).

Tolerances, each with its reason:
- cache shapes: exact;
- ``decode_attention``: fp32 1e-6 (one online softmax over the same
  values, products in another order);
- ``decode_step`` logits at every step: fp32 1e-5 (a 2-layer model of such
  steps);
- ``decode_step`` in bf16: max |logit diff| / max |logit| within 2e-2
  (the logits are a bf16 product: a bf16 step or two where another order
  of the fp32 sums rounds the other way; phase 8c's bf16 bar);
- teacher forcing (the port alone, as ``tests/test_decode_consistency.py``
  holds the reference): max |decode - forward| / max |forward| < 2e-3,
  that test's bar;
- ``serve.main``: every step's logits within 1e-4 of the reference's loop
  (``tests/test_torch_rwkv.py``'s bar for the launcher), the same ids
  wherever the reference's top-2 margin exceeds that.
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
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCH = "smollm-135m"
PATTERNS = ("full", "swa", "local_global", "chunked")
T = 96
TOL = 1e-4


def _cfgs(pattern="full"):
    """The reduced fp32 config of both packages at ``pattern``."""
    out = []
    for get, red in ((jget_config, jreduced), (get_config, reduced)):
        cfg = dataclasses.replace(red(get(ARCH)), dtype="float32")
        out.append(dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, pattern=pattern)))
    return out


def _ref_params(pattern="full", seed=1):
    jcfg, tcfg = _cfgs(pattern)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, convert.lm_leaves_from_jax(np_tree(params),
                                                          tcfg)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_make_cache_shapes_match_reference(pattern):
    jcfg, tcfg = _cfgs(pattern)
    assert tcfg.attention.window == 64
    for max_len in (T, 40):
        ref = jmodel.make_cache(jcfg, 3, max_len)
        got = tmodel.make_cache(tcfg, 3, max_len)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r) == ["k", "v"]
            for k in g:
                assert tuple(g[k].shape) == r[k].shape
                assert g[k].dtype == torch.float32 and not g[k].any()


@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_attention_matches_reference_at_every_cache_len(kind,
                                                               softcap):
    b, S, H, KV, D, window = 2, 24, 4, 2, 16, 8
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((b, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((b, S, KV, D)).astype(np.float32)
    kw = dict(kind=kind, window=window, logit_softcap=softcap, chunk=5)
    ref = jax.jit(lambda n: jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n, **kw))
    for n in range(1, S + 1):
        got = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                     torch.as_tensor(v), n, **kw)
        assert got.shape == (b, 1, H, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.int32(n))),
                                   rtol=1e-6, atol=1e-6)
    # a 0-d tensor length is the same length
    tensor_len = tattn.decode_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.tensor(S // 2), **kw)
    assert torch.equal(tensor_len, tattn.decode_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), S // 2,
        **kw))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_decode_step_logits_match_reference_and_teacher_forcing(pattern):
    jcfg, tcfg, jparams, leaves = _ref_params(pattern)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, T))
    step = jax.jit(lambda tok, c, p: jmodel.decode_step(jparams, jcfg, tok,
                                                        c, p))
    jcache = jmodel.make_cache(jcfg, 1, T)
    cache = tmodel.make_cache(tcfg, 1, T)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    outs = []
    for t in range(T):
        jl, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        # a 0-d tensor position on every other step
        pos = torch.tensor(t) if t % 2 else t
        lg, new = tmodel.decode_step(leaves, tcfg,
                                     torch.as_tensor(toks[:, t:t + 1]),
                                     cache, pos)
        if t == 0:      # the cache given is not changed
            for c, c0 in zip(cache, before):
                assert all(torch.equal(c[k], c0[k]) for k in c)
        cache = new
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        outs.append(lg[:, 0])
    for g, r in zip(cache, jcache):
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]),
                                       rtol=1e-5, atol=1e-5)
    ref, _ = tmodel.forward(leaves, tcfg, torch.as_tensor(toks))
    dec = torch.stack(outs, 1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 2e-3, (pattern, rel)


@pytest.mark.parametrize("pattern", ["full", "swa"])
def test_decode_step_in_bf16_matches_reference(pattern):
    """The reference's order in bf16: q scaled in its own dtype before the
    fp32 cast, the cache and rope in bf16, the ring's roll."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs(pattern))
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    leaves = convert.lm_leaves_from_jax(np_tree(jparams), tcfg)
    steps = 80
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, steps))
    step = jax.jit(lambda tok, c, p: jmodel.decode_step(jparams, jcfg, tok,
                                                        c, p))
    jcache = jmodel.make_cache(jcfg, 2, steps)
    cache = tmodel.make_cache(tcfg, 2, steps)
    got, want = [], []
    for t in range(steps):
        jl, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        lg, cache = tmodel.decode_step(leaves, tcfg,
                                       torch.as_tensor(toks[:, t:t + 1]),
                                       cache, t)
        got.append(lg[:, 0].numpy())
        want.append(np.asarray(jl)[:, 0])
    got, want = np.stack(got, 1), np.stack(want, 1)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-2
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-2 * scale
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_serve_default_arch_matches_the_reference_greedy_loop():
    """``serve.main`` at its default ``--arch smollm-135m`` (reduced, fp32)
    on injected prompts and converted weights against the reference's loop
    (``repro.launch.serve``: prefill through sequential decode_step, then
    greedy)."""
    jcfg, tcfg, jparams, leaves = _ref_params(seed=2)
    b, p_len, gen = 2, 6, 5
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                                (b, p_len))
    out = serve.main(["--batch", str(b), "--prompt-len", str(p_len),
                      "--gen", str(gen)], device="cpu", prompts=prompts,
                     params=leaves, keep_logits=True)
    assert out["ids"].shape == (b, gen)
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
    clear_steps = 0
    for i, (got, want) in enumerate(zip(out["logits"], ref_logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        if p_len - 1 <= i < p_len + gen - 1:
            top2 = np.sort(np.asarray(want), -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > TOL
            clear_steps += int(clear.sum())
            j = i - (p_len - 1)
            np.testing.assert_array_equal(out["ids"][clear, j].numpy(),
                                          ids[clear, j])
    assert clear_steps > 0
