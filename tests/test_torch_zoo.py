"""The model zoo's dense and MoE families on the port against the JAX
reference on the CPU: gemma2-9b, deepseek-coder-33b, granite-34b,
mixtral-8x22b and llama4-maverick-400b-a17b.

For each: the config (every field, ``param_count``,
``active_param_count``, ``applicable_shapes``, ``long_context_capable``,
``reduced``) equals the reference's; ``forward`` at ``reduced()`` in fp32
on the reference's weights (``init_params``, carried across by
``convert.lm_leaves_from_jax``) and the same tokens (numpy, seeded);
``decode_step`` in bf16 against the reference's. For mixtral-8x22b (MoE,
swa ring) and gemma2-9b (local/global, both softcaps) at T = 96, the
port's counterparts of those cases of ``tests/test_decode_consistency.py``:
every ``decode_step`` against the reference's, then teacher forcing
against the port's own ``forward``.

Tolerances, each with its reason:
- configs: exact;
- fp32 ``forward`` logits: atol = rtol = 1e-5 (the same fp32 products in
  another order through 2 layers; 5.9e-6 measured); aux 1e-6;
- fp32 ``decode_step`` logits at every step: 1e-5, as
  ``tests/test_torch_decode.py``;
- teacher forcing: max |decode - forward| / max |forward| < 2e-3, the
  reference test's bar, with the MoE capacity factor at 8 as there (4
  experts: no token is dropped in either path);
- bf16 ``decode_step``: max |logit diff| / max |logit| within 2e-2, a
  bf16 step or two (``tests/test_torch_decode.py``'s bf16 bar), and the
  same greedy id wherever the reference's top-2 margin exceeds that.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np_tree  # noqa: E402
from repro.configs import applicable_shapes as japplicable_shapes  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import long_context_capable as jlong  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (applicable_shapes, get_config,  # noqa: E402
                                 long_context_capable, reduced)
from repro_torch.models import model as tmodel  # noqa: E402

ARCHS = ("gemma2-9b", "deepseek-coder-33b", "granite-34b", "mixtral-8x22b",
         "llama4-maverick-400b-a17b")
TF_CASES = (("mixtral-8x22b", 96), ("gemma2-9b", 96))


def _cfgs(arch, dtype="float32", capacity_factor=None):
    """The reduced config of both packages in ``dtype``."""
    out = []
    for get, red in ((jget_config, jreduced), (get_config, reduced)):
        cfg = dataclasses.replace(red(get(arch)), dtype=dtype)
        if capacity_factor and cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _weights(jcfg, tcfg, seed=1):
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, convert.lm_leaves_from_jax(np_tree(params), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    cfg, ref = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert [dataclasses.asdict(s) for s in applicable_shapes(cfg)] == [
        dataclasses.asdict(s) for s in japplicable_shapes(ref)]
    assert long_context_capable(cfg) == jlong(ref)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jreduced(ref))
    assert tmodel.period_length(cfg) == jmodel.period_length(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, leaves = _weights(jcfg, tcfg)
    # the converted leaves: every reference leaf, the router in fp32
    assert sorted(leaves) == sorted(convert.flatten_tree(np_tree(jparams)))
    for name, leaf in leaves.items():
        assert leaf.dtype == torch.float32, name
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 64))
    want, want_aux = jmodel.forward(jparams, jcfg, jnp.asarray(toks))
    got, aux = tmodel.forward(leaves, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert aux.shape == () and abs(float(aux) - float(want_aux)) <= 1e-6
    assert (float(aux) > 0) == bool(tcfg.moe)


def test_moe_forward_over_model_axes_is_per_model():
    """Leaves with a leading model axis ``[2, ...]``: each model's logits
    and aux are its own forward's."""
    jcfg, tcfg = _cfgs("llama4-maverick-400b-a17b")
    leaves = [_weights(jcfg, tcfg, seed)[1] for seed in (1, 2)]
    both = {k: torch.stack([leaves[0][k], leaves[1][k]]) for k in leaves[0]}
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 2, 32)))
    got, aux = tmodel.forward(both, tcfg, toks)
    assert aux.shape == (2,)
    for g in range(2):
        want, want_aux = tmodel.forward(leaves[g], tcfg, toks[g])
        torch.testing.assert_close(got[g], want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux[g], want_aux, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,T", TF_CASES)
def test_decode_step_matches_reference_and_teacher_forcing(arch, T):
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    jparams, leaves = _weights(jcfg, tcfg)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, T))
    step = jax.jit(lambda tok, c, p: jmodel.decode_step(jparams, jcfg, tok,
                                                        c, p))
    jcache = jmodel.make_cache(jcfg, 1, T)
    cache = tmodel.make_cache(tcfg, 1, T)
    assert [sorted(c) for c in cache] == [sorted(c) for c in jcache]
    outs = []
    for t in range(T):
        jl, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        lg, cache = tmodel.decode_step(leaves, tcfg,
                                       torch.as_tensor(toks[:, t:t + 1]),
                                       cache, t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        outs.append(lg[:, 0])
    ref, _ = tmodel.forward(leaves, tcfg, torch.as_tensor(toks))
    dec = torch.stack(outs, 1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 2e-3, (arch, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_in_bf16_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jparams, leaves = _weights(jcfg, tcfg)
    if tcfg.moe:
        assert all(v.dtype == torch.float32 for k, v in leaves.items()
                   if k.endswith("moe.router"))
    steps = 24
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


def test_moe_training_and_unported_families_are_refused():
    cfg = reduced(get_config("mixtral-8x22b"))
    with pytest.raises(NotImplementedError, match="item 15"):
        tmodel.make_loss(cfg)
    # the fp32 router cannot be rounded into one bf16 buffer
    with pytest.raises(ValueError, match="moe.router"):
        tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    for arch in ("jamba-1.5-large-398b", "llama-3.2-vision-90b",
                 "seamless-m4t-medium"):
        with pytest.raises(NotImplementedError, match="item 14"):
            get_config(arch)
