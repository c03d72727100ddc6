"""The model zoo on the port against the JAX reference on the CPU: the
dense and MoE families (gemma2-9b, deepseek-coder-33b, granite-34b,
mixtral-8x22b, llama4-maverick-400b-a17b) and the hybrid, vlm and audio
families (jamba-1.5-large-398b, llama-3.2-vision-90b,
seamless-m4t-medium).

For each: the config (every field, ``param_count``,
``active_param_count``, ``applicable_shapes``, ``long_context_capable``,
``reduced``) equals the reference's; ``forward`` at ``reduced()`` in fp32
on the reference's weights (``init_params``, carried across by
``convert.lm_leaves_from_jax``) and the same tokens (numpy, seeded), with
memory for the vlm and audio families; ``decode_step`` in bf16 against
the reference's (fp32 memory: the products that take it run in fp32 in
both). For mixtral-8x22b (MoE, swa ring) and gemma2-9b (local/global, both
softcaps) at T = 96, jamba (Mamba carry, MoE, attention) at T = 40,
seamless (the encoder, cross-attention) at T = 24 and llama-3.2-vision at
T = 40, the port's counterparts of those cases of
``tests/test_decode_consistency.py``: every ``decode_step`` against the
reference's, then teacher forcing against the port's own ``forward``; and
``serve.main`` for the hybrid, vlm and audio archs against the
reference's greedy loop.

The vlm's ``cross_gate`` starts at 0 (``tanh(0) = 0``: a cross layer adds
nothing at init, so a broken cross-attention would pass), so every
comparison sets it to 1.0 in the reference's weights before they are
carried across; the memory is seeded ``0.1 * N(0, 1)`` (constant memory
makes every image token alike), as in the reference's test.

Tolerances, each with its reason:
- configs: exact;
- fp32 ``forward`` logits: atol = rtol = 1e-5 (the same fp32 products in
  another order through 2 layers; 5.9e-6 measured); aux 1e-6;
- fp32 ``decode_step`` logits at every step: 1e-5, as
  ``tests/test_torch_decode.py``;
- teacher forcing: max |decode - forward| / max |forward| < 2e-3, the
  reference test's bar, with the MoE capacity factor at 8 as there (4
  experts: no token is dropped in either path);
- bf16 ``decode_step`` (every arch but jamba, whose bf16 router's near
  ties pick another expert for an odd token in one package and not the
  other, which moves that token's logits past the bar): max |logit diff| /
  max |logit| within 2e-2, a bf16 step or two
  (``tests/test_torch_decode.py``'s bf16 bar), and the same greedy id
  wherever the reference's top-2 margin exceeds that;
- ``serve.main``: every step's logits within 1e-4 (fp32, as
  ``tests/test_torch_decode.py``'s serve test) and the same ids wherever
  the reference's top-2 margin exceeds that.
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
from repro_torch.data import lm_source  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCHS = ("gemma2-9b", "deepseek-coder-33b", "granite-34b", "mixtral-8x22b",
         "llama4-maverick-400b-a17b")
# the hybrid, vlm and audio families
MEMORY_ARCHS = ("jamba-1.5-large-398b", "llama-3.2-vision-90b",
                "seamless-m4t-medium")
TF_CASES = (("mixtral-8x22b", 96), ("gemma2-9b", 96),
            ("jamba-1.5-large-398b", 40), ("seamless-m4t-medium", 24),
            ("llama-3.2-vision-90b", 40))
BF16_ARCHS = ARCHS + ("llama-3.2-vision-90b", "seamless-m4t-medium")


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
    """The reference's weights at ``seed`` (the vlm's ``cross_gate`` set to
    1.0) and the port's copy."""
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.family == "vlm":
        params["blocks"] = tuple(
            dict(blk, cross_gate=jnp.ones_like(blk["cross_gate"]))
            if "cross_gate" in blk else blk for blk in params["blocks"])
    return params, convert.lm_leaves_from_jax(np_tree(params), tcfg)


def _memory(cfg, b, seed=0):
    """Seeded ``0.1 * N(0, 1)`` image tokens or audio frames ``[b, M, d]``
    fp32 for the vlm and audio families, as both packages' arrays; else
    ``(None, None)``."""
    if cfg.family not in ("vlm", "audio"):
        return None, None
    m = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
    mem = 0.1 * np.random.default_rng(seed).standard_normal(
        (b, m, cfg.d_model)).astype(np.float32)
    return jnp.asarray(mem), torch.as_tensor(mem)


@pytest.mark.parametrize("arch", ARCHS + MEMORY_ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS + MEMORY_ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, leaves = _weights(jcfg, tcfg)
    # the converted leaves: every reference leaf, all fp32 here
    assert sorted(leaves) == sorted(convert.flatten_tree(np_tree(jparams)))
    for name, leaf in leaves.items():
        assert leaf.dtype == torch.float32, name
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 64))
    jmem, tmem = _memory(tcfg, 2)
    want, want_aux = jmodel.forward(jparams, jcfg, jnp.asarray(toks),
                                    memory=jmem)
    got, aux = tmodel.forward(leaves, tcfg, torch.as_tensor(toks),
                              memory=tmem)
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
    jmem, tmem = _memory(tcfg, 1, seed=4)
    step = jax.jit(lambda tok, c, p: jmodel.decode_step(jparams, jcfg, tok,
                                                        c, p, memory=jmem))
    jcache = jmodel.make_cache(jcfg, 1, T)
    cache = tmodel.make_cache(tcfg, 1, T)
    assert [sorted(c) for c in cache] == [sorted(c) for c in jcache]
    for c, jc in zip(cache, jcache):
        for k in c:
            assert tuple(c[k].shape) == jc[k].shape, k
    outs = []
    for t in range(T):
        jl, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        lg, cache = tmodel.decode_step(leaves, tcfg,
                                       torch.as_tensor(toks[:, t:t + 1]),
                                       cache, t, memory=tmem)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        outs.append(lg[:, 0])
    ref, _ = tmodel.forward(leaves, tcfg, torch.as_tensor(toks), memory=tmem)
    dec = torch.stack(outs, 1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 2e-3, (arch, rel)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_decode_step_in_bf16_matches_reference(arch):
    """bf16 weights; the vlm and audio families with fp32 memory, whose
    products run in fp32 in both packages (``jnp`` promotes them; the port
    promotes at each product), the cross-attention's output cast back to
    bf16."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jparams, leaves = _weights(jcfg, tcfg)
    if tcfg.moe:
        assert all(v.dtype == torch.float32 for k, v in leaves.items()
                   if k.endswith("moe.router"))
    if tcfg.family in ("vlm", "audio"):
        assert all(v.dtype == torch.float32 for k, v in leaves.items()
                   if k.endswith("cross_gate"))
    steps = 24
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, steps))
    jmem, tmem = _memory(tcfg, 2, seed=6)
    step = jax.jit(lambda tok, c, p: jmodel.decode_step(jparams, jcfg, tok,
                                                        c, p, memory=jmem))
    jcache = jmodel.make_cache(jcfg, 2, steps)
    cache = tmodel.make_cache(tcfg, 2, steps)
    got, want = [], []
    for t in range(steps):
        jl, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        lg, cache = tmodel.decode_step(leaves, tcfg,
                                       torch.as_tensor(toks[:, t:t + 1]),
                                       cache, t, memory=tmem)
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
    """What was refused before the zoo's training was ported now runs:
    MoE training (ROADMAP item 15: ``make_loss``, and ``init_params`` in
    bf16 as two parameter groups, the fp32 router in the fp32 one); the
    hybrid, vlm and audio families' training (item 16: ``make_loss``, two
    models at once with their leading model axis, each equal to its own
    one-model forward, and ``lm_source``'s memory leaves); RWKV6's
    training (item 10: ``make_loss``)."""
    cfg = reduced(get_config("mixtral-8x22b"))
    assert callable(tmodel.make_loss(cfg))
    groups = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    assert [g.dtype for g in groups] == [torch.bfloat16, torch.float32]
    layout = tmodel.param_layout(cfg)
    assert all(v.dtype == torch.float32 for k, v in
               layout.views(groups).items() if k.endswith("moe.router"))
    for arch in MEMORY_ARCHS:
        cfg = reduced(get_config(arch))
        assert callable(tmodel.make_loss(cfg))
        leaves = tmodel.init_leaves(torch.Generator().manual_seed(0), cfg)
        for k in leaves:
            if k.endswith("cross_gate"):
                leaves[k] = torch.ones_like(leaves[k])
        second = {k: v * 1.5 if v.dim() > 1 else v for k, v in leaves.items()}
        two = {k: torch.stack([v, second[k]]) for k, v in leaves.items()}
        toks = torch.randint(0, cfg.vocab_size, (2, 1, 8),
                             generator=torch.Generator().manual_seed(1))
        _, mem = _memory(cfg, 2)
        mem2 = None if mem is None else mem[:, None]
        with torch.no_grad():
            got, _ = tmodel.forward(two, cfg, toks, memory=mem2)
            for i, p in enumerate((leaves, second)):
                want, _ = tmodel.forward(p, cfg, toks[i],
                                         memory=None if mem is None
                                         else mem[i:i + 1])
                torch.testing.assert_close(got[i].float(), want.float(),
                                           rtol=2e-2, atol=2e-2)
    src = lm_source(num_clients=2, local_steps=1, batch=1, seq=4, vocab=16,
                    memory_shape=(1, 4, 8))
    batch, _ = src.sample(src.init(torch.zeros(1, 2, dtype=torch.long)), 0,
                          torch.zeros(1, 2, 1, 1, 4, dtype=torch.long))
    assert tuple(batch["memory"].shape) == (1, 2, 1, 1, 4, 8)
    assert callable(tmodel.make_loss(reduced(get_config("rwkv6-3b"))))


@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_init_leaves_follow_the_layout_and_the_reference_laws(arch):
    """The port's own init in bf16: every leaf of the layout in its dtype
    (the SSM's four fp32 leaves and ``cross_gate`` fp32), the reference's
    names and shapes, and ``cross_gate`` at 2.0 (audio) or 0.0 (vlm)."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    leaves = tmodel.init_leaves(torch.Generator().manual_seed(0), tcfg)
    ref = convert.flatten_tree(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg)))
    assert sorted(leaves) == sorted(ref)
    layout = tmodel.param_layout(tcfg)
    for name, leaf in leaves.items():
        assert tuple(leaf.shape) == ref[name].shape, name
        assert leaf.dtype == layout.dtype_of(name, torch.bfloat16), name
        assert (leaf.dtype == torch.float32) == (
            str(ref[name].dtype) == "float32"), name
    gates = [v for k, v in leaves.items() if k.endswith("cross_gate")]
    assert bool(gates) == (tcfg.family != "hybrid")
    for g in gates:
        assert (g == (2.0 if tcfg.family == "audio" else 0.0)).all()


@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_serve_matches_the_reference_greedy_loop(arch):
    """``serve.main(device="cpu")`` at ``--reduced`` (fp32) on the
    reference's weights and injected prompts, with the launcher's own
    memory (``0.1 * ones`` fp32, as ``repro.launch.serve`` builds it),
    against the reference's loop: prefill through sequential
    ``decode_step``, then greedy."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    jparams, leaves = _weights(jcfg, tcfg, seed=2)
    b, p_len, gen = 2, 6, 5
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                                (b, p_len))
    # serve.main builds the reduced config itself (capacity factor 1.25):
    # at batch 2 and one token a row per step no expert is over-full
    out = serve.main(["--arch", arch, "--batch", str(b), "--prompt-len",
                      str(p_len), "--gen", str(gen)], device="cpu",
                     prompts=prompts, params=leaves, keep_logits=True)
    assert out["ids"].shape == (b, gen)
    assert len(out["logits"]) == p_len + gen
    memory = None
    if jcfg.family in ("vlm", "audio"):
        m = (jcfg.num_image_tokens if jcfg.family == "vlm"
             else jcfg.num_audio_frames)
        memory = 0.1 * jnp.ones((b, m, jcfg.d_model))
    step = jax.jit(lambda tok, c, pos: jmodel.decode_step(
        jparams, jcfg, tok, c, pos, memory=memory))
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
    tol, clear_steps = 1e-4, 0
    for i, (got, want) in enumerate(zip(out["logits"], ref_logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
        if p_len - 1 <= i < p_len + gen - 1:
            top2 = np.sort(np.asarray(want), -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > tol
            clear_steps += int(clear.sum())
            j = i - (p_len - 1)
            np.testing.assert_array_equal(out["ids"][clear, j].numpy(),
                                          ids[clear, j])
    assert clear_steps > 0
