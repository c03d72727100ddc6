"""The port's LM slice (``repro_torch.configs``, ``models``, ``convert``,
``data.lm_source``, ``launch.train``) against the JAX reference on the
CPU, at ``reduced(smollm-135m, d_model=64, layers=2)`` in fp32, with the
reference's ``REPRO_KERNEL_BACKEND`` unset (its ``xla`` attention).

Tolerances, each with its reason:
- configs, parameter conversion, token draws: exact (the same numbers);
- layers, logits, the loss and its gradients: fp32 rtol/atol 1e-5 (the
  same operations; matrix products and reductions in another order);
- bf16 layers: one bf16 step, 1e-2 relative (both round the same fp32
  value; another order of the fp32 sum can flip one rounding);
- one engine round re-synced from the reference: 1e-5; three rounds
  without re-syncing: 1e-4 (the same, compounded).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_state_close, np_tree  # noqa: E402
from repro.configs import FederationConfig as JFed  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import init_fed_state as jinit_fed_state  # noqa: E402
from repro.core import make_algorithm as jmake_algorithm  # noqa: E402
from repro.core import make_link_process as jmake_link  # noqa: E402
from repro.core import make_run_rounds as jmake_run_rounds  # noqa: E402
from repro.data import lm_source as jlm_source  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import paper_decay as jdecay, sgd as jsgd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import FederationConfig as TFed  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import make_algorithm_spec, make_link_process  # noqa: E402
from repro_torch.data import lm_source  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import paper_decay, sgd  # noqa: E402

ARCH = "smollm-135m"
M, S, BATCH, T, LR = 4, 2, 2, 32, 0.1
P_BASE = np.asarray([0.9, 0.5, 0.3, 0.7], np.float32)


def _cfgs(dtype="float32"):
    j = dataclasses.replace(jreduced(jget_config(ARCH), d_model=64, layers=2),
                            dtype=dtype)
    t = dataclasses.replace(reduced(get_config(ARCH), d_model=64, layers=2),
                            dtype=dtype)
    return j, t


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


def _same_fields(port, ref):
    """Every field of the port's config equals the reference's (nested
    configs compared field by field)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


def test_configs_match_reference():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    _same_fields(tc, jc)
    assert tc.param_count() == jc.param_count() == 134_515_008
    for kw in (dict(), dict(d_model=64, layers=2)):
        _same_fields(reduced(tc, **kw), jreduced(jc, **kw))
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        get_config("jamba-1.5-large-398b")
    with pytest.raises(KeyError):
        get_config("nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    tw = torch.as_tensor(w).to(getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 1e-2

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)

    close(tlayers.rms_norm(tx, tw), jlayers.rms_norm(jx, jw))
    pos = np.arange(8)
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos), 16, 10000.0)
    tcos, tsin = tlayers.rope_angles(torch.as_tensor(pos), 16, 10000.0)
    close(tcos, jcos)
    close(tsin, jsin)
    close(tlayers.apply_rope(tx, tcos, tsin),
          jlayers.apply_rope(jx, jcos, jsin))
    mats = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
            (("up", (16, 24)), ("gate", (16, 24)), ("down", (24, 16)))}
    h = x[0, :, 0]
    for gated in (True, False):
        close(tlayers.mlp_apply({k: torch.as_tensor(v).to(tx.dtype)
                                 for k, v in mats.items()},
                                torch.as_tensor(h).to(tx.dtype), gated),
              jlayers.mlp_apply({k: jnp.asarray(v).astype(dtype)
                                 for k, v in mats.items()},
                                jnp.asarray(h).astype(dtype), gated))
    close(tlayers.softcap(tx * 40, 30.0), jlayers.softcap(jx * 40, 30.0))


# ---------------------------------------------------------------------------
# parameters and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_exact(dtype):
    """JAX params -> the port's flat buffer: every view equals its leaf,
    the period-stacked blocks included; the tied embedding is one leaf."""
    jcfg, tcfg = _cfgs(dtype)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    flat = convert.lm_params_from_jax(np_tree(params), tcfg)
    layout = tmodel.param_layout(tcfg)
    assert flat.dtype == getattr(torch, dtype)
    assert flat.shape == (layout.size,) == (tcfg.param_count(),)
    assert "lm_head" not in dict(layout.leaves)
    leaves = convert.flatten_tree(np_tree(params))
    assert set(leaves) == {name for name, _ in layout.leaves}
    for name, view in layout.views(flat).items():
        np.testing.assert_array_equal(view.float().numpy(),
                                      np.asarray(leaves[name], np.float32))


def _two_models(jcfg, tcfg):
    """Two reference models stacked as the port's ``[2, n]`` buffer."""
    ps = [jmodel.init_params(jax.random.PRNGKey(s), jcfg) for s in (1, 2)]
    flat = torch.stack([convert.lm_params_from_jax(np_tree(p), tcfg)
                        for p in ps])
    return ps, flat


def test_forward_logits_match_reference():
    """Two models at once (leading model axis 2): each one's logits equal
    the reference's forward of that model."""
    jcfg, tcfg = _cfgs()
    ps, flat = _two_models(jcfg, tcfg)
    toks = _tokens((2, BATCH, T), tcfg.vocab_size)
    layout = tmodel.param_layout(tcfg)
    logits, aux = tmodel.forward(layout.views(flat), tcfg,
                                 torch.as_tensor(toks))
    assert logits.shape == (2, BATCH, T, tcfg.vocab_size)
    assert aux.shape == (2,)
    for i in range(2):
        want, _ = jmodel.forward(ps[i], jcfg, jnp.asarray(toks[i]))
        np.testing.assert_allclose(logits[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ce_chunk", [16, 24])     # 24: the padded branch
def test_loss_and_gradients_match_reference(ce_chunk):
    """The chunked cross-entropy and its gradient w.r.t. every parameter,
    through the engine's flat-buffer loss, vs ``jax.value_and_grad``."""
    jcfg, tcfg = _cfgs()
    ps, flat = _two_models(jcfg, tcfg)
    toks = _tokens((2, BATCH, T), tcfg.vocab_size, seed=1)
    labels = np.roll(toks, -1, axis=-1)
    layout = tmodel.param_layout(tcfg)
    leaf = flat.clone().requires_grad_(True)
    loss = tmodel.loss_fn(layout.unflatten(leaf), tcfg,
                          {"tokens": torch.as_tensor(toks),
                           "labels": torch.as_tensor(labels)},
                          ce_chunk=ce_chunk)
    (grad,) = torch.autograd.grad(loss.sum(), leaf)
    for i in range(2):
        batch = {"tokens": jnp.asarray(toks[i]),
                 "labels": jnp.asarray(labels[i])}
        val, g = jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jcfg, batch, remat=False,
                                     ce_chunk=ce_chunk))(ps[i])
        assert abs(loss[i].item() - float(val)) <= 1e-5 * max(1.0, abs(val))
        np.testing.assert_allclose(
            grad[i].numpy(),
            convert.lm_params_from_jax(np_tree(g), tcfg).numpy(),
            rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# data and the round engine
# ---------------------------------------------------------------------------


def _reference_draws(vocab, seed, rounds):
    """The reference's own draws: link uniforms from its state key, token
    draws from ``fold_in(data_key, round)``, offsets from the ds key."""
    half = vocab // 2
    _, key = jax.random.split(jax.random.PRNGKey(seed + 2))
    data_key = jax.random.PRNGKey(seed + 4)
    lo = np.array(jax.random.randint(jax.random.PRNGKey(seed + 3), (M,), 0,
                                     half))
    draws = []
    for t in range(rounds):
        key, k_link = jax.random.split(key)
        u = np.array(jax.random.uniform(k_link, (M,)))
        pick = np.array(jax.random.randint(
            jax.random.fold_in(data_key, t), (M, S, BATCH, T), 0, half))
        draws.append(tfed.RoundDraws(torch.as_tensor(u)[None],
                                     torch.as_tensor(pick)[None]))
    return lo, draws


def test_lm_source_on_injected_draws_matches_reference():
    vocab = 512
    lo, draws = _reference_draws(vocab, seed=0, rounds=2)
    jsrc = jlm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                      vocab=vocab)
    tsrc = lm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                     vocab=vocab)
    assert tsrc.pick_spec == (S, BATCH, T, vocab // 2)
    assert tsrc.init_high == vocab // 2
    jds = jsrc.init(jax.random.PRNGKey(3))
    np.testing.assert_array_equal(np.asarray(jds["lo"]), lo)
    tds = tsrc.init(torch.as_tensor(lo)[None])
    for t in range(2):
        jb, _ = jsrc.sample(jds, t, jax.random.fold_in(jax.random.PRNGKey(4),
                                                       t))
        tb, _ = tsrc.sample(tds, t, draws[t].pick)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k][0].numpy(), np.asarray(jb[k]))


class _Draws:
    def __init__(self, draws):
        self.draws = draws

    def __call__(self, t):
        return self.draws[t]


def _engines(seed=0):
    jcfg, tcfg = _cfgs()
    kw = dict(algorithm="fedpbc", num_clients=M, local_steps=S,
              scheme="bernoulli")
    jfedc, tfedc = JFed(**kw), TFed(**kw)
    jalgo = jmake_algorithm(jfedc)
    jlink = jmake_link(jnp.asarray(P_BASE), jfedc)
    jopt = jsgd(jdecay(LR))
    jsrc = jlm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                      vocab=jcfg.vocab_size)
    jrun = jmake_run_rounds(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=False), jopt, jalgo,
        jlink, jfedc, jsrc)
    params = jmodel.init_params(jax.random.PRNGKey(seed + 1), jcfg)
    st = jinit_fed_state(jax.random.PRNGKey(seed + 2), params, jfedc, jalgo,
                         jlink, jopt)
    jds = jsrc.init(jax.random.PRNGKey(seed + 3))
    data_key = jax.random.PRNGKey(seed + 4)

    tsrc = lm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                     vocab=tcfg.vocab_size)
    trun = tfed.make_run_rounds(
        tmodel.make_loss(tcfg), sgd(paper_decay(LR)),
        make_algorithm_spec(("fedpbc",), tfedc),
        make_link_process(torch.as_tensor(P_BASE)[None], tfedc), tfedc,
        tsrc, device="cpu")
    lo, draws = _reference_draws(tcfg.vocab_size, seed, 3)
    tds = tsrc.init(torch.as_tensor(lo)[None])
    layout = tmodel.param_layout(tcfg)
    return (jrun, st, jds, data_key), (trun, tds, _Draws(draws)), layout


def _port_state(st, layout):
    return convert.fed_state_from_jax(
        np_tree(jax.tree.map(lambda x: x[None], st)), layout, "bernoulli")


def _ref_np(st):
    return np_tree(jax.tree.map(lambda x: x[None], st))


def test_engine_rounds_resynced_match_reference():
    """Each of 3 rounds from the reference's state, on its own draws."""
    (jrun, st, jds, data_key), (trun, tds, draws), layout = _engines()
    for _ in range(3):
        ps = _port_state(st, layout)
        ps, tds, mets = trun(ps, tds, draws, 1)
        st, jds, jm = jrun(st, jds, data_key, 1)
        np.testing.assert_allclose(mets["loss"][0].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(mets["num_active"][0].numpy(),
                                      np.asarray(jm["num_active"]))
        assert_state_close(ps, _ref_np(st), layout, atol=1e-5, rtol=1e-5)
    assert int(np.asarray(st.round)) == 3


def test_engine_three_rounds_without_resync_match_reference():
    (jrun, st, jds, data_key), (trun, tds, draws), layout = _engines()
    ps = _port_state(st, layout)
    ps, _, mets = trun(ps, tds, draws, 3)
    st, _, jm = jrun(st, jds, data_key, 3)
    assert mets["loss"].shape == (1, 3)
    np.testing.assert_allclose(mets["loss"][0].numpy(),
                               np.asarray(jm["loss"]), rtol=1e-4, atol=1e-4)
    assert_state_close(ps, _ref_np(st), layout, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_launcher_runs_on_cpu_and_raises_without_cuda(monkeypatch):
    monkeypatch.setenv("REPRO_USE_KERNEL", "1")
    out = train.main(["--device", "cpu", "--rounds", "3", "--log-every",
                      "2", "--seq", "16", "--clients", "3"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["log_rounds"] == [2, 3]
    assert out["state"].server.dtype == torch.float32
    assert out["state"].round == 3
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        train.main(["--device", "cpu", "--ckpt-dir", "ckpt"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--rounds", "1"])
