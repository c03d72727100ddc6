"""Training of RWKV6 on the port (``launch/train.py --arch rwkv6-3b``)
against the JAX reference on the CPU, at ``reduced()`` (2 layers, d_model
256, 4 heads of 64, decay LoRA 16). On the CPU the WKV6 recurrence is its
plain chunked version under autograd; the hand-written backward kernels
are checked in ``tests/test_torch_rwkv_bwd_emulated.py`` and on the card.

In fp32 (one parameter buffer), from the reference's weights carried
across by ``convert`` and the same tokens: the loss of two models at once
(a leading model axis of 2, the models folded into the WKV6 head axis)
and its gradient w.r.t. every leaf, against ``jax.value_and_grad`` of the
reference's ``loss_fn(remat=False)``; the forward over that axis against
two one-model forwards; one engine round on the reference launcher's own
draws (``tests/_torch_parity.py``'s ``lm_round_draws``) from the
reference's state. The reference's decay (``decay_base`` -4 and its LoRA:
w near 0.98) is the moderate decay where its chunk scan is finite; at
strong decay it overflows (``tests/test_torch_rwkv.py``). In bf16 the
fp32 leaves (decay base, bonus, ``ln_x``) make two parameter groups: one
engine round from the reference's bf16 state keeps them fp32 and holds
each group to the reference's round. The launcher trains and resumes on
the CPU. The dry run counts the WKV6 kernels' work (``roofline.wkv6_work``)
once a layer per direction.

Tolerances, each with its reason:
- the fp32 loss: 1e-5; fp32 gradients: atol = rtol = 1e-4 (the same fp32
  products in another order through 2 layers, as
  ``tests/test_torch_train_zoo.py``);
- the forward over a model axis: fp32 1e-5 (batched products against one
  model's);
- the fp32 engine round, re-synced: 1e-5 (two local SGD steps at lr 0.1
  on those gradients; 1.1e-6 measured on the parameters);
- the bf16 round: each group's update (server after the round less
  before) within 0.1 of the reference's, ``||u_port - u_ref|| /
  ||u_ref||`` (0.043 measured for each group: the backward through 2 bf16
  layers rounds at other places in the two frameworks; one embedding row's
  update, 0.179 against 0.198, is the largest element's difference, so the
  elementwise bar of ``tests/test_torch_train_zoo.py`` is not this
  model's), the losses within 1e-2 relative;
- the layout round trip, the resumed launcher and the dry run's counts:
  exact.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_state_close, lm_round_draws,  # noqa: E402
                           np_tree)
from repro.configs import FederationConfig as JFed  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import init_fed_state as jinit_fed_state  # noqa: E402
from repro.core import make_algorithm as jmake_algorithm  # noqa: E402
from repro.core import make_link_process as jmake_link  # noqa: E402
from repro.core import make_run_rounds as jmake_run_rounds  # noqa: E402
from repro.data import lm_source as jlm_source  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import paper_decay as jdecay, sgd as jsgd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.configs import FederationConfig as TFed  # noqa: E402
from repro_torch.core import Groups, federated as tfed  # noqa: E402
from repro_torch.core import make_algorithm_spec  # noqa: E402
from repro_torch.core import make_link_process  # noqa: E402
from repro_torch.data import lm_source  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.launch.roofline import wkv6_work  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import paper_decay, sgd  # noqa: E402

ARCH = "rwkv6-3b"
M, S, BATCH, T, LR = 2, 2, 2, 16, 0.1
P_BASE = np.asarray([0.9, 0.4], np.float32)


def _cfgs(dtype="float32"):
    return [dataclasses.replace(red(get(ARCH)), dtype=dtype)
            for get, red in ((jget_config, jreduced), (get_config, reduced))]


def _tokens(vocab, lead, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, lead + (BATCH, T))
    return toks, np.roll(toks, -1, axis=-1)


def test_loss_and_gradients_match_reference():
    """Two models at once: the loss and every leaf's gradient, each model
    against the reference's ``jax.value_and_grad`` of its own."""
    jcfg, tcfg = _cfgs()
    ps = [jmodel.init_params(jax.random.PRNGKey(s), jcfg) for s in (1, 2)]
    layout = tmodel.param_layout(tcfg)
    flat = torch.stack([convert.lm_params_from_jax(np_tree(p), tcfg)
                        for p in ps])
    toks, labels = _tokens(tcfg.vocab_size, (2,))
    leaf = flat.clone().requires_grad_(True)
    loss = tmodel.make_loss(tcfg)(leaf, {"tokens": torch.as_tensor(toks),
                                         "labels": torch.as_tensor(labels)})
    assert loss.shape == (2,)
    (grad,) = torch.autograd.grad(loss.sum(), leaf)
    grads = layout.views(grad)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=False)))
    for i in range(2):
        val, g = value_and_grad(ps[i], {"tokens": jnp.asarray(toks[i]),
                                        "labels": jnp.asarray(labels[i])})
        assert abs(loss[i].item() - float(val)) <= 1e-5 * max(1.0, abs(val))
        want = convert.flatten_tree(np_tree(g))
        assert set(want) == set(grads)
        for name, got in grads.items():
            np.testing.assert_allclose(got[i].numpy(), want[name], rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    # every leaf trains, the fp32 ones (decay base, bonus, ln_x) too
    assert all(g.abs().max() > 0 for g in grads.values())


def test_forward_over_a_model_axis_equals_single_model_forwards():
    """``forward`` of two models ``[2, b, T]`` (one WKV6 call a layer, the
    models in its head axis, each with its own bonus) equals each model's
    own forward on ``[b, T]``."""
    _, tcfg = _cfgs()
    layout = tmodel.param_layout(tcfg)
    flats = [tmodel.init_params(torch.Generator().manual_seed(s), tcfg)
             for s in (1, 2)]
    toks = torch.as_tensor(_tokens(tcfg.vocab_size, (2,))[0])
    with torch.no_grad():
        both, aux = tmodel.forward(layout.views(torch.stack(flats)), tcfg,
                                   toks)
        assert both.shape == (2, BATCH, T, tcfg.vocab_size)
        assert aux.shape == (2,) and not aux.any()
        for i in range(2):
            one, _ = tmodel.forward(layout.views(flats[i]), tcfg, toks[i])
            torch.testing.assert_close(both[i], one, rtol=1e-5, atol=1e-5)


def _engines(dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(dtype)
    kw = dict(algorithm="fedpbc", num_clients=M, local_steps=S,
              scheme="bernoulli")
    jfedc, tfedc = JFed(**kw), TFed(**kw)
    jalgo = jmake_algorithm(jfedc)
    jsrc = jlm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                      vocab=jcfg.vocab_size)
    jrun = jmake_run_rounds(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=False),
        jsgd(jdecay(LR)), jalgo, jmake_link(jnp.asarray(P_BASE), jfedc),
        jfedc, jsrc)
    st = jinit_fed_state(jax.random.PRNGKey(seed + 2),
                         jmodel.init_params(jax.random.PRNGKey(seed + 1),
                                            jcfg),
                         jfedc, jalgo, jmake_link(jnp.asarray(P_BASE), jfedc),
                         jsgd(jdecay(LR)))
    jds = jsrc.init(jax.random.PRNGKey(seed + 3))
    tsrc = lm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                     vocab=tcfg.vocab_size)
    trun = tfed.make_run_rounds(
        tmodel.make_loss(tcfg), sgd(paper_decay(LR)),
        make_algorithm_spec(("fedpbc",), tfedc),
        make_link_process(torch.as_tensor(P_BASE)[None], tfedc), tfedc,
        tsrc, device="cpu")
    lo, draws = lm_round_draws(tcfg.vocab_size, seed, 1, M, S, BATCH, T)
    tds = tsrc.init(torch.as_tensor(lo)[None])
    layout = tmodel.param_layout(tcfg)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ps = convert.fed_state_from_jax(
        np_tree(jax.tree.map(lambda x: x[None], st)), layout, "bernoulli",
        dtype=dt)
    return (jrun, st, jds, jax.random.PRNGKey(seed + 4)), \
        (trun, ps, tds, lambda t: draws[t]), layout


def test_engine_round_resynced_matches_reference():
    """One FedPBC round of 2 clients (2 local steps each) from the
    reference's state, on its draws: losses, the active set and the whole
    state."""
    (jrun, st, jds, key), (trun, ps, tds, draws), layout = _engines()
    ps, _, mets = trun(ps, tds, draws, 1)
    st, _, jm = jrun(st, jds, key, 1)
    np.testing.assert_allclose(mets["loss"][0].numpy(),
                               np.asarray(jm["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mets["num_active"][0].numpy(),
                                  np.asarray(jm["num_active"]))
    assert_state_close(ps, np_tree(jax.tree.map(lambda x: x[None], st)),
                       layout, atol=1e-5, rtol=1e-5)


def test_bf16_round_keeps_the_fp32_leaves_and_matches_reference():
    """A bf16 model: the reference's bf16 state converts to two groups
    whose fp32 leaves are bit for bit the reference's; one engine round
    keeps them fp32 (and moves them), and each group is within a bf16 step
    of the reference's round (the relative distance of the updates)."""
    (jrun, st, jds, key), (trun, ps, tds, draws), layout = _engines(
        "bfloat16")
    assert isinstance(ps.server, Groups)
    assert [x.dtype for x in ps.server] == [torch.bfloat16, torch.float32]
    fp32 = [n for n, _ in layout.leaves if n in layout.fp32]
    assert {n.rsplit(".", 1)[-1] for n in fp32} == {"decay_base", "bonus_u",
                                                   "ln_x"}
    ref = convert.flatten_tree(np_tree(st.server))
    start = [x.float().clone() for x in ps.server]
    before = layout.views(ps.server)
    for name in fp32:
        assert np.array_equal(before[name][0].numpy().view(np.uint32),
                              np.asarray(ref[name]).view(np.uint32)), name
    ps, _, mets = trun(ps, tds, draws, 1)
    st, _, jm = jrun(st, jds, key, 1)
    np.testing.assert_allclose(mets["loss"][0].numpy(),
                               np.asarray(jm["loss"]), rtol=1e-2)
    for buf in (ps.server, ps.clients):
        assert [x.dtype for x in buf] == [torch.bfloat16, torch.float32]
    after = layout.views(ps.server)
    assert all(after[k].dtype == torch.float32 for k in fp32)
    assert any(not torch.equal(after[k], before[k]) for k in fp32)
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x)[None], st.server), layout,
        dtype=torch.bfloat16, cast=torch.float32)
    for got, ref, x0 in zip(ps.server, want, start):
        mine, theirs = got.float() - x0, ref - x0
        assert theirs.norm() > 0
        assert (mine - theirs).norm() <= 0.1 * theirs.norm()


_RUN = ["--device", "cpu", "--arch", ARCH, "--seq", "16", "--clients", "2",
        "--batch", "1", "--log-every", "1", "--ckpt-every", "2",
        "--dtype", "bfloat16"]


def test_train_launcher_trains_and_resumes_rwkv_on_cpu(tmp_path):
    """``launch/train.py --arch rwkv6-3b`` (reduced, bf16: two groups):
    finite losses, every client moved, the fp32 leaves fp32 in the server
    and the clients; ``--rounds 2`` then ``--rounds 3`` from its checkpoint
    directory equals an uninterrupted 3 bit for bit."""
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    a = train.main(_RUN + ["--rounds", "3", "--ckpt-dir", whole])
    assert len(a["losses"]) == 3 and np.isfinite(a["losses"]).all()
    layout = tmodel.param_layout(dataclasses.replace(
        reduced(get_config(ARCH)), dtype="bfloat16"))
    for buf in (a["state"].server, a["state"].clients):
        views = layout.views(buf)
        assert all(views[k].dtype == torch.float32 for k in layout.fp32)
    for c, i in zip(a["state"].clients, a["initial"]):
        assert all(not torch.equal(x, i[0]) for x in c[0])
    train.main(_RUN + ["--rounds", "2", "--ckpt-dir", cut])
    assert os.listdir(cut) == ["ckpt_00000002.npz"]
    c = train.main(_RUN + ["--rounds", "3", "--ckpt-dir", cut])
    assert c["losses"] == a["losses"][2:] and c["state"].round == 3
    for f in ("server", "clients"):
        for x, y in zip(getattr(a["state"], f), getattr(c["state"], f)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_over_slices_is_bit_for_bit(monkeypatch, momentum):
    """The SGD update of a buffer longer than ``optimizers._SLICE`` runs
    over column slices (a full-width bf16 model's fp32 temporaries would
    not fit the card beside its clients) and gives the bits of one call,
    in both groups' dtypes."""
    from repro_torch.optim import optimizers

    gen = torch.Generator().manual_seed(0)
    params = Groups((torch.randn(1, 3, 1000, generator=gen).bfloat16(),
                     torch.randn(1, 3, 10, generator=gen)))
    grads = Groups(torch.randn(x.shape, generator=gen).to(x.dtype)
                   for x in params)
    opt = sgd(paper_decay(LR), momentum=momentum)
    state = opt.init(params)
    whole = opt.update(params, state, grads)
    monkeypatch.setattr(optimizers, "_SLICE", 64)
    sliced = opt.update(params, state, grads)
    for a, b in zip(whole[0], sliced[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if momentum:
        assert all(torch.equal(a, b) for a, b in zip(whole[1]["mu"],
                                                     sliced[1]["mu"]))


def test_wkv6_work_counts_the_function():
    """``roofline.wkv6_work`` at the prefill shape [4, 40, 4096, 64]: the
    step recurrence's flops, each input read and each output written
    once."""
    bh, t, d = 160, 4096, 64
    work = wkv6_work(bh, t, d, heads=40)
    mat, state = 4 * bh * t * d, 4 * bh * d * d
    assert work["fwd"] == (bh * t * (5 * d * d + 5 * d),
                           5 * mat + 4 * 40 * d + 2 * state)
    assert work["bwd"] == (bh * t * (14 * d * d + 13 * d),
                           9 * mat + 8 * 40 * d + 3 * state)


@pytest.mark.parametrize("models", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_inputs_meet_the_kernels_layout(monkeypatch, dtype, models):
    """Every WKV6 call of a training step over one or two models hands the
    kernels what their wrapper checks on the card (``[b, G * H, T, D]``
    fp32, contiguous, 16-byte aligned; ``u [G * H, D]``, ``s0``), although
    the bonus is a view into the fp32 group at any offset."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import rwkv6_chunk as rk

    _, tcfg = _cfgs(dtype)
    calls, real = [], dispatch.wkv6

    def checked(r, k, v, w, u, s0, **kw):
        rk._check_inputs(r, k, v, w, u, s0)
        calls.append(tuple(r.shape))
        return real(r, k, v, w, u, s0, **kw)

    monkeypatch.setattr(dispatch, "wkv6", checked)
    init = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = (Groups(torch.stack([x] * models).requires_grad_(True)
                   for x in init) if isinstance(init, Groups)
            else torch.stack([init] * models).requires_grad_(True))
    toks = torch.as_tensor(_tokens(tcfg.vocab_size, (models,))[0])
    loss = tmodel.make_loss(tcfg)(flat, {"tokens": toks,
                                         "labels": toks.roll(-1, -1)})
    loss.sum().backward()
    heads = tcfg.d_model // tcfg.rwkv.head_dim
    assert calls == [(BATCH, models * heads, T, tcfg.rwkv.head_dim)] * \
        tcfg.num_layers


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_dryrun_counts_the_wkv6_kernels(mode):
    """The rwkv rows count the WKV6 kernels as the card launches them: a
    training round of m clients and s local steps one forward and one
    backward per layer and step, a prefill one forward per layer; each
    adds ``wkv6_work`` at its ``[b * H, T, D]``."""
    cfg = reduced(get_config(ARCH))
    m, s, b, t = 2, 2, 1, 64
    if mode == "train":
        got = dryrun.count_step(cfg, ShapeConfig("t", t, m * b, "train"),
                                num_clients=m, local_steps=s)
        want = {"fwd": s * cfg.num_layers, "bwd": s * cfg.num_layers}
    else:
        got = dryrun.count_step(cfg, ShapeConfig("p", t, b, "prefill"))
        want = {"fwd": cfg.num_layers, "bwd": 0}
    assert got["wkv6_launches"] == want
    assert got["flash_launches"] == {"fwd": 0, "dq": 0, "dkdv": 0}
    assert got["flops"] > 0 and got["bytes"] > 0
