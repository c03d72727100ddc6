"""Training of the model zoo's MoE, hybrid, vlm and audio families on the
port (``launch/train.py --arch mixtral-8x22b, llama4-maverick-400b-a17b,
jamba-1.5-large-398b, llama-3.2-vision-90b, seamless-m4t-medium``) against
the JAX reference on the CPU, at ``reduced()``.

In fp32 (one parameter buffer), from the reference's weights carried
across by ``convert`` and the same tokens: the loss of two models at once
(leading model axis 2, each with its own seeded memory) and its gradient
w.r.t. every leaf, against ``jax.value_and_grad`` of the reference's
``loss_fn(remat=False)`` (the ``0.01 * aux`` balance term and the memory
included); three engine rounds on the reference launcher's own draws
(``tests/_torch_parity.py``'s ``lm_round_draws``), re-synced from the
reference's state every round, with the launcher's constant memory. The
reference's ``test_one_federated_train_step`` contract holds on the port
for every arch (rwkv6-3b's training is ``tests/test_torch_train_rwkv.py``'s
subject). ``lm_source``'s
memory leaves equal the reference's. In bf16 the fp32 leaves make two
parameter groups: the layout round trip is exact and keeps an fp32 value
bf16 cannot hold bit for bit, and one engine round keeps them fp32.

The vlm's ``cross_gate`` starts at 0, where a broken cross-attention
would pass unseen, so the comparisons set it to 1.0 in the reference's
weights first (as ``tests/test_torch_zoo.py`` does).

Tolerances, each with its reason:
- the fp32 loss: 1e-5 (the same fp32 products in another order through 2
  layers, as ``tests/test_torch_lm.py``);
- fp32 gradients: atol = rtol = 1e-4 (the same, through the backward of
  the MoE dispatch, the Mamba scan and the fp32 encoder);
- fp32 engine rounds, re-synced: 1e-4 (two local SGD steps on those
  gradients);
- the bf16 round: each group's largest |port - reference| within 1e-2 of
  its largest |reference| (a bf16 step, 2^-8 = 3.9e-3, where another order
  of an fp32 sum rounds a parameter the other way), and the losses within
  1e-2 relative;
- layout round trips and memory leaves: exact.
"""
import dataclasses

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
from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.configs import FederationConfig as TFed  # noqa: E402
from repro_torch.core import Groups, federated as tfed  # noqa: E402
from repro_torch.core import make_algorithm_spec  # noqa: E402
from repro_torch.core import make_link_process, make_round_fn  # noqa: E402
from repro_torch.data import lm_source  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import paper_decay, sgd  # noqa: E402

ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
         "llama-3.2-vision-90b", "seamless-m4t-medium")
M, S, BATCH, T, LR = 2, 2, 2, 16, 0.1
P_BASE = np.asarray([0.9, 0.4], np.float32)


def _cfgs(arch, dtype="float32", dense_ffn=False):
    """Both packages' reduced config in ``dtype``; ``dense_ffn``: the MoE
    layers cut to dense FFNs (``moe=None``)."""
    out = [dataclasses.replace(red(get(arch)), dtype=dtype)
           for get, red in ((jget_config, jreduced), (get_config, reduced))]
    return [dataclasses.replace(c, moe=None) for c in out] if dense_ffn \
        else out


def _ref_params(jcfg, seed):
    """The reference's weights at ``seed``, the vlm's ``cross_gate`` at 1.0."""
    params = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.family == "vlm":
        params["blocks"] = tuple(
            dict(blk, cross_gate=jnp.ones_like(blk["cross_gate"]))
            if "cross_gate" in blk else blk for blk in params["blocks"])
    return params


def _memory_shape(cfg):
    """The reference launcher's memory shape (``repro/launch/train.py``)."""
    if cfg.family == "vlm":
        return (BATCH, cfg.num_image_tokens, cfg.d_model)
    if cfg.family == "audio":
        return (BATCH, cfg.num_audio_frames, cfg.d_model)
    return None


def _fp32_leaves(layout):
    return [name for name, _ in layout.leaves if name in layout.fp32]


# ---------------------------------------------------------------------------
# the loss and its gradient (fp32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """Two models at once, each with its own seeded memory: the loss (the
    cross-entropy plus ``0.01 * aux``) and every leaf's gradient."""
    jcfg, tcfg = _cfgs(arch)
    ps = [_ref_params(jcfg, s) for s in (1, 2)]
    layout = tmodel.param_layout(tcfg)
    flat = torch.stack([convert.lm_params_from_jax(np_tree(p), tcfg)
                        for p in ps])
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, BATCH, T))
    labels = np.roll(toks, -1, axis=-1)
    shape = _memory_shape(tcfg)
    mem = None if shape is None else (
        0.1 * rng.standard_normal((2,) + shape)).astype(np.float32)
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    if mem is not None:
        batch["memory"] = torch.as_tensor(mem)
    leaf = flat.clone().requires_grad_(True)
    loss = tmodel.make_loss(tcfg)(leaf, batch)
    (grad,) = torch.autograd.grad(loss.sum(), leaf)
    grads = layout.views(grad)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=False)))
    for i in range(2):
        jb = {"tokens": jnp.asarray(toks[i]), "labels": jnp.asarray(labels[i])}
        if mem is not None:
            jb["memory"] = jnp.asarray(mem[i])
        val, g = value_and_grad(ps[i], jb)
        assert abs(loss[i].item() - float(val)) <= 1e-5 * max(1.0, abs(val))
        want = convert.flatten_tree(np_tree(g))
        for name, got in grads.items():
            np.testing.assert_allclose(got[i].numpy(), want[name], rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    if tcfg.moe:       # the balance term is in the loss: aux > 0
        _, aux = tmodel.forward(layout.views(flat), tcfg,
                                torch.as_tensor(toks))
        assert (aux > 0).all()


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_apply_gradients_match_reference_in_both_dispatches(dispatch):
    """Both MoE dispatches under autograd (``reduced(mixtral-8x22b)``, its
    capacity factor 1.25, so slots are dropped): the gradient w.r.t. the
    input and every MoE leaf, through the output and the balance loss,
    within fp32 1e-5 of ``jax.grad`` of the reference's ``moe_apply``; in
    bf16 the router's gradient is fp32 and the experts' bf16."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dispatch=dispatch)) for c in _cfgs("mixtral-8x22b", dtype))
        p = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
        w = rng.standard_normal(x.shape).astype(np.float32)
        tdt = getattr(torch, dtype)
        tp = {k: torch.as_tensor(np.asarray(v, np.float32)).to(
            torch.float32 if k == "router" else tdt).requires_grad_(True)
            for k, v in p.items()}
        tx = torch.as_tensor(x).to(tdt).requires_grad_(True)
        out, aux = tmoe.moe_apply(tp, tx, tcfg)
        ((out.float() * torch.as_tensor(w)).sum() + aux).backward()
        assert tp["router"].grad.dtype == torch.float32
        assert tx.grad.dtype == tdt
        if dtype == "bfloat16":
            assert tp["up"].grad.dtype == torch.bfloat16
            continue

        def f(p, x):
            o, a = jmoe.moe_apply(p, x, jcfg)
            return (o * w).sum() + a

        gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                                   rtol=1e-5, atol=1e-5)
        for k, v in tp.items():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(gp[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_checkpointed_selective_scan_gradients_match_the_step_recurrence():
    """Under autograd the chunked doubling scan runs each chunk under
    activation checkpointing (one checkpoint per chunk, ragged last chunk
    included); its gradients w.r.t. every input equal the autograd of the
    plain step recurrence within fp32 1e-5."""
    from unittest import mock

    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(0)
    B, T, di, N = 2, 40, 8, 4
    ins = [torch.randn(B, T, di, generator=g),
           torch.rand(B, T, di, generator=g) * 0.5,
           torch.randn(B, T, N, generator=g), torch.randn(B, T, N, generator=g),
           -torch.rand(di, N, generator=g), torch.randn(B, di, N, generator=g)]
    grads, calls = [], []
    real = ssm.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for fn in (lambda *z: ssm.selective_scan(*z, chunk=16),
               ssm.selective_scan_steps):
        leaves = [z.clone().requires_grad_(True) for z in ins]
        with mock.patch.object(ssm, "checkpoint", counted):
            y, h = fn(*leaves)
        grads.append(torch.autograd.grad((y.sum() + h.square().sum()),
                                         leaves))
    assert len(calls) == 3            # chunks of 16, 16 and 8
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the round engine (fp32, re-synced every round)
# ---------------------------------------------------------------------------


def _engines(arch, dtype="float32", seed=0, rounds=3, dense_ffn=False):
    jcfg, tcfg = _cfgs(arch, dtype, dense_ffn)
    kw = dict(algorithm="fedpbc", num_clients=M, local_steps=S,
              scheme="bernoulli")
    jfedc, tfedc = JFed(**kw), TFed(**kw)
    shape = _memory_shape(tcfg)
    jalgo = jmake_algorithm(jfedc)
    jlink = jmake_link(jnp.asarray(P_BASE), jfedc)
    jopt = jsgd(jdecay(LR))
    jsrc = jlm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                      vocab=jcfg.vocab_size, memory_shape=shape)
    jrun = jmake_run_rounds(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=False), jopt, jalgo,
        jlink, jfedc, jsrc)
    st = jinit_fed_state(jax.random.PRNGKey(seed + 2),
                         _ref_params(jcfg, seed + 1), jfedc, jalgo, jlink,
                         jopt)
    jds = jsrc.init(jax.random.PRNGKey(seed + 3))
    tsrc = lm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                     vocab=tcfg.vocab_size, memory_shape=shape)
    trun = tfed.make_run_rounds(
        tmodel.make_loss(tcfg), sgd(paper_decay(LR)),
        make_algorithm_spec(("fedpbc",), tfedc),
        make_link_process(torch.as_tensor(P_BASE)[None], tfedc), tfedc,
        tsrc, device="cpu")
    lo, draws = lm_round_draws(tcfg.vocab_size, seed, rounds, M, S, BATCH, T)
    tds = tsrc.init(torch.as_tensor(lo)[None])
    layout = tmodel.param_layout(tcfg)
    return (jrun, st, jds, jax.random.PRNGKey(seed + 4)), \
        (trun, tds, lambda t: draws[t]), layout, tcfg


def _port_state(st, layout, dtype=torch.float32):
    return convert.fed_state_from_jax(
        np_tree(jax.tree.map(lambda x: x[None], st)), layout, "bernoulli",
        dtype=dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_rounds_resynced_match_reference(arch):
    """Each of 3 rounds from the reference's state, on its own draws, with
    the launcher's constant memory for the vlm and audio families."""
    (jrun, st, jds, data_key), (trun, tds, draws), layout, _ = _engines(arch)
    for _ in range(3):
        ps = _port_state(st, layout)
        ps, tds, mets = trun(ps, tds, draws, 1)
        st, jds, jm = jrun(st, jds, data_key, 1)
        np.testing.assert_allclose(mets["loss"][0].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(mets["num_active"][0].numpy(),
                                      np.asarray(jm["num_active"]))
        assert_state_close(ps, np_tree(jax.tree.map(lambda x: x[None], st)),
                           layout, atol=1e-4, rtol=1e-4)
    assert int(np.asarray(st.round)) == 3


# the bf16 round against the reference's: the families whose fp32 leaves
# are the cross gate (vlm, audio) and the Mamba leaves (jamba with its MoE
# layers cut to dense FFNs, ``moe=None`` in both packages): bf16 MoE
# routing differs between the reference's jitted and eager runs
# (``test_reference_bf16_moe_forward_differs_between_jit_and_eager``)
BF16_ROUND = (("llama-3.2-vision-90b", False), ("seamless-m4t-medium", False),
              ("jamba-1.5-large-398b", True))


@pytest.mark.parametrize("arch,dense_ffn", BF16_ROUND)
def test_bf16_round_keeps_the_fp32_leaves_and_matches_reference(arch,
                                                                dense_ffn):
    """A bf16 model with fp32 leaves: one engine round on two parameter
    groups from the reference's bf16 state; the fp32 leaves stay fp32 (and
    move), and each group is within a bf16 step of the reference's."""
    (jrun, st, jds, data_key), (trun, tds, draws), layout, tcfg = \
        _engines(arch, "bfloat16", rounds=1, dense_ffn=dense_ffn)
    ps = _port_state(st, layout, torch.bfloat16)
    assert isinstance(ps.server, Groups) and isinstance(ps.clients, Groups)
    assert [x.dtype for x in ps.server] == [torch.bfloat16, torch.float32]
    before = layout.views(ps.server)
    ps, _, mets = trun(ps, tds, draws, 1)
    st, _, jm = jrun(st, jds, data_key, 1)
    np.testing.assert_allclose(mets["loss"][0].numpy(),
                               np.asarray(jm["loss"]), rtol=1e-2)
    assert [x.dtype for x in ps.server] == [torch.bfloat16, torch.float32]
    assert [x.dtype for x in ps.clients] == [torch.bfloat16, torch.float32]
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x)[None], st.server), layout,
        dtype=torch.bfloat16, cast=torch.float32)
    for got, ref in zip(ps.server, want):
        err = (got.float() - ref).abs().max().item()
        assert err <= 1e-2 * ref.abs().max().item()
    after = layout.views(ps.server)
    fp32 = _fp32_leaves(layout)
    assert fp32 and all(after[k].dtype == torch.float32 for k in fp32)
    assert any(not torch.equal(after[k], before[k]) for k in fp32)


@pytest.mark.parametrize("arch", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_bf16_moe_round_keeps_the_router_fp32(arch):
    """The MoE archs in bf16, on the port's own init and draws: one engine
    round keeps every router leaf fp32 in the fp32 group and moves it in
    every client; the losses are finite."""
    _, tcfg = _cfgs(arch, "bfloat16")
    layout = tmodel.param_layout(tcfg)
    fed = TFed(algorithm="fedpbc", num_clients=M, local_steps=S)
    algo = make_algorithm_spec(("fedpbc",), fed)
    link = make_link_process(torch.as_tensor(P_BASE)[None], fed)
    src = lm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                    vocab=tcfg.vocab_size)
    run = tfed.make_run_rounds(tmodel.make_loss(tcfg), sgd(paper_decay(LR)),
                               algo, link, fed, src, device="cpu")
    lo, draws = lm_round_draws(tcfg.vocab_size, 0, 1, M, S, BATCH, T)
    server = Groups(x[None] for x in tmodel.init_params(
        torch.Generator().manual_seed(0), tcfg))
    st = tfed.init_fed_state(draws[0].u, server, fed, algo, link,
                             sgd(paper_decay(LR)))
    before = layout.views(st.clients)
    st, _, mets = run(st, src.init(torch.as_tensor(lo)[None]),
                      lambda t: draws[t], 1)
    assert torch.isfinite(mets["loss"]).all()
    after = layout.views(st.clients)
    routers = [k for k in after if k.endswith("moe.router")]
    assert routers and set(routers) <= layout.fp32
    for k in routers:
        assert after[k].dtype == torch.float32
        assert all(not torch.equal(a, b)
                   for a, b in zip(after[k][0], before[k][0]))


def test_reference_bf16_moe_forward_differs_between_jit_and_eager():
    """A reference-side fact, not a port fault: on mixtral's reduced bf16
    model and the first client's first batch of the engine tests, the
    reference's jitted ``forward`` differs from its own eager
    (``jax.disable_jit``) ``forward`` by far more than a bf16 step (1.23
    of a largest |logit| of 4.5 when this was written: another expert for
    some tokens, after XLA's fusions round the activations at other
    places), while the port's forward is within a bf16 step of the eager
    one. So the MoE archs' bf16 rounds are held to their dtypes and loss
    above, not parameter for parameter."""
    jcfg, tcfg = _cfgs("mixtral-8x22b", "bfloat16")
    params = _ref_params(jcfg, 1)
    lo, draws = lm_round_draws(tcfg.vocab_size, 0, 1, M, S, BATCH, T)
    toks = lo[0] + draws[0].pick[0, 0, 0].numpy()
    jit = np.asarray(jax.jit(lambda p, tk: jmodel.forward(p, jcfg, tk)[0])(
        params, jnp.asarray(toks)))
    with jax.disable_jit():
        eager = np.asarray(jmodel.forward(params, jcfg,
                                          jnp.asarray(toks))[0])
    flat = convert.lm_params_from_jax(np_tree(params), tcfg)
    layout = tmodel.param_layout(tcfg)
    with torch.no_grad():
        port, _ = tmodel.forward(layout.views(Groups(x[None] for x in flat)),
                                 tcfg, torch.as_tensor(toks)[None])
    scale = np.abs(eager).max()
    assert np.abs(port[0].numpy() - eager).max() <= 2e-2 * scale
    assert np.abs(jit - eager).max() > 0.1 * scale


# ---------------------------------------------------------------------------
# parameter groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layout_round_trip_is_exact_in_two_groups(arch):
    """The reference's bf16 weights -> the port's two groups (bf16, fp32):
    every view equals its leaf, and an fp32 leaf value that bf16 cannot
    hold (1 + 2^-20) survives bit for bit; ``pack`` of the views gives the
    same buffers; ``flatten`` still refuses one bf16 buffer."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    params = np_tree(_ref_params(jcfg, 0))
    leaves = convert.flatten_tree(params)
    layout = tmodel.param_layout(tcfg)
    fp32 = _fp32_leaves(layout)
    odd = np.float32(1 + 2 ** -20)
    assert np.float32(jnp.asarray(odd).astype(jnp.bfloat16)) != odd
    target = fp32[0]
    leaves[target] = np.full_like(leaves[target], odd)
    got = layout.pack(leaves, dtype=torch.bfloat16)
    assert isinstance(got, Groups)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.float32]
    assert sum(x.numel() for x in got) == layout.size
    assert layout.sizes(torch.bfloat16) == tuple(x.numel() for x in got)
    views = layout.views(got)
    assert list(views) == [name for name, _ in layout.leaves]
    for name, view in views.items():
        want = np.asarray(leaves[name])
        assert view.dtype == (torch.float32 if name in layout.fp32
                              else torch.bfloat16), name
        np.testing.assert_array_equal(view.float().numpy(),
                                      want.astype(np.float32), err_msg=name)
    assert (views[target].numpy() == odd).all()
    again = layout.pack(views, dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    # one group in fp32, and the refusal of one bf16 buffer stays
    assert isinstance(layout.pack(leaves), torch.Tensor)
    with pytest.raises(ValueError, match="fp32 leaves"):
        layout.flatten(leaves, dtype=torch.bfloat16)
    # the engine's init gives the same two groups
    init = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    assert [x.dtype for x in init] == [torch.bfloat16, torch.float32]
    assert [x.shape for x in init] == [x.shape for x in got]


def test_unflatten_assembles_each_groups_gradient():
    """The gradient through ``unflatten`` of two groups lands in each
    group's buffer, in its dtype, equal to the gradient through the plain
    views."""
    _, tcfg = _cfgs("jamba-1.5-large-398b", "bfloat16")
    layout = tmodel.param_layout(tcfg)
    flat = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    weights = {name: torch.randn(shape, generator=torch.Generator()
                                 .manual_seed(i))
               for i, (name, shape) in enumerate(layout.leaves)}
    grads = []
    for fn in (layout.unflatten, layout.views):
        leaf = Groups(x.clone().requires_grad_(True) for x in flat)
        tot = sum((v.float() * weights[k]).sum() for k, v in fn(leaf).items())
        grads.append(torch.autograd.grad(tot, list(leaf)))
    for a, b, x in zip(*grads, flat):
        assert a.dtype == x.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's contracts on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_federated_train_step(arch):
    """``tests/test_arch_smoke.py``'s contract on the port: one FedPBC round
    over the reduced arch (fp32), loss finite, params move."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    m, s, B, Tt = 2, 1, 2, 16
    fed = TFed(algorithm="fedpbc", num_clients=m, local_steps=s)
    algo = make_algorithm_spec(("fedpbc",), fed)
    link = make_link_process(torch.ones(1, m), fed)      # always on
    opt = sgd(1e-2)
    rf = make_round_fn(tmodel.make_loss(cfg), opt, algo, link, fed)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)[None]
    st = tfed.init_fed_state(torch.rand(1, m), params, fed, algo, link, opt)
    toks = torch.randint(0, cfg.vocab_size, (1, m, s, B, Tt),
                         generator=torch.Generator().manual_seed(2))
    batches = {"tokens": toks, "labels": toks.roll(-1, -1)}
    shape = _memory_shape(cfg)
    if shape is not None:
        batches["memory"] = 0.1 * torch.ones((1, m, s, B) + shape[1:])
    with torch.no_grad():
        st2, mets = rf(st, batches, torch.rand(1, m))
    assert np.isfinite(mets["loss"].numpy()).all()
    assert not torch.allclose(st.server, st2.server)


def test_lm_source_memory_leaves_match_reference():
    """``memory_shape`` adds the reference's constant ``0.1 * ones`` fp32
    memory, ``[B, m, s, *shape]`` (a cohort's ``[B, C, s, *shape]``), as
    an expand of one value."""
    shape, vocab = (BATCH, 16, 32), 64
    jsrc = jlm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                      vocab=vocab, memory_shape=shape)
    tsrc = lm_source(num_clients=M, local_steps=S, batch=BATCH, seq=T,
                     vocab=vocab, memory_shape=shape)
    lo, draws = lm_round_draws(vocab, 0, 1, M, S, BATCH, T)
    jb, _ = jsrc.sample(jsrc.init(jax.random.PRNGKey(3)), 0,
                        jax.random.fold_in(jax.random.PRNGKey(4), 0))
    tb, _ = tsrc.sample(tsrc.init(torch.as_tensor(lo)[None]), 0,
                        draws[0].pick)
    assert set(tb) == set(jb) == {"tokens", "labels", "memory"}
    for k in ("tokens", "labels", "memory"):
        np.testing.assert_array_equal(tb[k][0].numpy(), np.asarray(jb[k]))
    assert tb["memory"].dtype == torch.float32
    assert tb["memory"].stride() == (0,) * tb["memory"].dim()
    cohort = torch.tensor([[1]])
    cb, _ = tsrc.sample_cohort(tsrc.init(torch.as_tensor(lo)[None]), 0,
                               cohort, draws[0].pick[:, 1:])
    assert tuple(cb["memory"].shape) == (1, 1, S) + shape
    np.testing.assert_array_equal(cb["tokens"][0].numpy(),
                                  tb["tokens"][0, 1:].numpy())


def test_scale_engines_refuse_two_groups():
    """The cohort and buffered engines take one parameter buffer; two
    groups raise, naming the gap."""
    _, tcfg = _cfgs("seamless-m4t-medium", "bfloat16")
    fed = TFed(algorithm="fedpbc", num_clients=M, local_steps=S)
    algo = make_algorithm_spec(("fedpbc",), fed)
    link = make_link_process(torch.ones(1, M), fed)
    server = Groups(x[None] for x in tmodel.init_params(
        torch.Generator().manual_seed(0), tcfg))
    for kw in (dict(stateless_clients=True), dict(buffered=True)):
        with pytest.raises(NotImplementedError, match="parameter groups"):
            tfed.init_fed_state(torch.rand(1, M), server, fed, algo, link,
                                sgd(0.1), **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_the_family_on_cpu(arch):
    """``launch/train.py --arch <arch> --reduced`` on the CPU: finite
    losses, the clients' models move."""
    out = train.main(["--device", "cpu", "--arch", arch, "--rounds", "2",
                      "--log-every", "1", "--seq", "16", "--clients", "2",
                      "--batch", "1"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["state"].round == 2
    clients = out["state"].clients[0]
    assert all(not torch.equal(c, out["initial"][0]) for c in clients)
