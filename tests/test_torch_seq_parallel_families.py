"""The sequence split of the MoE, RWKV6 and hybrid families in one process:
the LM task's loss and gradients at ``[1, m, n]`` against the JAX
reference, on one device and assembled from 2 and 4 simulated ranks
(``tests/_seq_ranks.py``: one thread a rank, each with a
``pool.SequenceAxis`` whose collectives meet through shared memory, so
every exchange runs forward and backward as in a pool worker); each
carrying layer alone against its one-device run; and the MoE balance
loss's gradient through ``all_sum``. (The WKV6 kernels' zero-padded
head-dim route, which the RWKV6 LM takes on the card at its head dim of 8
or 16, is checked through the CUDA emulator in
``tests/test_torch_rwkv_pad_emulated.py``.)

The LM task is ``make_traced_lm_task`` in both packages at d_model 32, 2
layers, sequences of 16 (a chunk of 4 tokens on 4 ranks, past the Mamba
conv's 3 steps of context), m = 2 clients of 2 sequences each, from the
reference's own initial models (``jax.random.PRNGKey(i)`` for client
``i``, moved over with ``convert.params_from_jax``) and the reference
task's corpus. Tolerances, each with its reason:
- loss ``LOSS_TOL`` = 1e-5 and every leaf's gradient ``GRAD_TOL`` = 1e-4
  (absolute) against ``jax.value_and_grad`` of the reference's
  ``loss_fn``: the same operations, products and reductions in another
  order, and on the ranks the carried states and the whole-row MoE sums
  reassociated;
- a layer alone against its one-device run (itself held to the reference
  in ``tests/test_torch_rwkv.py``, ``tests/test_torch_ssm.py``,
  ``tests/test_torch_moe.py``): ``LAYER_TOL`` = 1e-5.
llama4-maverick (MoE, block-local "chunked" attention, which takes the
plain attention at any offset) runs split against the port's one-device
run only, within the same bars: the reference's LM task runs it too, but
a fourth compile of the reference's gradient would double this file's
time.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _seq_ranks import run_ranks  # noqa: E402
from repro.experiments import tasks as jtasks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.experiments import tasks as ttasks  # noqa: E402
from repro_torch.launch.roofline import sequence_exchanges  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv as trwkv_mod  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.sharding import pool as tpool  # noqa: E402

# held to the reference; maverick to the port's one device
REFERENCE_ARCHS = ("mixtral-8x22b", "rwkv6-3b", "jamba-1.5-large-398b")
ARCHS = REFERENCE_ARCHS + ("llama4-maverick-400b-a17b",)
LOSS_TOL, GRAD_TOL, LAYER_TOL = 1e-5, 1e-4, 1e-5
M, B, T = 2, 2, 16
TASK = dict(num_clients=M, d_model=32, layers=2, seq_len=T, n_seqs=16,
            n_test=4, per_client=8, batch_size=B)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: under ``pytest -n 6`` its
    process shares the host with five others, and the simulated ranks are
    threads of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(arch):
    """The port's task, the clients' flat models ``[1, M, n]``, the batch
    ``[1, M, B, T]`` and the wanted losses ``[1, M]`` and flat gradients
    ``[1, M, n]``: the reference's for ``REFERENCE_ARCHS``, else the
    port's own on one device."""
    jt = jtasks.make_traced_lm_task(arch=arch, data_seed=0, **TASK)
    tt = ttasks.make_traced_lm_task(arch=arch, data_seed=0, device="cpu",
                                    **TASK)
    toks = np.asarray(jt.shared["toks"])[:M * B].reshape(M, B, T + 1)
    seqs = torch.as_tensor(toks[None].astype(np.int64))
    batch = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    step = jax.jit(jax.value_and_grad(jt.loss_fn))
    flat, losses, grads = [], [], []
    for i in range(M):
        params = jt.init_params(jax.random.PRNGKey(i))
        flat.append(convert.params_from_jax(jax.tree.map(np.asarray, params),
                                            tt.layout))
        if arch in REFERENCE_ARCHS:
            loss, grad = step(params, {"tokens": toks[i, :, :-1],
                                       "labels": toks[i, :, 1:]})
            grads.append(convert.params_from_jax(
                jax.tree.map(np.asarray, grad), tt.layout))
            losses.append(float(loss))
    flat = torch.stack(flat)[None]
    if arch not in REFERENCE_ARCHS:
        loss, grad = _loss_and_grad(tt, flat, batch)
        return tt, flat, batch, loss.numpy(), grad
    return tt, flat, batch, np.array([losses]), torch.stack(grads)[None]


def _loss_and_grad(task, flat, batch):
    leaf = flat.clone().requires_grad_(True)
    loss = task.loss_fn(leaf, batch)
    grad, = torch.autograd.grad(loss.sum(), leaf)
    return loss.detach(), grad


def _close(loss, grad, want_loss, want_grad):
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), rtol=0,
                               atol=GRAD_TOL)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_one_device_lm_task_matches_the_reference(arch):
    """The port's LM-task loss and every leaf's gradient of each client on
    one device, against the reference's, within ``LOSS_TOL`` /
    ``GRAD_TOL``."""
    task, flat, batch, want_loss, want_grad = _case(arch)
    _close(*_loss_and_grad(task, flat, batch), want_loss, want_grad)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_assemble_the_reference_loss_and_gradients(arch, ranks):
    """Each simulated rank trains on its chunk of every sequence with the
    axis active (the carries, the whole-row MoE routing and the K/V
    gathers exchanged), then all-reduces its loss and gradient over the
    ranks as the round does (``reduce_loss``, ``reduce_grads``): every
    rank holds the same bits, within ``LOSS_TOL`` / ``GRAD_TOL`` of the
    reference (maverick: of the port's one device). Each rank's collectives are the dense count of the
    attention layers plus ``roofline.sequence_exchanges``."""
    task, flat, batch, want_loss, want_grad = _case(arch)

    def rank(axis):
        loss, grad = _loss_and_grad(
            task, flat, {k: axis.take_seq(v) for k, v in batch.items()})
        out = axis.reduce_loss(loss), axis.reduce_grads(grad)
        return out, axis.stats()

    got = run_ranks(ranks, rank)
    for (loss, grad), _ in got[1:]:
        assert torch.equal(loss, got[0][0][0])
        assert torch.equal(grad, got[0][0][1])
    _close(*got[0][0], want_loss, want_grad)
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=32,
                                      layers=2), dtype="float32")
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    kv = B * T * cfg.attention.num_kv_heads * cfg.head_dim * 4
    want = {"all-gather": [2 * attn * M * kv, 2 * attn],
            "all-reduce": [2 * attn * M * kv + 4 * flat.numel() + 4 * M,
                           2 * attn + 2]}
    for kind, nbytes, n in sequence_exchanges(cfg, batch=B, seq_len=T,
                                              ranks=ranks):
        want[kind][0] += n * nbytes * M
        want[kind][1] += n
    for _, st in got:
        assert {k: [st.bytes_by_kind[k], st.count_by_kind[k]]
                for k in want} == want


# -- each carrying layer alone, against its one-device run -----------------

G, LB = 2, 2        # models and rows of the layer cases


def _leaves(cfg, names_shapes, init, seed):
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.stack([init(gen, n, s, torch.float32)
                            for _ in range(G)]) for n, s in names_shapes}


def _split_check(fn, x, leaves, ranks, seed):
    """``fn(x, leaves, axis) -> (out, extra)`` on one device (``axis``
    None) and on ``ranks`` simulated ranks, each with its chunk of ``x``
    along dim 2: the joined outputs, the joined ``x`` gradients and the
    leaves' gradients summed over the ranks equal the one-device ones
    within ``LAYER_TOL`` for a random output gradient; ``extra`` (the MoE
    aux, whole-row) is the same on every rank and on one device, and each
    rank weighs it ``1 / ranks`` in its objective, so that the ranks' sum
    is one device's (the round weighs every rank's loss so, through
    ``reduce_grads``)."""

    def ranks_of(axis):
        return 1 if axis is None else axis.size
    g = torch.Generator().manual_seed(seed)
    dout = torch.randn(x.shape, generator=g)

    def grads(xin, axis, dslice):
        xs = xin.clone().requires_grad_(True)
        ls = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        out, extra = fn(xs, ls, axis)
        gr = torch.autograd.grad(
            [out] + ([extra] if extra is not None else []),
            [xs] + list(ls.values()),
            [dslice] + ([torch.full_like(extra, 1.0 / ranks_of(axis))]
                        if extra is not None else []))
        return out.detach(), extra, gr

    want_out, want_extra, want_g = grads(x, None, dout)
    xc = torch.chunk(x, ranks, 2)
    dc = torch.chunk(dout, ranks, 2)
    got = run_ranks(ranks, lambda a: grads(xc[a.index], a, dc[a.index]))
    torch.testing.assert_close(torch.cat([o for o, _, _ in got], 2),
                               want_out, rtol=LAYER_TOL, atol=LAYER_TOL)
    torch.testing.assert_close(torch.cat([gr[0] for _, _, gr in got], 2),
                               want_g[0], rtol=LAYER_TOL, atol=LAYER_TOL)
    for i in range(1, len(want_g)):
        torch.testing.assert_close(sum(gr[i] for _, _, gr in got),
                                   want_g[i], rtol=LAYER_TOL, atol=LAYER_TOL)
    if want_extra is not None:
        for _, extra, _ in got:
            torch.testing.assert_close(extra.detach(), want_extra.detach(),
                                       rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("ranks", [2, 4])
def test_rwkv6_layer_alone(ranks):
    """RWKV6's time mix then channel mix of G models on ``[G, b, T, d]``:
    the token shifts' carries (``prev_rows``) and the WKV6 state entering
    each chunk (``carry_in`` of the chunk-final states from zero and their
    summed log decays, then a second WKV6 call from it), at head dim 8
    and strong data-dependent decay."""
    cfg = dataclasses.replace(reduced(get_config("rwkv6-3b"), d_model=32,
                                      layers=1), dtype="float32")
    leaves = _leaves(cfg, trwkv_mod.rwkv_leaves(cfg), trwkv_mod.init_leaf,
                     ranks)
    leaves["decay_base"] = leaves["decay_base"] + 3.0       # w down to ~0
    x = torch.randn(G, LB, T, cfg.d_model,
                    generator=torch.Generator().manual_seed(10 + ranks))

    def fn(xs, ls, axis):
        h, _ = trwkv_mod.rwkv_time_mix(ls, xs, cfg, seq=axis)
        y = xs + h
        h, _ = trwkv_mod.rwkv_channel_mix(ls, y, seq=axis)
        return y + h, None

    _split_check(fn, x, leaves, ranks, 20 + ranks)


@pytest.mark.parametrize("ranks", [2, 4])
def test_mamba_block_alone(ranks):
    """jamba's Mamba block of G models: the causal conv's left context
    (``prev_rows`` of ``conv_width - 1`` rows) and the scan's entering
    state (``carry_in`` with decay ``exp(A * sum_t dt_t)``)."""
    cfg = dataclasses.replace(
        reduced(get_config("jamba-1.5-large-398b"), d_model=32, layers=2),
        dtype="float32")
    leaves = _leaves(cfg, tssm.ssm_leaves(cfg), tssm.init_leaf, ranks)
    leaves["dt_bias"] = leaves["dt_bias"] + 3.0          # strong decay
    x = torch.randn(G, LB, T, cfg.d_model,
                    generator=torch.Generator().manual_seed(30 + ranks))
    _split_check(lambda xs, ls, axis: (tssm.ssm_apply(ls, xs, cfg,
                                                      seq=axis)[0], None),
                 x, leaves, ranks, 40 + ranks)


def _moe_cfg(capacity_factor):
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x22b"),
                                      d_model=32, layers=1),
                              dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("ranks", [2, 4])
def test_moe_layer_alone(ranks, capacity_factor):
    """An MoE layer of G models, each row one dispatch group across the
    ranks: the capacity of the whole row, each slot after the earlier
    ranks' counts of its expert (at capacity factor 0.5 tokens overflow,
    later ranks' first), and the balance loss's whole-row means; outputs,
    aux and gradients as one device's."""
    cfg = _moe_cfg(capacity_factor)
    leaves = _leaves(cfg, tmoe.moe_leaves(cfg), tmoe.init_leaf, ranks)
    x = torch.randn(G, LB, T, cfg.d_model,
                    generator=torch.Generator().manual_seed(50 + ranks))

    def fn(xs, ls, axis):
        ps = [{k: v[g] for k, v in ls.items()} for g in range(G)]
        return tmoe.moe_apply_models(ps, xs, cfg, axis)

    _split_check(fn, x, leaves, ranks, 60 + ranks)


@pytest.mark.parametrize("ranks", [2, 4])
def test_moe_aux_gradient_sums_over_the_ranks(ranks, monkeypatch):
    """Every rank adds the whole row's balance loss to its own loss, and
    the round averages the ranks' gradients (``reduce_grads``), so
    ``all_sum``'s backward must sum the gradient over the ranks. As built,
    the router's averaged gradient of the aux equals one device's; with an
    identity backward (patched in here) it comes out ``1 / ranks`` of it,
    and this test's comparison fails."""
    cfg = _moe_cfg(1.25)
    leaves = _leaves(cfg, tmoe.moe_leaves(cfg), tmoe.init_leaf, 70 + ranks)
    x = torch.randn(G, LB, T, cfg.d_model,
                    generator=torch.Generator().manual_seed(80 + ranks))

    def aux_grad(xs, axis):
        router = leaves["router"].clone().requires_grad_(True)
        ps = [{**{k: v[g] for k, v in leaves.items()}, "router": router[g]}
              for g in range(G)]
        _, aux = tmoe.moe_apply_models(ps, xs, cfg, axis)
        grad, = torch.autograd.grad(aux.sum(), router)
        return grad if axis is None else axis.reduce_grads(grad)

    want = aux_grad(x, None)
    assert want.abs().max() > 1e-3
    xc = torch.chunk(x, ranks, 2)
    got = run_ranks(ranks, lambda a: aux_grad(xc[a.index], a))[0]
    torch.testing.assert_close(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)
    monkeypatch.setattr(tpool._AllSum, "backward",
                        staticmethod(lambda ctx, g: (g, None)))
    cut = run_ranks(ranks, lambda a: aux_grad(xc[a.index], a))[0]
    torch.testing.assert_close(cut * ranks, want, rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    assert not torch.allclose(cut, want, rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_memory_families_refuse_a_sequence_axis(arch):
    """The vlm and audio families raise under a sequence axis before any
    work, saying why: the LM sweep gives their cross layers no memory."""
    cfg = reduced(get_config(arch))
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="memory"):
        run_ranks(2, lambda a: tmodel.hidden_forward({}, cfg, tokens))
