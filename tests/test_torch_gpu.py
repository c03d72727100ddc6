"""The port's kernels on the card, against their plain versions. Every test
here is ``gpu``-marked and skips without CUDA.

This file imports neither JAX nor the reference package, so it also runs
on the machine with the card, where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \\
        -m gpu tests/test_torch_gpu.py

Tolerances: the flash-attention kernels vs the plain version and its
autograd, fp32 atol and rtol 2e-3 (the reference's kernel tolerance: an
online softmax in tiles vs a full one), bf16 atol 1e-2 and rtol 3e-2 (the
reference's rtol; the atol as in ``chip_smoke.py``, from the measured
errors; bf16 takes the tensor-core kernels, fp32 the CUDA-core ones);
the aggregation kernel 1e-5
(fp32 sums over 3 terms in another order; bf16 input 2e-2, as
``tests/test_torch_kernels.py``); the LM loss and its gradient
through the kernel vs the plain attention, bf16 5e-2 relative to the
largest gradient (bf16 activations rounded at other places); the WKV6
kernels (both routes: the chunked one's products in 3xTF32) vs the plain
chunked version and the step scan, fp32 atol and rtol 1e-4 (as their
emulated build; the reference's kernel tolerance is 3e-3), at the
serving shapes 1e-3 (64 chunks of a 4096-step sequence, and ``__expf``
on the card).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import masked_agg as tmasked  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as trwkv  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

# the shapes of tests/test_kernels.py::test_flash_attention_sweep, then a
# ragged T at D = 32 and a bf16 window with softcap, then the tensor-core
# backward (bf16) at D = 128 and at D = 32 with a ragged T
FLASH_CASES = [
    (2, 2, 256, 64, 0, 0.0, "float32"),
    (1, 3, 256, 128, 0, 0.0, "float32"),
    (1, 2, 256, 64, 128, 0.0, "float32"),
    (1, 2, 128, 64, 0, 50.0, "float32"),
    (1, 2, 256, 64, 0, 0.0, "bfloat16"),
    (2, 3, 200, 32, 0, 0.0, "float32"),
    (1, 2, 192, 64, 70, 5.0, "bfloat16"),
    (3, 2, 80, 16, 0, 0.0, "float32"),
    (1, 3, 256, 128, 0, 0.0, "bfloat16"),
    (2, 3, 200, 32, 0, 0.0, "bfloat16"),
    # head dims 144 (the LM sweep at lm_d_model 576) and 256 (gemma2-9b,
    # its window and softcap), and 40, zero-padded to 64 in the wrapper
    (1, 2, 256, 144, 0, 0.0, "float32"),
    (1, 2, 200, 144, 0, 0.0, "bfloat16"),
    (1, 2, 200, 256, 0, 0.0, "float32"),
    (1, 2, 512, 256, 128, 50.0, "bfloat16"),
    (2, 2, 128, 40, 0, 0.0, "float32"),
    (2, 2, 128, 40, 0, 0.0, "bfloat16"),
]
# not causal: (b, h, t, d, window, softcap, dtype)
FLASH_CASES_NOT_CAUSAL = [
    (2, 2, 200, 64, 0, 0.0, "bfloat16"),
    (1, 2, 192, 128, 70, 5.0, "bfloat16"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,win,cap,dtype", FLASH_CASES)
def test_flash_kernels_match_plain_version(cuda, b, h, t, d, win, cap,
                                           dtype):
    """Forward and dq/dk/dv of the CUDA kernels vs the plain version and
    its autograd; one forward and two backward launches."""
    _check_flash(cuda, b, h, t, d, win, cap, dtype, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,win,cap,dtype", FLASH_CASES_NOT_CAUSAL)
def test_flash_kernels_match_plain_version_not_causal(cuda, b, h, t, d, win,
                                                      cap, dtype):
    _check_flash(cuda, b, h, t, d, win, cap, dtype, causal=False)


def _check_flash(cuda, b, h, t, d, win, cap, dtype, causal):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device=cuda).to(dt)
                  for _ in range(4))
    counts = [f.launches for f in (tflash.flash_attention_fwd,
                                   tflash.flash_attention_bwd_dq,
                                   tflash.flash_attention_bwd_dkdv)]
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*ts, causal=causal, window=win,
                                 logit_softcap=cap)
    grads = torch.autograd.grad(out, ts, g)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(
        (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
         tflash.flash_attention_bwd_dkdv), counts)] == [1, 1, 1]
    rs = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref = tref.flash_attention_ref(*rs, causal=causal, window=win,
                                   logit_softcap=cap)
    ref_grads = torch.autograd.grad(ref, rs, g.float())
    atol, rtol = (2e-3, 2e-3) if dtype == "float32" else (1e-2, 3e-2)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_masked_agg_launches_past_the_grid_y_limit(cuda):
    """n > 65,535 * BLOCK_N columns at the width the wrapper picks: the
    column blocks must sit on grid axis 0 (CUDA's gridDim.y stops at
    65,535; the LM's n = 134.5M needs more)."""
    block_n = tmasked.block_sizes(3, torch.float32)[1]
    n = 65_535 * block_n + 3 * block_n + 7
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 3, n, generator=gen, device=cuda)
    mask = torch.tensor([[True, False, True]], device=cuda)
    prev = torch.randn(1, n, generator=gen, device=cuda)
    p = torch.rand(1, 3, generator=gen, device=cuda)
    for op in (0, 1, 2):
        ops = torch.full((1,), op, dtype=torch.int32, device=cuda)
        got = tmasked.fused_masked_agg(x, mask, ops, prev, p)
        want = tref.fused_masked_agg_ref(x, mask, ops, prev, p)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("active", ["some", "none"])
def test_masked_agg_at_the_lm_client_count_bf16(cuda, active):
    """m = 8 bf16 clients (one 8-row tile), a ragged n, ops 0/1/2 in one
    launch: within bf16's 2e-2 of the plain version; with no active client
    OP_MEAN returns ``prev`` exactly."""
    n = 2 ** 21 + 5
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 8, n, generator=gen, device=cuda).to(torch.bfloat16)
    mask = torch.rand(3, 8, generator=gen, device=cuda) < 0.5
    mask[:, 0] = True
    if active == "none":
        mask[:] = False
    prev = torch.randn(3, n, generator=gen, device=cuda)
    p = torch.rand(3, 8, generator=gen, device=cuda)
    ops = torch.arange(3, dtype=torch.int32, device=cuda)
    got = tmasked.fused_masked_agg(x, mask, ops, prev, p)
    want = tref.fused_masked_agg_ref(x, mask, ops, prev, p)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    if active == "none":
        assert torch.equal(got[0], prev[0])


@pytest.mark.gpu
def test_lm_loss_through_the_kernel_matches_plain_attention(cuda):
    """The reduced LM (head dim 64) in bf16: the loss and its gradient with
    the flash kernels vs with the plain chunked attention."""
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")),
                              dtype="bfloat16")
    flat = tmodel.init_params(
        torch.Generator(device=cuda).manual_seed(0), cfg)[None, None]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 1, 2, 128)), device=cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, -1)}
    out = {}
    for backend in ("kernel", "torch"):
        loss = tmodel.make_loss(cfg, None if backend == "kernel" else backend)
        before = tflash.flash_attention_fwd.launches
        leaf = flat.clone().requires_grad_(True)
        val = loss(leaf, batch)
        (grad,) = torch.autograd.grad(val.sum(), leaf)
        out[backend] = (val.float(), grad.float())
        launched = tflash.flash_attention_fwd.launches - before
        assert launched == (cfg.num_layers if backend == "kernel" else 0)
    (lk, gk), (lp, gp) = out["kernel"], out["torch"]
    torch.testing.assert_close(lk, lp, rtol=1e-2, atol=1e-2)
    scale = gp.abs().max()
    assert torch.isfinite(gk).all()
    assert (gk - gp).abs().max() <= 5e-2 * scale


# (b, h, t, d, decay, atol = rtol): the shapes of
# tests/test_kernels.py::test_rwkv6_chunk_sweep, strong decay, ragged T,
# T = 1, the serving shapes: prefill [4, 40, 4096, 64] and one decode step
# [8, 40, 1, 64], then T = 2, 63 and 65 and strong decay over 8 chunks
WKV_CASES = [
    (1, 1, 64, 64, "ref", 1e-4),
    (2, 2, 128, 64, "ref", 1e-4),
    (1, 2, 256, 128, "ref", 1e-4),
    (1, 1, 192, 64, "ref", 1e-4),
    (2, 3, 256, 64, "strong", 1e-4),
    (3, 2, 100, 64, "ref", 1e-4),
    (2, 4, 1, 128, "ref", 1e-4),
    (4, 40, 4096, 64, "ref", 1e-3),
    (8, 40, 1, 64, "ref", 1e-4),
    (2, 2, 2, 64, "ref", 1e-4),
    (1, 2, 63, 64, "ref", 1e-4),
    (2, 1, 65, 64, "strong", 1e-4),
    (1, 2, 512, 64, "strong", 1e-4),
]
# each route forced, around its threshold and the chunk length, at strong
# decay over 8 chunks and at D = 128: (b, h, t, d, decay, atol = rtol)
WKV_ROUTE_CASES = [
    (3, 2, 1, 64, "ref", 1e-4),
    (2, 2, 2, 64, "ref", 1e-4),
    (2, 2, 8, 64, "ref", 1e-4),
    (2, 2, 9, 64, "ref", 1e-4),
    (1, 2, 63, 64, "ref", 1e-4),
    (1, 2, 64, 64, "strong", 1e-4),
    (2, 1, 65, 64, "strong", 1e-4),
    (1, 2, 512, 64, "strong", 1e-4),
    (2, 3, 1, 128, "ref", 1e-4),
    (1, 2, 200, 128, "ref", 1e-4),
]


def _wkv_inputs(b, h, t, d, decay, device):
    gen = torch.Generator(device=device).manual_seed(b * t + d)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r, k, v = (0.5 * rand(b, h, t, d) for _ in range(3))
    if decay == "ref":
        w = torch.exp(-torch.exp(-3.0 + 0.5 * rand(b, h, t, d)))
    else:
        w = 1e-3 + (0.1 - 1e-3) * torch.rand(b, h, t, d, generator=gen,
                                               device=device)
    return r, k, v, w, 0.3 * rand(h, d), 0.1 * rand(b, h, d, d)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,decay,tol", WKV_CASES)
def test_wkv6_kernel_matches_plain_version(cuda, b, h, t, d, decay, tol):
    """One launch of the route T picks; finite, and within tolerance of the
    plain chunked version (and of the step scan where it is short enough
    to run)."""
    _check_wkv(cuda, b, h, t, d, decay, tol, None)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["chunked", "step"])
@pytest.mark.parametrize("b,h,t,d,decay,tol", WKV_ROUTE_CASES)
def test_wkv6_each_route_matches_plain_version(cuda, b, h, t, d, decay, tol,
                                               route):
    """The same with the route forced: every T works on both."""
    _check_wkv(cuda, b, h, t, d, decay, tol, route)


def _check_wkv(cuda, b, h, t, d, decay, tol, route):
    ins = _wkv_inputs(b, h, t, d, decay, cuda)
    want_route = route or trwkv.route_for(t)
    before = trwkv.rwkv6_chunk.launches
    by_route = dict(trwkv.rwkv6_chunk.launches_by_route)
    o, s = trwkv.rwkv6_chunk(*ins, route=route)
    torch.cuda.synchronize()
    assert trwkv.rwkv6_chunk.launches - before == 1
    assert {k: n - by_route[k] for k, n in
            trwkv.rwkv6_chunk.launches_by_route.items()} == {
        k: int(k == want_route) for k in trwkv.ROUTES}
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    wants = [tref.rwkv6_chunk_plain(*ins)]
    if t <= 512:
        wants.append(tref.rwkv6_chunk_ref(*ins))
    for want_o, want_s in wants:
        torch.testing.assert_close(o, want_o, rtol=tol, atol=tol)
        torch.testing.assert_close(s, want_s, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_rwkv_forward_and_decode_launch_the_kernel_once_per_layer(cuda):
    """The reduced rwkv6-3b on the card: forward and each decode_step make
    one WKV6 launch per layer, the plain path none; their logits agree."""
    cfg = dataclasses.replace(reduced(get_config("rwkv6-3b")),
                              dtype="float32")
    params = tmodel.init_leaves(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 100)), device=cuda)
    before = trwkv.rwkv6_chunk.launches
    chunked = trwkv.rwkv6_chunk.launches_by_route["chunked"]
    logits, _ = tmodel.forward(params, cfg, toks)
    assert trwkv.rwkv6_chunk.launches - before == cfg.num_layers
    assert trwkv.rwkv6_chunk.launches_by_route["chunked"] - chunked == \
        cfg.num_layers
    before = trwkv.rwkv6_chunk.launches
    plain, _ = tmodel.forward(params, cfg, toks, backend="torch")
    assert trwkv.rwkv6_chunk.launches == before
    torch.testing.assert_close(logits, plain, rtol=1e-4, atol=1e-4)
    cache = tmodel.make_cache(cfg, 2, 3, device=cuda)
    for t in range(3):
        before = trwkv.rwkv6_chunk.launches
        steps = trwkv.rwkv6_chunk.launches_by_route["step"]
        step, cache = tmodel.decode_step(params, cfg, toks[:, t:t + 1],
                                         cache, t)
        assert trwkv.rwkv6_chunk.launches - before == cfg.num_layers
        assert trwkv.rwkv6_chunk.launches_by_route["step"] - steps == \
            cfg.num_layers
        torch.testing.assert_close(step[:, 0], logits[:, t], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
def test_run_sweep_with_a_store_on_the_card(cuda, tmp_path):
    """All seven algorithms (the quartet batch through the fused kernel,
    fedau / f3ast / mifa on their branch path) at m = 8, 6 rounds, 2 seeds,
    into a results store: 7 rows with finite arrays, and the kernel launched
    once a round for the quartet batch only."""
    from repro_torch.experiments import grid as tgrid
    from repro_torch.experiments import results as tres

    algos = ("fedpbc", "fedavg", "fedavg_all", "fedau", "f3ast",
             "fedavg_known_p", "mifa")
    spec = tgrid.SweepSpec(algorithms=algos, schemes=("bernoulli_tv",),
                           seeds=(0, 1), rounds=6, eval_every=3,
                           num_clients=8, use_kernel=True)
    store = tres.ResultsStore(str(tmp_path / "store"))
    tmasked.fused_masked_agg.launches = 0
    cells = tgrid.run_sweep(spec, store=store, suite="gpu")
    assert tmasked.fused_masked_agg.launches == 6
    rows = store.records(suite="gpu")
    assert [r["algo"] for r in rows] == [c.algo for c in cells] == list(algos)
    for rec, cell in zip(rows, cells):
        arrays = store.load_arrays(rec)
        assert set(arrays) == {"test_acc", "train_acc", "loss", "num_active"}
        assert all(np.isfinite(a).all() for a in arrays.values())
        assert np.isfinite(cell.server).all()


@pytest.mark.gpu
def test_cohort_round_at_fifty_thousand_clients_on_the_card(cuda):
    """The cross-device cohort engine at m = 50,000, C = 256 (fedpbc over
    bernoulli_ti, a sync and a buffered arm as one batch of 4, the MLP
    32 / 32 / 10, 3 rounds) with ``use_kernel=True``: the state holds no
    ``[B, m, n]`` tensor, every parameter is finite, and the aggregation
    kernel never launches (the scale round aggregates by the buffer fold,
    as the reference's does)."""
    from repro_torch.experiments import grid as tgrid
    from repro_torch.scale import BUFFER_METRIC_KEYS, Strategy

    m, C = 50_000, 256
    spec = tgrid.SweepSpec(
        algorithms=("fedpbc",), schemes=("bernoulli_ti",), seeds=(0, 1),
        rounds=3, eval_every=3, num_clients=m, cohort_size=C,
        strategies=(Strategy("sync_cohort"),
                    Strategy("buffered", buffer_size=128,
                             deadline_rounds=4)),
        local_steps=2, batch_size=16, dim=32, hidden=32, n_per_class=200,
        n_train=1600, per_client=32, use_kernel=True)
    tmasked.fused_masked_agg.launches = 0
    _, states, out = tgrid.run_batch_states(
        spec, ("fedpbc",), "bernoulli_ti",
        metric_keys=("loss", "num_active") + BUFFER_METRIC_KEYS)
    assert tmasked.fused_masked_agg.launches == 0
    B, n = states.server.shape
    assert (B, n) == (4, 1386)
    tensors = [states.server, states.clients, states.last_active,
               *dataclasses.asdict(states.algo_state).values(),
               *dataclasses.asdict(states.buffer).values(),
               *states.opt_state.values()]
    assert states.clients.shape == (B, 0, n) and states.opt_state == {}
    assert all(t.numel() < B * m * n for t in tensors)
    assert torch.isfinite(states.server).all()
    assert int(out["metrics"]["num_active"].max()) <= C
    assert torch.isfinite(out["evals"]).all()


@pytest.mark.gpu
def test_segment_resume_is_bitwise_on_the_card(cuda):
    """The adaptive search's runner on the card with the fused aggregation:
    two chained 4-round segments equal one uninterrupted 8-round run bit
    for bit (evals, losses, every final-state tensor), and a re-packed
    subset with a duplicate continues each row exactly as unsliced."""
    from repro_torch.experiments import grid as tgrid
    from repro_torch.experiments import sweep as tsweep

    spec = tgrid.SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                           seeds=(0, 1), rounds=8, eval_every=4,
                           num_clients=16, lrs=(0.05, 0.1), use_kernel=True)
    task = tgrid.get_traced_task(spec)
    fed = spec.cell_config("fedpbc", "bernoulli_tv")
    batch = tgrid.make_cell_batch(spec, fed, task)
    rseg = tgrid.segment_runner_for(spec, "fedpbc", "bernoulli_tv",
                                    segment_rounds=4)
    tmasked.fused_masked_agg.launches = 0
    carry = rseg.init(batch)
    evals, losses = [], []
    for _ in range(2):
        carry, out = rseg.step(carry, batch)
        evals.append(out["evals"])
        losses.append(out["metrics"]["loss"])
    assert tmasked.fused_masked_agg.launches == 8
    st_full, out_full = tgrid.make_runner(spec, fed, task)(batch)
    assert torch.equal(torch.cat(evals, 1), out_full["evals"])
    assert torch.equal(torch.cat(losses, 1), out_full["metrics"]["loss"])
    st = carry[0]
    for name in ("server", "clients", "last_active"):
        assert torch.equal(getattr(st, name), getattr(st_full, name))
    for k, v in st.opt_state.items():
        assert torch.equal(v, st_full.opt_state[k])
    rows = [2, 3, 0, 1, 2, 3]                 # point 1, point 0, point 1
    half, _ = rseg.step(rseg.init(batch), batch)
    part = dataclasses.replace(
        batch, gen_index=[batch.gen_index[i] for i in rows],
        p_base=batch.p_base[rows],
        hparams={k: v[rows] for k, v in batch.hparams.items()},
        data={"idx": batch.data["idx"][rows]}, algo_id=batch.algo_id[rows])
    (st2, _, _), out2 = rseg.step(tsweep.gather_carry(half, rows), part)
    (st1, _, _), out1 = rseg.step(half, batch)
    assert torch.equal(out2["evals"], out1["evals"][rows])
    assert torch.equal(st2.server, st1.server[rows])


def _lm_spec(**kw):
    from repro_torch.experiments import grid as tgrid

    base = dict(algorithms=("fedpbc", "fedavg", "fedavg_all",
                            "fedavg_known_p"), schemes=("bernoulli_ti",),
                seeds=(0,), rounds=1, eval_every=1, num_clients=4,
                local_steps=2, batch_size=2, per_client=16, task="lm",
                lm_d_model=64, lm_layers=2, lm_seq=32, classes=4,
                lm_n_seqs=256, lm_n_test=64)
    base.update(kw)
    return tgrid.SweepSpec(**base)


@pytest.mark.gpu
def test_lm_sweep_round_through_the_kernels_matches_the_plain_path(cuda):
    """One LM-sweep round of the quartet at ``lm_d_model`` 64 (head dim
    16, T = 32) through the fp32 flash kernels and the fused aggregation,
    against the plain attention and the branch aggregation from the same
    generators: server params within fp32 1e-4 (flash's online softmax in
    tiles, a few products of SGD later); the flash forward launched per
    layer per local step and per eval forward, dq and dkdv per layer per
    local step, the aggregation once; the plain path launches none."""
    from repro_torch.experiments import grid as tgrid
    from repro_torch.experiments import tasks as ttasks

    spec = _lm_spec(use_kernel=True)
    plain_spec = dataclasses.replace(spec, use_kernel=False)
    fed = spec.cell_config("fedpbc", "bernoulli_ti")
    task = tgrid.get_traced_task(spec)
    m = task.meta
    plain_task = ttasks.make_traced_lm_task(
        num_clients=m["num_clients"], d_model=m["d_model"],
        layers=m["layers"], seq_len=m["seq_len"], classes=m["classes"],
        n_seqs=m["n_train"], n_test=m["n_test"],
        per_client=m["per_client"], local_steps=m["local_steps"],
        batch_size=m["batch_size"], device=cuda, backend="torch")
    counters = (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
                tflash.flash_attention_bwd_dkdv, tmasked.fused_masked_agg)
    runs = []
    for sp, tk in ((spec, task), (plain_spec, plain_task)):
        for c in counters:
            c.launches = 0
        batch = tgrid.make_cell_batch(sp, fed, tk, algos=sp.algorithms)
        st, out = tgrid.make_runner(sp, fed, tk)(batch)
        runs.append((st, out, [c.launches for c in counters]))
    (st_k, out_k, n_k), (st_p, out_p, n_p) = runs
    L, s = spec.lm_layers, spec.local_steps
    assert n_k == [L * (s + 1), L * s, L * s, 1]
    assert n_p == [0, 0, 0, 0]
    assert torch.isfinite(out_k["metrics"]["loss"]).all()
    torch.testing.assert_close(st_k.server, st_p.server, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out_k["metrics"]["loss"],
                               out_p["metrics"]["loss"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_lm_sweep_at_d_model_576_runs_through_the_kernels(cuda):
    """``reduced()`` gives the LM task 4 heads: at ``lm_d_model`` 576 (
    SmolLM-135M's width) the head dim is 144. One LM-sweep round through
    the fp32 flash kernels at D = 144 against the plain attention from the
    same generators: server params within fp32 1e-4, as at d_model 64; the
    flash forward launched per layer per local step and per eval forward,
    dq and dkdv per layer per local step."""
    from repro_torch.experiments import grid as tgrid
    from repro_torch.experiments import tasks as ttasks

    spec = _lm_spec(lm_d_model=576, lm_layers=1, lm_seq=32,
                    algorithms=("fedpbc", "fedavg"), use_kernel=False)
    assert 576 // 4 == 144 in tflash.HEAD_DIMS
    fed = spec.cell_config("fedpbc", "bernoulli_ti")
    task = tgrid.get_traced_task(spec)
    m = task.meta
    plain_task = ttasks.make_traced_lm_task(
        num_clients=m["num_clients"], d_model=m["d_model"],
        layers=m["layers"], seq_len=m["seq_len"], classes=m["classes"],
        n_seqs=m["n_train"], n_test=m["n_test"],
        per_client=m["per_client"], local_steps=m["local_steps"],
        batch_size=m["batch_size"], device=cuda, backend="torch")
    counters = (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
                tflash.flash_attention_bwd_dkdv)
    runs = []
    for tk in (task, plain_task):
        for c in counters:
            c.launches = 0
        batch = tgrid.make_cell_batch(spec, fed, tk, algos=spec.algorithms)
        st, out = tgrid.make_runner(spec, fed, tk)(batch)
        runs.append((st, out, [c.launches for c in counters]))
    (st_k, out_k, n_k), (st_p, out_p, n_p) = runs
    L, s = spec.lm_layers, spec.local_steps
    assert n_k == [L * (s + 1), L * s, L * s]
    assert n_p == [0, 0, 0]
    assert torch.isfinite(out_k["metrics"]["loss"]).all()
    torch.testing.assert_close(st_k.server, st_p.server, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "granite-34b"])
def test_full_width_two_layer_forward_through_the_kernel(cuda, arch):
    """deepseek-coder-33b (56 heads, 8 KV heads of 128) and granite-34b
    (48 query heads on one KV head: ``repeat_kv`` at its widest; a
    non-gated MLP) at their published widths, 2 layers, bf16, ``[1, 256]``:
    the forward through ``flash_fwd_tc`` (one launch a layer) against the
    plain attention (none), max |logit diff| / max |logit| within bf16
    2e-2 (``chip_smoke.py`` phase 13's bar at 2 layers)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    params = tmodel.init_leaves(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 256),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    out = {}
    for path, backend in (("kernel", None), ("plain", "torch")):
        tflash.flash_attention_fwd.launches = 0
        with torch.no_grad():
            out[path], _ = tmodel.forward(params, cfg, toks, backend=backend)
        assert tflash.flash_attention_fwd.launches == (
            cfg.num_layers if path == "kernel" else 0)
    assert out["kernel"].shape == (1, 256, cfg.vocab_size)
    assert torch.isfinite(out["kernel"]).all()
    rel = ((out["kernel"] - out["plain"]).abs().max()
           / out["plain"].abs().max()).item()
    assert rel < 2e-2, (arch, rel)


@pytest.mark.gpu
def test_dense_decode_on_the_card_matches_the_cpu_and_launches_no_kernel(
        cuda):
    """SmolLM-135M reduced (fp32, head dim 64) for the patterns full and
    swa (window 64 < T = 96): ``decode_step`` on the card against the same
    steps on the CPU, fp32 1e-4 at every step, with 0 flash launches (the
    reference calls no kernel there); and teacher forcing against the
    flash-kernel ``forward`` (rel < 2e-3, tests/test_decode_consistency.py's
    bar)."""
    T = 96
    for pattern in ("full", "swa"):
        cfg = dataclasses.replace(reduced(get_config("smollm-135m")),
                                  dtype="float32")
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, pattern=pattern))
        leaves = tmodel.init_leaves(torch.Generator().manual_seed(0), cfg)
        on_card = {k: v.to(cuda) for k, v in leaves.items()}
        toks = torch.randint(0, cfg.vocab_size, (1, T),
                             generator=torch.Generator().manual_seed(1))
        caches = [tmodel.make_cache(cfg, 1, T),
                  tmodel.make_cache(cfg, 1, T, device=cuda)]
        tflash.flash_attention_fwd.launches = 0
        outs = []
        for t in range(T):
            lc, caches[0] = tmodel.decode_step(leaves, cfg, toks[:, t:t + 1],
                                               caches[0], t)
            lg, caches[1] = tmodel.decode_step(
                on_card, cfg, toks[:, t:t + 1].to(cuda), caches[1], t)
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
            outs.append(lg[:, 0])
        assert tflash.flash_attention_fwd.launches == 0
        with torch.no_grad():
            ref, _ = tmodel.forward(on_card, cfg, toks.to(cuda))
        assert tflash.flash_attention_fwd.launches == cfg.num_layers
        dec = torch.stack(outs, 1)
        rel = float((dec - ref).abs().max() / ref.abs().max())
        assert rel < 2e-3, (pattern, rel)
