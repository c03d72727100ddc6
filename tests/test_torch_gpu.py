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
errors; bf16 takes the tensor-core kernels, fp32 the 3xTF32 tensor-core
forward and backward);
the aggregation kernel 1e-5
(fp32 sums over 3 terms in another order; bf16 input 2e-2, as
``tests/test_torch_kernels.py``); the LM loss and its gradient
through the kernel vs the plain attention, bf16 5e-2 relative to the
largest gradient (bf16 activations rounded at other places); the WKV6
kernels (both routes: the chunked one's products in 3xTF32) vs the plain
chunked version and the step scan, fp32 atol and rtol 1e-4 (as their
emulated build; the reference's kernel tolerance is 3e-3), at the
serving shapes 1e-3 (64 chunks of a 4096-step sequence, and ``__expf``
on the card); the WKV6 backward kernels vs the autograd of the plain
chunked version, fp32 atol and rtol 1e-3 on each gradient divided by its
largest magnitude, and on dlog w = dw * w as it is, ``chip_smoke.py``
phase 19a's bar (dw = dlog w / w magnifies dlog w's fp32 rounding where w
is small: at strong decay the plain version's own dw lies up to 7.7e-5 of
its largest magnitude from the float64 function, 0.5 relative at a small
element, and the kernel's up to 1.0e-4, while both dlog w lie within
7.3e-6 of its largest); reduced rwkv6 trained through the
WKV6 kernels vs the plain path, fp32 1e-3 as the zoo's.
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
        k: int(k == want_route) for k in trwkv.COUNTED}
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    wants = [tref.rwkv6_chunk_plain(*ins)]
    if t <= 512:
        wants.append(tref.rwkv6_chunk_ref(*ins))
    for want_o, want_s in wants:
        torch.testing.assert_close(o, want_o, rtol=tol, atol=tol)
        torch.testing.assert_close(s, want_s, rtol=tol, atol=tol)


# the WKV6 backward: (b, h, t, d, decay); one chunk, ragged T, strong decay
# over 8 chunks, D = 128, and T = 8, which the forward's step route would
# take outside autograd
WKV_BWD_CASES = [
    (2, 2, 64, 64, "ref"),
    (1, 3, 100, 64, "ref"),
    (2, 2, 130, 64, "strong"),
    (1, 2, 512, 64, "strong"),
    (1, 2, 200, 128, "ref"),
    (2, 2, 8, 64, "ref"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,decay", WKV_BWD_CASES)
def test_wkv6_backward_matches_autograd_of_plain_version(cuda, b, h, t, d,
                                                         decay):
    """``dispatch.wkv6`` under autograd: one chunked forward and one
    backward call (two CUDA launches each), all six gradients finite and
    within 1e-3 (scaled) of the autograd of the plain chunked version, and
    dlog w within 1e-3 as it is, for the output and the final state's
    gradients."""
    from repro_torch.kernels import dispatch

    ins = _wkv_inputs(b, h, t, d, decay, cuda)
    gen = torch.Generator(device=cuda).manual_seed(t)
    do = torch.randn(b, h, t, d, generator=gen, device=cuda)
    ds_t = 0.1 * torch.randn(b, h, d, d, generator=gen, device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    by_route = dict(trwkv.rwkv6_chunk.launches_by_route)
    o, s = dispatch.wkv6(*leaves)
    got = torch.autograd.grad([o, s], leaves, [do, ds_t])
    torch.cuda.synchronize()
    assert {k: n - by_route[k] for k, n in
            trwkv.rwkv6_chunk.launches_by_route.items()} == {
        "chunked": 1, "step": 0, "backward": 1}
    want = tref.rwkv6_chunk_grads(*ins, do, ds_t)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert torch.isfinite(g).all(), name
        scale = x.abs().max()
        torch.testing.assert_close(g / scale, x / scale, rtol=1e-3,
                                   atol=1e-3, msg=lambda m: f"{name}: {m}")
    torch.testing.assert_close(got[3] * ins[3], want[3] * ins[3], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.gpu
def test_rwkv_training_through_the_kernels_matches_the_plain_path(
        cuda, monkeypatch):
    """``launch/train.py --arch rwkv6-3b`` at ``reduced()`` on the card, 2
    clients, 2 local steps, 2 rounds, T = 64: in fp32 the kernel path (one
    chunked WKV6 forward and one backward per layer and local step for
    both clients at once, the fused aggregation) against the plain path
    from the same generators, every client parameter within 1e-3; in bf16
    two groups, the aggregation once per group a round, the fp32 leaves
    fp32."""
    from repro_torch.launch import train

    cfg = dataclasses.replace(reduced(get_config("rwkv6-3b")),
                              dtype="float32")
    args = ["--arch", "rwkv6-3b", "--clients", "2", "--rounds", "2",
            "--seq", "64", "--log-every", "2"]
    outs = {}
    for path, backend, agg in (("kernel", None, "1"), ("plain", "torch", "0")):
        monkeypatch.setenv("REPRO_USE_KERNEL", agg)
        trwkv.reset_counts()
        outs[path] = train.main(args, backend=backend)
        per = 2 * 2 * cfg.num_layers if path == "kernel" else 0
        assert trwkv.rwkv6_chunk.launches_by_route == {
            "chunked": per, "step": 0, "backward": per}
    torch.testing.assert_close(outs["kernel"]["state"].clients,
                               outs["plain"]["state"].clients, rtol=1e-3,
                               atol=1e-3)
    monkeypatch.setenv("REPRO_USE_KERNEL", "1")
    tmasked.fused_masked_agg.launches = 0
    out = train.main(args + ["--dtype", "bfloat16"])
    assert tmasked.fused_masked_agg.launches == 2 * 2
    layout = tmodel.param_layout(cfg)
    assert [x.dtype for x in out["state"].server] == [torch.bfloat16,
                                                      torch.float32]
    views = layout.views(out["state"].clients)
    assert all(views[k].dtype == torch.float32 for k in layout.fp32)
    assert np.isfinite(out["losses"]).all()


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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_memory_families_on_the_card_match_the_cpu(cuda, arch):
    """The hybrid, vlm and audio families reduced (fp32, head dim 64, the
    MoE dropless at capacity factor 8, the vlm's ``cross_gate`` set to 1.0,
    seeded ``0.1 * N(0, 1)`` memory of 16 tokens): ``forward`` on the card
    through the flash kernel (one launch per self-attention layer and per
    encoder layer) against the plain forward on the CPU, and every
    ``decode_step`` on the card (one launch per encoder layer a step, as
    the reference encodes the memory again at every step) against the CPU's,
    fp32 1e-4 (as the dense decode test above); ``backend="torch"`` launches
    nothing, in ``decode_step`` too."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    leaves = tmodel.init_leaves(torch.Generator().manual_seed(0), cfg)
    for k in leaves:
        if k.endswith("cross_gate"):
            leaves[k] = torch.ones_like(leaves[k])
    on_card = {k: v.to(cuda) for k, v in leaves.items()}
    T = 64
    toks = torch.randint(0, cfg.vocab_size, (2, T),
                         generator=torch.Generator().manual_seed(1))
    mem = None
    if cfg.family in ("vlm", "audio"):
        m = (cfg.num_image_tokens if cfg.family == "vlm"
             else cfg.num_audio_frames)
        mem = 0.1 * torch.randn(2, m, cfg.d_model,
                                generator=torch.Generator().manual_seed(2))
    mem_card = None if mem is None else mem.to(cuda)
    enc = cfg.encoder_layers if cfg.family == "audio" else 0
    layers = sum(cfg.layer_kind(i) != "ssm" for i in range(cfg.num_layers))
    with torch.no_grad():
        want, _ = tmodel.forward(leaves, cfg, toks, memory=mem)
        for backend, launches in ((None, layers + enc), ("torch", 0)):
            tflash.flash_attention_fwd.launches = 0
            got, _ = tmodel.forward(on_card, cfg, toks.to(cuda),
                                    memory=mem_card, backend=backend)
            assert tflash.flash_attention_fwd.launches == launches
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-4)
        steps = 8
        for backend, launches in ((None, enc * steps), ("torch", 0)):
            caches = [tmodel.make_cache(cfg, 2, steps),
                      tmodel.make_cache(cfg, 2, steps, device=cuda)]
            tflash.flash_attention_fwd.launches = 0
            for t in range(steps):
                lc, caches[0] = tmodel.decode_step(
                    leaves, cfg, toks[:, t:t + 1], caches[0], t, memory=mem)
                lg, caches[1] = tmodel.decode_step(
                    on_card, cfg, toks[:, t:t + 1].to(cuda), caches[1], t,
                    memory=mem_card, backend=backend)
                torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4,
                                           atol=1e-4)
            assert tflash.flash_attention_fwd.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_zoo_training_on_the_card_matches_the_plain_path(cuda, arch,
                                                         monkeypatch):
    """``launch/train.py`` at ``reduced()`` on the card, 2 clients, 2
    rounds: in fp32 the kernel path (flash forward and backward once per
    attention layer and local step, the fused aggregation) against the
    plain path (``backend="torch"``, the branch aggregation) from the same
    generators, every client parameter within fp32 1e-3 (the flash
    kernels' online softmax, ~1e-6 a step, through 4 local SGD steps, as
    ``chip_smoke.py``'s LM sweep bar); in bf16 two parameter groups, the
    fused aggregation launched once per group a round, the fp32 leaves
    fp32."""
    from repro_torch.launch import train

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    layers = sum(cfg.layer_kind(i) != "ssm" for i in range(cfg.num_layers))
    layers += cfg.encoder_layers if cfg.family == "audio" else 0
    args = ["--arch", arch, "--clients", "2", "--rounds", "2", "--seq", "64",
            "--log-every", "2"]
    outs = {}
    for path, backend, agg in (("kernel", None, "1"), ("plain", "torch", "0")):
        monkeypatch.setenv("REPRO_USE_KERNEL", agg)
        tflash.flash_attention_fwd.launches = 0
        tflash.flash_attention_bwd_dq.launches = 0
        outs[path] = train.main(args, backend=backend)
        want = 2 * 2 * layers if path == "kernel" else 0
        assert tflash.flash_attention_fwd.launches == want
        assert tflash.flash_attention_bwd_dq.launches == want
    torch.testing.assert_close(outs["kernel"]["state"].clients,
                               outs["plain"]["state"].clients, rtol=1e-3,
                               atol=1e-3)
    monkeypatch.setenv("REPRO_USE_KERNEL", "1")
    tmasked.fused_masked_agg.launches = 0
    out = train.main(args + ["--dtype", "bfloat16"])
    assert tmasked.fused_masked_agg.launches == 2 * 2
    layout = tmodel.param_layout(cfg)
    assert [x.dtype for x in out["state"].server] == [torch.bfloat16,
                                                      torch.float32]
    views = layout.views(out["state"].clients)
    assert layout.fp32 and all(views[k].dtype == torch.float32
                               for k in layout.fp32)
    assert all(torch.isfinite(x).all() for x in out["state"].clients)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launcher_resume_through_the_kernels_is_bitwise(cuda, tmp_path,
                                                        monkeypatch, dtype):
    """``launch/train.py`` on the card through the flash kernels and the
    fused aggregation: 2 rounds saved and 2 more resumed from
    ``--ckpt-dir`` equal 4 uninterrupted rounds bit for bit (losses,
    server, clients, optimizer state), and the resumed call launches each
    flash kernel once per layer and local step of its own rounds only."""
    from repro_torch.launch import train

    monkeypatch.setenv("REPRO_USE_KERNEL", "1")
    base = ["--clients", "2", "--seq", "64", "--log-every", "2",
            "--ckpt-every", "2", "--dtype", dtype]
    a = train.main(base + ["--rounds", "4"])
    d = str(tmp_path)
    train.main(base + ["--rounds", "2", "--ckpt-dir", d])
    tflash.flash_attention_fwd.launches = 0
    tmasked.fused_masked_agg.launches = 0
    c = train.main(base + ["--rounds", "4", "--ckpt-dir", d])
    assert tflash.flash_attention_fwd.launches == 2 * 2 * 2
    assert tmasked.fused_masked_agg.launches == 2
    assert c["losses"] == a["losses"][2:]
    for f in ("server", "clients"):
        assert torch.equal(getattr(a["state"], f), getattr(c["state"], f))
    for k in a["state"].opt_state:
        assert torch.equal(a["state"].opt_state[k], c["state"].opt_state[k])


@pytest.mark.gpu
def test_ops_wrappers_on_the_card_match_their_plain_versions(cuda):
    """``kernels/ops.py`` on CUDA tensors launches the kernels and agrees
    with the same wrappers on CPU tensors (the plain versions):
    ``masked_agg_pytree`` within fp32 1e-5, a round with none active
    returning ``prev`` exactly, one launch per leaf; ``gqa_flash_attention``
    within the flash tolerances, one forward launch."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(18)
    m = 8
    tree = {"embed": torch.randn(m, 64, 16, generator=gen),
            "blocks": {"wq": torch.randn(m, 2, 16, 16, generator=gen)}}
    prev = {"embed": torch.randn(64, 16, generator=gen),
            "blocks": {"wq": torch.randn(2, 16, 16, generator=gen)}}

    def to(t):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in t.items()}

    for active in (torch.arange(m) < 3, torch.zeros(m, dtype=torch.bool)):
        tmasked.fused_masked_agg.launches = 0
        got = ops.masked_agg_pytree(to(tree), active.to(cuda), to(prev))
        assert tmasked.fused_masked_agg.launches == 2
        want = ops.masked_agg_pytree(tree, active, prev)
        for g, w in ((got["embed"], want["embed"]),
                     (got["blocks"]["wq"], want["blocks"]["wq"])):
            if active.any():
                torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(g.cpu(), w)
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, None)):
        q = torch.randn(2, 256, 9, 64, generator=gen).to(dtype)
        k = torch.randn(2, 256, 3, 64, generator=gen).to(dtype)
        v = torch.randn(2, 256, 3, 64, generator=gen).to(dtype)
        tflash.flash_attention_fwd.launches = 0
        got = ops.gqa_flash_attention(q.to(cuda), k.to(cuda), v.to(cuda))
        assert tflash.flash_attention_fwd.launches == 1
        want = ops.gqa_flash_attention(q, k, v)
        rtol, atol = (tol, tol) if tol else (3e-2, 1e-2)
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_host_sync_sanitizer_records_one_item_and_no_device_op(cuda):
    """The runtime half of R001/R002 on the card: a deliberate ``.item()``
    is exactly one event, at its line here; a pure device op is none; the
    sync debug mode is restored on exit."""
    from repro_torch.analysis.sanitize import HostSyncSanitizer

    x = torch.arange(8.0, device=cuda)
    before = torch.cuda.get_sync_debug_mode()
    with HostSyncSanitizer() as syncs:
        y = (x * 2 + 1).sum()
    assert syncs.events == []
    with HostSyncSanitizer() as syncs:
        value = y.item()
        line = __import__("inspect").currentframe().f_lineno - 1
    assert value == 64.0
    assert [(e.line, e.in_step) for e in syncs.events] == [(line, False)]
    assert syncs.events[0].file.endswith("test_torch_gpu.py")
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.gpu
def test_rank0_of_a_meshed_prefill_launches_the_counted_flash_shapes(cuda):
    """``chip_smoke.py`` phase 23b's path at a short shape: rank 0 of the
    16x16 prefill of reduced SmolLM-135M on the card under the simulated
    group, the flash forward through the kernel on rank 0's local tensors,
    at the launches and shapes the meshed count predicts, timed by CUDA
    events. The step's values are not compared (the simulated group's
    collectives deliver no other rank's data); the kernel is, at the
    first flash call's local shape and keywords, on unit normals through
    ``dispatch.attention``, against ``attention_ref`` in fp32 within bf16
    flash's bar (atol 1e-2, rtol 3e-2)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.models.attention import attention_ref

    cfg = reduced(get_config("smollm-135m"))
    shape = ShapeConfig("prefill_32k", 1024, 32, "prefill")
    count = dryrun.count_step_meshed(cfg, shape)
    tflash.flash_attention_fwd.launches = 0

    def events(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    run = dryrun.run_rank0(cfg, shape, device=cuda, measure=events)
    assert run["launches"] == count["flash_launches"]["fwd"] > 0
    assert run["flash_shapes"] == sorted(count["flash_shapes"])
    assert tflash.flash_attention_fwd.launches == 2 * run["launches"]
    assert run["out_local_shape"][0] == shape.global_batch // 16
    assert run["input_bytes"] == count["input_bytes"]
    assert run["peak_bytes"] > 0 and run["measured"] > 0
    call = run["attention"]
    assert call["dtype"] == torch.bfloat16
    kw = {n: x for n, x in call["kw"].items() if n != "backend"}
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v = (torch.randn(call["shape"], generator=gen, device=cuda)
               .to(call["dtype"]) for _ in range(3))
    got = dispatch.attention(q, k, v, **kw)
    want = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=3e-2)


# the causal-offset route at chip_smoke.py phase 24c's fp32 shapes, rank 1
# of a 2-rank sequence split: lm-family's ([256, 16 | 32, 16]: B 8 x m 4
# x b 2 x 4 heads, T = 32) and lm-wide's ([256, 128 | 256, 128]: B 4 x m
# 8 x b 2 x 4 heads, T = 256), as (bh, tq, d, q_offset)
FLASH_OFFSET_CASES = [(256, 16, 16, 16), (256, 128, 128, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,d,q_offset", FLASH_OFFSET_CASES)
def test_flash_offset_route_matches_attention_ref(cuda, bh, tq, d, q_offset):
    """The three kernels' causal-offset route (``q [bh, tq, d]`` at
    ``q_offset`` against ``k, v [bh, q_offset + tq, d]``) vs the model
    stack's ``attention_ref(..., q_offset=...)`` and its autograd, fp32
    within the flash bar; each kernel launches once, at an offset."""
    from repro_torch.models.attention import attention_ref

    tk = q_offset + tq
    gen = torch.Generator(device=cuda).manual_seed(tq + q_offset)
    q, g = (torch.randn(1, bh, tq, d, generator=gen, device=cuda)
            for _ in range(2))
    k, v = (torch.randn(1, bh, tk, d, generator=gen, device=cuda)
            for _ in range(2))
    fns = (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
           tflash.flash_attention_bwd_dkdv)
    counts = [(f.launches, f.offset_launches) for f in fns]
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*ts, q_offset=q_offset)
    grads = torch.autograd.grad(out, ts, g)
    torch.cuda.synchronize()
    assert [(f.launches - a, f.offset_launches - b)
            for f, (a, b) in zip(fns, counts)] == [(1, 1)] * 3
    rs = [x.transpose(1, 2).clone().requires_grad_(True) for x in (q, k, v)]
    ref = attention_ref(*rs, q_offset=q_offset)
    ref_grads = torch.autograd.grad(ref, rs, g.transpose(1, 2))
    torch.testing.assert_close(out, ref.transpose(1, 2), rtol=2e-3,
                               atol=2e-3)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want.transpose(1, 2), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.gpu
def test_sequence_parallel_lm_round_matches_one_device(cuda):
    """A 2-rank sequence-parallel lm-family run (two gloo ranks sharing the
    card, ``make_2d_mesh(1, 2)``, ``activation_spec=P(None, "model",
    None)``) against one device: servers within ``LM_PATHS_TOL`` (1e-3, as
    ``chip_smoke.py``), both ranks' servers and outputs bitwise equal, rank
    1's training through the offset route and no plain attention on the
    card."""
    from repro_torch.core.algorithms import algo_family
    from repro_torch.experiments import grid as tgrid
    from repro_torch.experiments import shard as tshard
    from repro_torch.launch.mesh import make_2d_mesh
    from repro_torch.sharding import pool as tpool

    spec = tgrid.SweepSpec(
        algorithms=algo_family("fedavg"), schemes=("bernoulli_ti",),
        seeds=(0,), rounds=2, eval_every=2, num_clients=4, local_steps=2,
        batch_size=2, per_client=8, lrs=(0.1,), task="lm", lm_d_model=64,
        lm_layers=2, lm_seq=32, classes=4, lm_n_seqs=64, lm_n_test=16,
        use_kernel=True)
    card = torch.device("cuda", 0)
    mesh = make_2d_mesh(1, 2, [card, card])
    task = tgrid.get_traced_task(spec, cuda)
    fed = spec.cell_config(spec.algorithms[0], "bernoulli_ti")
    batch = tgrid.make_cell_batch(spec, fed, task, algos=spec.algorithms,
                                  device=cuda)
    want = tgrid.make_runner(spec, fed, task, device=cuda)(batch)
    r2d = tgrid.make_runner(spec, fed, task, device=cuda, shard_mesh=mesh)
    try:
        got = tshard.run_sharded_2d(r2d, batch, mesh,
                                    activation_spec=tshard.SEQUENCE_SPEC)
        res = tshard.last_run()
    finally:
        tpool.close_pools()
    assert float((got[0].server - want[0].server).abs().max()) <= 1e-3
    assert res.backend == "gloo"
    ranks = res.values
    assert all(v["seq_split"] for v in ranks)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert [v["plain_attention"] for v in ranks] == [0, 0]
    steps = spec.rounds * spec.local_steps * spec.lm_layers
    off = ranks[1]["offset_launches"]
    assert [off[n] for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkdv")] == [steps] * 3
    assert not any(ranks[0]["offset_launches"].values())


# the wide-head route: fp32 self-attention above D = 256, (bh, t, d, window,
# softcap); the LM sweep's [256, 32, 288] at lm_d_model 1152, a ragged T at
# D = 512 with a window and softcap
FLASH_WIDE_CASES = [(256, 32, 288, 0, 0.0), (2, 200, 512, 70, 50.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d,win,cap", FLASH_WIDE_CASES)
def test_flash_wide_route_matches_plain_version(cuda, bh, t, d, win, cap):
    """``flash_attention`` at an fp32 head dim above 256 takes the
    wide-head kernels (one launch each, none of the aligned ones) and
    matches ``flash_attention_ref`` and its autograd within the fp32 flash
    bar."""
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    q, k, v, g = (torch.randn(1, bh, t, d, generator=gen, device=cuda)
                  for _ in range(4))
    wide = (tflash.flash_attention_wide_fwd, tflash.flash_attention_wide_bwd_dq,
            tflash.flash_attention_wide_bwd_dkdv)
    aligned = (tflash.flash_attention_fwd, tflash.flash_attention_bwd_dq,
               tflash.flash_attention_bwd_dkdv)
    counts = [f.launches for f in wide + aligned]
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*ts, window=win, logit_softcap=cap)
    grads = torch.autograd.grad(out, ts, g)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(wide + aligned, counts)] == \
        [1, 1, 1, 0, 0, 0]
    rs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tref.flash_attention_ref(*rs, window=win, logit_softcap=cap)
    ref_grads = torch.autograd.grad(ref, rs, g)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=2e-3)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_flash_above_256_refuses_bf16_and_an_offset(cuda):
    """No path reaches bf16 or the causal-offset route above 256: both
    raise before any launch, naming the gap, and never fall back."""
    x = torch.zeros(1, 2, 64, 288, device=cuda)
    before = tflash.flash_attention_wide_fwd.launches
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        tflash.flash_attention(*(x.bfloat16() for _ in range(3)))
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        tflash.flash_attention(x[:, :, 32:], x, x, q_offset=32)
    assert tflash.flash_attention_wide_fwd.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [144, 256])
def test_wkv6_block_route_matches_plain_version(cuda, d):
    """A head dim above 128 through the block route: the forward (one
    call of the kernels over the folded block pairs) and, through
    ``dispatch.wkv6`` under autograd, the backward, from a non-zero ``s0``
    with a non-zero ``dS_T``, within 1e-4 of the plain version (forward)
    and 1e-3 of its autograd scaled by each gradient's largest magnitude
    (the bars above); counted once a direction as blocked."""
    from repro_torch.kernels import dispatch

    ins = _wkv_inputs(2, 2, 100, d, "ref", cuda)
    gen = torch.Generator(device=cuda).manual_seed(d)
    do = torch.randn(2, 2, 100, d, generator=gen, device=cuda)
    ds_t = 0.1 * torch.randn(2, 2, d, d, generator=gen, device=cuda)
    before = dict(trwkv.rwkv6_chunk.blocked_launches)
    o, s = trwkv.rwkv6_chunk(*ins)
    want_o, want_s = tref.rwkv6_chunk_plain(*ins)
    torch.testing.assert_close(o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    got = torch.autograd.grad(dispatch.wkv6(*leaves), leaves, [do, ds_t])
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in
            trwkv.rwkv6_chunk.blocked_launches.items()} == {
        "forward": 2, "backward": 1}
    want = tref.rwkv6_chunk_grads(*ins, do, ds_t)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        scale = x.abs().max()
        torch.testing.assert_close(g / scale, x / scale, rtol=1e-3,
                                   atol=1e-3, msg=lambda m: f"{name}: {m}")
