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
