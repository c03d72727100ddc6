"""The LM sweep at the widths where its head dim passes the kernels' own:
``reduced()`` keeps 4 heads, so ``lm_d_model`` 576 gives rwkv6-3b WKV6
heads of 144 (above the WKV6 kernels' 128) and ``lm_d_model`` 1152 gives
smollm-135m attention heads of 288 (above the flash kernels' 256). On the
card these take the WKV6 block route (``kernels/rwkv6_chunk.py``
``fold_blocks``) and the flash kernels' wide-head route
(``csrc/flash_attention_wide.cu``); their CUDA sources run in
``tests/test_torch_wide_heads_emulated.py`` (flash) and
``tests/test_torch_rwkv_pad_emulated.py`` (WKV6).

Here, on the CPU:
- the block decomposition with the plain version as its per-block
  function against the whole plain version at D = 144, 256 and 320 (128
  and 64 as blocks, D zero-padded where it does not divide), from a
  non-zero ``s0`` with a non-zero ``dS_T``: ``o``, ``S_T`` and all six
  gradients within ``BLOCK_TOL`` = 1e-5 of each output's largest magnitude
  (fp32 sums in another order: ``o`` adds the key blocks' partial sums;
  ``S_T`` is exact, each state element's recurrence is its own);
- the port's LM-task loss and every leaf's gradient at (rwkv6-3b, 576) and
  (smollm-135m, 1152) against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` on the reference's own initial model, moved over with
  ``convert.params_from_jax``: ``LOSS_TOL`` = 1e-5 and ``GRAD_TOL`` = 1e-4
  absolute, the bars of ``tests/test_torch_seq_parallel_families.py`` (the
  same operations in another order); one layer, sequences of 16. The
  models' initial decays are moderate, where the reference's chunk scan is
  finite (ROADMAP Queue 3: it overflows at strong decay);
- both flash routes' autograd ``Function`` runs the wrappers that stand on
  the module at each call (stand-ins on the CPU).
~16 s alone.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.experiments import tasks as jtasks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.experiments import tasks as ttasks  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as trwkv  # noqa: E402
from repro_torch.kernels.ref import rwkv6_chunk_grads, rwkv6_chunk_plain  # noqa: E402

BLOCK_TOL = 1e-5
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
NAMES = ("o", "S_T", "dr", "dk", "dv", "dw", "du", "ds0")
B, T = 2, 16
TASK = dict(num_clients=1, layers=1, seq_len=T, n_seqs=8, n_test=4,
            per_client=8, batch_size=B)


def _wkv_case(b, h, t, d, seed):
    """Inputs at the reference's moderate decay, a non-zero ``s0``, and
    output gradients with a non-zero ``dS_T``."""
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen)
               for _ in range(3))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(b, h, t, d,
                                                      generator=gen)))
    u = 0.3 * torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    do = torch.randn(b, h, t, d, generator=gen)
    ds_t = 0.1 * torch.randn(b, h, d, d, generator=gen)
    return (r, k, v, w, u, s0), do, ds_t


@pytest.mark.parametrize("d,db", [(144, 128), (256, 128), (320, 128),
                                  (256, 64)])
def test_block_route_matches_the_whole_plain_version(monkeypatch, d, db):
    """``fold_blocks`` with ``rwkv6_chunk_plain`` per block against
    ``rwkv6_chunk_plain`` at ``d``, in blocks of ``db`` (set as the
    module's ``BLOCK_DIM``): forward and every gradient (through the
    fold's autograd) within ``BLOCK_TOL``; T = 70, a ragged second
    chunk."""
    monkeypatch.setattr(trwkv, "BLOCK_DIM", db)
    ins, do, ds_t = _wkv_case(1, 2, 70, d, seed=d + db)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    plain = functools.partial(rwkv6_chunk_plain, chunk=trwkv.CHUNK)
    o, s_t = trwkv.fold_blocks(plain, *leaves)
    grads = torch.autograd.grad((o, s_t), leaves, (do, ds_t))
    want = plain(*ins) + tuple(rwkv6_chunk_grads(*ins, do, ds_t))
    for name, got, x in zip(NAMES, (o, s_t) + grads, want):
        assert got.shape == x.shape, name
        scale = max(1.0, x.abs().max().item())
        torch.testing.assert_close(
            got.detach() / scale, x / scale, rtol=BLOCK_TOL, atol=BLOCK_TOL,
            msg=lambda m: f"D = {d} in blocks of {db}: {name} (scaled by "
                          f"{scale:.3g}): {m}")


def test_block_route_head_dims():
    """Above 128 every head dim runs in blocks of ``BLOCK_DIM``; below 1
    raises."""
    for d in (129, 144, 256, 288, 640):
        assert trwkv.padded_head_dim(d) == trwkv.BLOCK_DIM
    with pytest.raises(ValueError, match="at least 1"):
        trwkv.padded_head_dim(0)


@pytest.mark.parametrize("route", ["_ALIGNED", "_WIDE"])
def test_flash_routes_run_the_module_wrappers(monkeypatch, route):
    """Both flash routes' autograd ``Function`` calls the forward, dq and
    dkdv wrappers by their names on the module at each call, so that a
    stand-in there (``chip_smoke.py``'s launch tally by shape) is the one
    run; stand-ins that return zeros here, on the CPU."""
    calls = []

    def stand_in(name, second_like_q):
        def fn(q, *args, **kw):
            calls.append(name)
            second = (torch.zeros_like(q) if second_like_q
                      else torch.zeros(q.shape[:-1]))
            return torch.zeros_like(q), second
        return fn

    names = getattr(tflash, route)
    for name, like_q in zip(names, (False, False, True)):
        monkeypatch.setattr(tflash, name, stand_in(name, like_q))
    q, k, v = (torch.ones(2, 4, 8, requires_grad=True) for _ in range(3))
    tflash._FlashAttention.apply(q, k, v, names, {}).sum().backward()
    assert calls == list(names)


@functools.lru_cache(maxsize=None)
def _lm_case(arch, d_model):
    jt = jtasks.make_traced_lm_task(arch=arch, d_model=d_model, data_seed=0,
                                    **TASK)
    tt = ttasks.make_traced_lm_task(arch=arch, d_model=d_model, data_seed=0,
                                    device="cpu", **TASK)
    toks = np.asarray(jt.shared["toks"])[:B]
    params = jt.init_params(jax.random.PRNGKey(0))
    loss, grad = jax.jit(jax.value_and_grad(jt.loss_fn))(
        params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    flat = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                   tt.layout)
    want = convert.params_from_jax(jax.tree.map(np.asarray, grad),
                                   tt.layout)
    seqs = torch.as_tensor(toks.astype(np.int64))[None, None]
    batch = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:]}
    return tt, flat[None, None], batch, float(loss), want


@pytest.mark.parametrize("arch,d_model,head_dim", [
    ("rwkv6-3b", 576, 144), ("smollm-135m", 1152, 288)])
def test_lm_task_at_a_wide_head_matches_the_reference(arch, d_model,
                                                      head_dim):
    """The port's LM loss and every leaf's gradient at a head dim past the
    kernels' own, against the reference's, within ``LOSS_TOL`` /
    ``GRAD_TOL``; the head dim is the one the card's block or wide-head
    route takes."""
    task, flat, batch, want_loss, want_grad = _lm_case(arch, d_model)
    assert d_model // 4 == head_dim
    if arch == "rwkv6-3b":
        assert head_dim > trwkv.HEAD_DIMS[-1]
    else:
        assert tflash.padded_head_dim(head_dim) == 384
    leaf = flat.clone().requires_grad_(True)
    loss = task.loss_fn(leaf, batch)
    grad, = torch.autograd.grad(loss.sum(), leaf)
    np.testing.assert_allclose(loss.detach().numpy().ravel(), [want_loss],
                               rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(grad[0, 0].numpy(), want_grad.numpy(),
                               rtol=0, atol=GRAD_TOL)
