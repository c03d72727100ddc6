"""Sequence-parallel attention in one process, without a pool: the
decomposition that ``repro_torch.sharding.pool.SequenceAxis`` and
``models.model._self_attn_block`` compute, checked piece by piece.

Rank ``j`` of ``k`` holds queries ``[j T / k, (j + 1) T / k)`` and the
all-gathered prefix of keys ``[0, (j + 1) T / k)``, and attends at
``q_offset = j T / k``. Its chunk's output is the whole sequence's rows,
against the reference's ``repro.models.attention.attention_ref`` on the
whole sequence through ``jax`` on the same numpy inputs, within 1e-6.
The backward of ``gather_prefix`` is an all-reduce of each rank's prefix
gradient, zero-padded to the whole sequence, and a slice to the rank's
chunk: summed over the chunks, the prefix gradients of K and V and the
chunks' gradients of Q equal the autograd of the whole attention within
1e-6. The collective itself runs in the pool tests
(``tests/test_torch_shard_2d.py``). Also: the flash wrapper's plain
version and ``dispatch.attention`` at an offset, the dispatch rule,
``roofline.attention_pairs`` / ``flash_work`` at an offset against a
brute-force count, and which families a sequence axis takes: the MoE,
RWKV6 and hybrid forwards on two simulated ranks (``tests/_seq_ranks.py``)
against one device, the vlm and audio ones refused (the families' own
checks are ``tests/test_torch_seq_parallel_families.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.launch.roofline import attention_pairs, flash_work  # noqa: E402
from repro_torch.models.attention import attention_ref  # noqa: E402

TOL = 1e-6
# a whole forward's final normed hidden states (~1 in magnitude): the
# carried recurrent states and the whole-row MoE sums reassociated through
# two layers (the sharded runs' SEQ_TOL)
FAMILY_TOL = 1e-5
# (ranks, kind, window, softcap, heads, kv heads): the LM sweep's split (2
# ranks, full), 4 ranks with a window shorter and longer than a chunk, a
# softcap, GQA
CASES = [(2, "full", 0, 0.0, 4, 4), (4, "swa", 5, 0.0, 2, 1),
         (4, "swa", 20, 30.0, 4, 2), (2, "full", 0, 5.0, 2, 1)]
B, T, D = 2, 32, 16


def _inputs(seed, h, kvh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, h, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, kvh, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, T, h, D)).astype(np.float32)
    return q, k, v, do


def _chunks(x, ranks):
    t = x.shape[1] // ranks
    return [x[:, j * t:(j + 1) * t] for j in range(ranks)]


@pytest.mark.parametrize("ranks,kind,window,cap,h,kvh", CASES)
def test_rank_chunks_reassemble_the_reference_attention(ranks, kind, window,
                                                        cap, h, kvh):
    """Each rank's chunk at its offset against the key prefix, through the
    port's ``attention_ref``; the chunks joined equal the reference's
    attention on the whole sequence within ``TOL``."""
    q, k, v, _ = _inputs(ranks + window, h, kvh)
    t = T // ranks
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    outs = [attention_ref(qc, kt[:, :(j + 1) * t], vt[:, :(j + 1) * t],
                          kind=kind, window=window, logit_softcap=cap,
                          chunk=8, q_offset=j * t)
            for j, qc in enumerate(_chunks(qt, ranks))]
    want = jattn.attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kind=kind, window=window,
                               logit_softcap=cap, chunk=8)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ranks,kind,window,cap,h,kvh", CASES)
def test_gather_prefix_backward_sums_the_chunks_gradients(ranks, kind,
                                                          window, cap, h,
                                                          kvh):
    """The gradients of q, k and v through the chunked decomposition: each
    chunk's gradient of its q, and of K and V the prefix gradients of
    every chunk zero-padded and summed (``gather_prefix``'s all-reduce),
    then cut into the ranks' chunks and joined; against the autograd of
    the whole attention within ``TOL``."""
    q, k, v, do = _inputs(10 * ranks + window, h, kvh)
    t = T // ranks
    whole = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        attention_ref(*whole, kind=kind, window=window, logit_softcap=cap,
                      chunk=8), whole, torch.as_tensor(do))
    dq_parts = []
    dk_sum, dv_sum = torch.zeros(B, T, kvh, D), torch.zeros(B, T, kvh, D)
    for j in range(ranks):
        qc = torch.as_tensor(q[:, j * t:(j + 1) * t]).requires_grad_(True)
        kp, vp = (torch.as_tensor(x[:, :(j + 1) * t]).requires_grad_(True)
                  for x in (k, v))
        out = attention_ref(qc, kp, vp, kind=kind, window=window,
                            logit_softcap=cap, chunk=8, q_offset=j * t)
        gq, gk, gv = torch.autograd.grad(
            out, (qc, kp, vp), torch.as_tensor(do[:, j * t:(j + 1) * t]))
        dq_parts.append(gq)
        dk_sum[:, :(j + 1) * t] += gk
        dv_sum[:, :(j + 1) * t] += gv
    # each rank keeps its chunk of the all-reduced sums
    got = (torch.cat(dq_parts, 1),
           torch.cat(_chunks(dk_sum, ranks), 1),
           torch.cat(_chunks(dv_sum, ranks), 1))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_flash_wrapper_and_dispatch_take_the_offset_on_the_cpu():
    """On CPU tensors ``flash_attention(..., q_offset=...)`` is the plain
    ``flash_attention_ref`` at the offset, and both agree with
    ``attention_ref`` (through ``dispatch.attention``) on a rank-1 chunk;
    the plain version counts its calls."""
    q, k, v, _ = _inputs(3, 2, 2)
    t = T // 2
    qc = torch.as_tensor(q[:, t:])
    kt, vt = torch.as_tensor(k), torch.as_tensor(v)
    before = dispatch.plain_attention_calls
    want = dispatch.attention(qc, kt, vt, kind="swa", window=9,
                              logit_softcap=5.0, q_offset=t)
    assert dispatch.plain_attention_calls == before + 1
    got = tflash.flash_attention(
        qc.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
        window=9, logit_softcap=5.0, q_offset=t).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind,tq,tk,q_offset,ok", [
    ("full", 16, 32, 16, True),          # lm-family's rank 1
    ("full", 128, 256, 128, True),       # lm-wide's rank 1
    ("swa", 64, 256, 192, True),
    ("full", 256, 256, 0, True),         # self-attention, as before
    ("full", 16, 16, 16, False),         # fewer keys than the offset needs
    ("chunked", 16, 32, 16, False),
    ("full", 136, 272, 136, False),      # T not a multiple of 128
    ("full", 16, 48, 16, False),         # keys past the chunk's end
])
def test_flash_shape_rule_takes_the_offset_route(kind, tq, tk, q_offset, ok):
    """``dispatch.flash_shape_ok`` takes ``tk == q_offset + tq`` under the
    divisibility rule for both lengths, and nothing else new."""
    assert dispatch.flash_shape_ok(kind, tq, tk, q_offset) is ok


@pytest.mark.parametrize("t,window,q_offset", [
    (128, 0, 128), (16, 0, 16), (48, 40, 80), (7, 3, 5), (64, 0, 192),
    (10, 4, 0)])
def test_offset_pairs_and_work_count_the_allowed_pairs(t, window, q_offset):
    """``attention_pairs`` at an offset is the brute-force count of the
    allowed (query, key) pairs; ``flash_work`` counts them and moves q-sized
    and k-sized operands once each (at lm-wide's rank-1 shape, 24,640 pairs
    a head)."""
    qp = q_offset + torch.arange(t)
    kp = torch.arange(q_offset + t)
    allow = qp[:, None] >= kp[None, :]
    if window:
        allow &= qp[:, None] - kp[None, :] < window
    assert attention_pairs(t, window, q_offset) == int(allow.sum())
    bh, d, isz = 3, 16, 4
    work = flash_work(bh, t, d, window, isz, q_offset)
    pairs, tk = bh * int(allow.sum()), q_offset + t
    qm, km, row = bh * t * d * isz, bh * tk * d * isz, bh * t * 4
    assert work == {"fwd": (4 * pairs * d, 2 * qm + 2 * km + row),
                    "dq": (6 * pairs * d, 4 * qm + 2 * km + 2 * row),
                    "dkdv": (8 * pairs * d, 2 * qm + 4 * km + 2 * row)}
    assert attention_pairs(128, 0, 128) == 24_640
    assert flash_work(bh, t, d, window, isz) == flash_work(bh, t, d, window,
                                                           isz, 0)


class _Axis:
    """A stand-in sequence axis: rank ``index`` of ``size``."""

    splits_sequence = True

    def __init__(self, index, size):
        self.index, self.size = index, size

    def offset(self, t):
        return self.index * t


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "rwkv6-3b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_families_outside_the_dense_stack_refuse_a_sequence_axis(arch):
    """Under an active sequence axis the audio and vlm families raise
    before any work, saying why (the LM sweep gives their cross layers no
    memory); the MoE, RWKV6 and hybrid families run with their exchanges
    between the ranks (``tests/_seq_ranks.py``: two simulated ranks), and
    the ranks' hidden states joined equal one device's within
    ``FAMILY_TOL``."""
    import dataclasses

    from _seq_ranks import run_ranks
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as tmodel
    from repro_torch.sharding.specs import sequence_axis, sequence_parallel

    cfg = dataclasses.replace(reduced(get_config(arch), d_model=32),
                              dtype="float32")
    if cfg.family in ("vlm", "audio"):
        tokens = torch.zeros(1, 4, dtype=torch.long)
        with sequence_parallel(_Axis(1, 2)):
            with pytest.raises(ValueError, match="no memory|memory that"):
                tmodel.hidden_forward({}, cfg, tokens)
        assert sequence_axis() is None
        return
    params = tmodel.init_leaves(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, T),
                           generator=torch.Generator().manual_seed(1))
    want, _ = tmodel.hidden_forward(params, cfg, tokens)
    got = run_ranks(2, lambda a: tmodel.hidden_forward(
        params, cfg, a.take_seq(tokens))[0])
    torch.testing.assert_close(torch.cat(got, 1), want, rtol=FAMILY_TOL,
                               atol=FAMILY_TOL)
    assert sequence_axis() is None
