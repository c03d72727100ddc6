"""The port's launch layer on the CPU: the roofline (``launch/roofline.py``)
against the reference's contracts at the H100's constants, the ops wrappers
(``kernels/ops.py``) against the reference's wrappers in Pallas interpret
mode on the same numpy inputs, the training launcher's checkpoints
(``launch/train.py --ckpt-dir``), and the dry run on the meta device
(``launch/steps.py``, ``launch/dryrun.py``).

Tolerances, each with its reason:
- ``masked_agg_pytree``: rtol 1e-5 / atol 1e-6, the reference's (fp32 sums
  over 6 clients in another order); a round with no client active returns
  ``prev`` exactly;
- ``gqa_flash_attention``: rtol = atol = 3e-3, the reference's (its Pallas
  kernel's online softmax in tiles against the port's full softmax);
- a resumed launcher run: bit for bit (the same operations on restored
  bits and generator states);
- counted FLOPs: exact (matmul shapes only).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    INPUT_SHAPES,
    ShapeConfig,
    get_config,
    reduced,
)
from repro_torch.core import masked_mean  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    Roofline,
    attention_pairs,
    flash_work,
    model_flops_for,
    peak_rates,
)
from repro_torch.models.attention import attention_ref  # noqa: E402
from repro_torch.models.model import param_layout  # noqa: E402


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def test_roofline_terms_and_bottleneck():
    rf = Roofline(flops=PEAK_FLOPS, hbm_bytes=HBM_BW / 2,
                  coll_bytes=LINK_BW * 3, chips=4, model_flops=2 * PEAK_FLOPS)
    np.testing.assert_allclose(rf.t_compute, 1.0)
    np.testing.assert_allclose(rf.t_memory, 0.5)
    np.testing.assert_allclose(rf.t_collective, 3.0)
    assert rf.bottleneck == "collective"
    np.testing.assert_allclose(rf.useful_fraction, 0.5)
    assert Roofline(1.0, 0.0, 0.0, 1).bottleneck == "compute"
    assert set(rf.row()) == {"t_compute_s", "t_memory_s", "t_collective_s",
                             "bottleneck", "hlo_flops", "hlo_bytes",
                             "coll_bytes", "model_flops", "useful_fraction"}


def test_model_flops_modes():
    cfg = get_config("mixtral-8x22b")
    n = cfg.active_param_count()
    tr = model_flops_for(cfg, INPUT_SHAPES["train_4k"], mode="train")
    pf = model_flops_for(cfg, INPUT_SHAPES["prefill_32k"], mode="prefill")
    dc = model_flops_for(cfg, INPUT_SHAPES["decode_32k"], mode="decode")
    assert tr == 6.0 * n * 256 * 4096
    assert pf == 2.0 * n * 32 * 32768
    assert dc == 2.0 * n * 128          # one token per sequence
    # MoE: active << total
    assert cfg.active_param_count() < 0.35 * cfg.param_count()
    jcfg = jget_config("mixtral-8x22b")
    for name, mode, got in (("train_4k", "train", tr),
                            ("prefill_32k", "prefill", pf),
                            ("decode_32k", "decode", dc)):
        assert got == jroof.model_flops_for(jcfg, JSHAPES[name], mode=mode)


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 67e12, 989e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 51e12, 756e12)),
    ("NVIDIA H100 NVL", (3.9e12, 60e12, 835e12)),
])
def test_peak_rates_by_card_name(name, want):
    assert peak_rates(name) == want


@pytest.mark.parametrize("t, window", [(1, 0), (64, 0), (64, 16),
                                       (100, 7), (64, 64), (64, 4096)])
def test_flash_work_counts_the_allowed_pairs(t, window):
    """The flash kernels' work covers the (query, key) pairs that the
    causal mask and the window allow, counted from the mask itself."""
    q, k = np.arange(t)[:, None], np.arange(t)[None, :]
    allow = (q >= k) & ((q - k < window) if window else True)
    assert attention_pairs(t, window) == int(allow.sum())
    bh, d = 6, 32
    work = flash_work(bh, t, d, window, 2)
    pairs = bh * int(allow.sum())
    assert [f for f, _ in work.values()] == [4 * pairs * d, 6 * pairs * d,
                                             8 * pairs * d]
    mat, row = bh * t * d * 2, bh * t * 4
    assert work["fwd"][1] == 4 * mat + row          # q, k, v -> o, lse


# ---------------------------------------------------------------------------
# the ops wrappers
# ---------------------------------------------------------------------------


def test_masked_agg_pytree_matches_engine():
    rng = np.random.default_rng(7)
    clients = {"a": rng.normal(size=(6, 10, 3)).astype(np.float32),
               "b": rng.normal(size=(6, 5)).astype(np.float32)}
    mask = np.asarray([1, 1, 0, 1, 0, 0], np.float32)
    got = ops.masked_agg_pytree({k: torch.from_numpy(v)
                                 for k, v in clients.items()},
                                torch.from_numpy(mask))
    want = jops.masked_agg_pytree({k: jnp.asarray(v)
                                   for k, v in clients.items()},
                                  jnp.asarray(mask), interpret=True)
    for k in clients:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        flat = torch.from_numpy(clients[k]).reshape(1, 6, -1)
        np.testing.assert_allclose(
            got[k].numpy(),
            masked_mean(flat, torch.from_numpy(mask)[None]).reshape(
                got[k].shape).numpy(), rtol=1e-5, atol=1e-6)


def test_masked_agg_pytree_zero_active_returns_prev():
    """The pytree half of the zero-active-round contract: with ``prev`` an
    empty active set returns ``prev`` bit for bit (nested dicts, a bf16
    leaf), as the reference's wrapper does; with clients active it agrees
    with the reference."""
    rng = np.random.default_rng(5)
    m, n = 6, 300
    x = rng.normal(size=(m, n)).astype(np.float32)
    prev = rng.normal(size=(n,)).astype(np.float32)
    tree_x = {"w": x.reshape(m, 30, 10), "b": {"c": x[:, :4]}}
    tree_prev = {"w": prev.reshape(30, 10), "b": {"c": prev[:4]}}

    def port(tree):
        return {k: port(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in tree.items()}

    empty = np.zeros(m, bool)
    got = ops.masked_agg_pytree(port(tree_x), torch.from_numpy(empty),
                                port(tree_prev))
    want = jops.masked_agg_pytree(tree_x, jnp.asarray(empty), tree_prev,
                                  interpret=True)
    np.testing.assert_array_equal(got["w"].numpy(), tree_prev["w"])
    np.testing.assert_array_equal(got["b"]["c"].numpy(), tree_prev["b"]["c"])
    np.testing.assert_array_equal(np.asarray(want["w"]), tree_prev["w"])
    bf = torch.from_numpy(prev[:8]).to(torch.bfloat16)
    out = ops.masked_agg_pytree(
        {"h": torch.from_numpy(x[:, :8]).to(torch.bfloat16)},
        torch.from_numpy(empty), {"h": bf})["h"]
    assert out.dtype == torch.bfloat16 and torch.equal(out, bf)
    some = np.arange(m) < 2
    got = ops.masked_agg_pytree(port(tree_x), torch.from_numpy(some),
                                port(tree_prev))
    want = jops.masked_agg_pytree(tree_x, jnp.asarray(some), tree_prev,
                                  interpret=True)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=1e-5,
                               atol=1e-6)


def test_gqa_wrapper():
    rng = np.random.default_rng(3)
    b, t, h, kv, d = 1, 128, 4, 2, 64
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    out = ops.gqa_flash_attention(*map(torch.from_numpy, (q, k, v)))
    want = jops.gqa_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-3,
                               atol=3e-3)
    ref = attention_ref(*map(torch.from_numpy, (q, k, v)), kind="full",
                        chunk=64)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=3e-3,
                               atol=3e-3)


# ---------------------------------------------------------------------------
# the launcher's checkpoints
# ---------------------------------------------------------------------------

_RUN = ["--device", "cpu", "--seq", "16", "--clients", "3", "--layers", "1",
        "--log-every", "2", "--ckpt-every", "2"]


def _leaves(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_train_launcher_resumes_bit_for_bit(tmp_path):
    """``--rounds 2 --ckpt-every 2`` then ``--rounds 4`` from its directory
    equals an uninterrupted 4: the losses of rounds 3-4, the final server,
    clients and optimizer state, and the round-4 checkpoint file (FedState,
    ds_state, the drawer's generator states and counts) leaf for leaf."""
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    a = train.main(_RUN + ["--rounds", "4", "--ckpt-dir", whole])
    b = train.main(_RUN + ["--rounds", "2", "--ckpt-dir", cut])
    assert os.listdir(cut) == ["ckpt_00000002.npz"]
    c = train.main(_RUN + ["--rounds", "4", "--ckpt-dir", cut])
    assert c["losses"] == a["losses"][2:] and b["losses"] == a["losses"][:2]
    assert c["log_rounds"] == [4] and c["state"].round == 4
    for f in ("server", "clients"):
        assert torch.equal(getattr(a["state"], f), getattr(c["state"], f))
    assert a["state"].opt_state.keys() == c["state"].opt_state.keys()
    for key in a["state"].opt_state:
        assert torch.equal(a["state"].opt_state[key],
                           c["state"].opt_state[key])
    la = _leaves(os.path.join(whole, "ckpt_00000004.npz"))
    lc = _leaves(os.path.join(cut, "ckpt_00000004.npz"))
    assert la.keys() == lc.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lc[k])


def test_train_launcher_refuses_a_checkpoint_of_another_layout(tmp_path):
    path = str(tmp_path)
    train.main(_RUN + ["--rounds", "2", "--ckpt-dir", path])
    other = [("4" if a == "3" else a) for a in _RUN]      # --clients 4
    with pytest.raises(SystemExit, match="ckpt_00000002.npz does not match"):
        train.main(other + ["--rounds", "2", "--ckpt-dir", path])


# ---------------------------------------------------------------------------
# the dry run on meta
# ---------------------------------------------------------------------------


def _dense_flops(cfg, b, t):
    """``(weights, attention)``: the matmul FLOPs of a dense forward on
    ``[b, T]`` outside attention (every ``[d_in, d_out]`` weight once per
    token, the tied head), and ``b * H * pairs * D * L`` with the causal
    mask's ``T (T + 1) / 2`` pairs, of which the flash forward takes 4
    (``QK^T``, ``PV``) and its backward 14 (``dq``: 6, ``dkdv``: 8)."""
    weights = sum(int(np.prod(s)) for _, s in param_layout(cfg).leaves
                  if len(s) == 3)
    head = cfg.d_model * cfg.vocab_size
    pairs = t * (t + 1) // 2
    attn = b * cfg.attention.num_heads * pairs * cfg.head_dim * cfg.num_layers
    return 2 * b * t * (weights + head), attn


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_dryrun_flops_match_the_analytic_count(mode):
    """reduced(smollm-135m) on meta: the forward's counted FLOPs equal the
    analytic count, attention counted as the flash kernels' work (no ``T x
    T`` scores); a round of m clients and s local steps counts three
    forwards outside attention (the backward is two) per client and step,
    the head once more (the cross-entropy chunks are recomputed under
    activation checkpointing), and the flash forward and backward of every
    layer, one launch of each kernel a layer and local step (the clients
    share it)."""
    cfg = reduced(get_config("smollm-135m"))
    b, t, m, s = 2, 64, 2, 2
    dense, attn = _dense_flops(cfg, b, t)
    if mode == "prefill":
        got = dryrun.count_step(cfg, ShapeConfig("p", t, b, "prefill"))
        assert got["flops"] == dense + 4 * attn
        want = {"fwd": cfg.num_layers, "dq": 0, "dkdv": 0}
    else:
        got = dryrun.count_step(cfg, ShapeConfig("t", t, m * b, "train"),
                                num_clients=m, local_steps=s)
        head = 2 * b * t * cfg.d_model * cfg.vocab_size
        assert got["flops"] == m * s * (3 * dense + head + 18 * attn)
        want = dict.fromkeys(("fwd", "dq", "dkdv"), s * cfg.num_layers)
    assert got["flash_launches"] == want
    assert got["bytes"] > 0 and got["input_bytes"] > 0


def test_dryrun_rows_print_in_benchmarks_roofline(tmp_path, capsys):
    """An ``ok`` row (reduced smollm at train_4k), a ``FAIL`` row with its
    error (a reduced rwkv6 at head dim 32, which the WKV6 kernels refuse,
    on the card as in the count) and a ``skip`` row (smollm has full
    attention: no long_500k) carry the reference's keys, and
    ``benchmarks/roofline.run`` prints them."""
    from benchmarks import roofline as broof

    ok = dryrun.lower_pair("smollm-135m", "train_4k", verbose=False,
                           cfg=reduced(get_config("smollm-135m")))
    rwkv = reduced(get_config("rwkv6-3b"))
    rwkv = dataclasses.replace(rwkv, rwkv=dataclasses.replace(
        rwkv.rwkv, head_dim=32))
    fail = dryrun.lower_pair("rwkv6-3b", "train_4k", verbose=False,
                             cfg=rwkv)
    skip = dryrun.lower_pair("smollm-135m", "long_500k", verbose=False)
    assert ok["status"] == "ok" and ok["mesh"] == "1xH100"
    assert {"mode", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "useful_fraction", "param_bytes",
            "argument_bytes", "fits_one_card",
            "counted_through"} <= set(ok)
    assert ok["t_collective_s"] == 0.0 and 0 < ok["useful_fraction"] < 1
    assert fail["status"] == "FAIL" and "head dims" in fail["error"]
    assert skip["status"] == "skip"
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps([ok, fail, skip]))
    capsys.readouterr()
    rows = broof.run(path=str(path))
    out = capsys.readouterr().out.splitlines()
    assert len(rows) == 3
    assert out[1].startswith("roofline,smollm-135m,train_4k,1xH100,ok,")
    assert out[2].startswith("roofline,rwkv6-3b,train_4k,1xH100,FAIL")
    assert out[3].startswith("roofline,smollm-135m,long_500k,1xH100,skip")
    assert f"{ok['useful_fraction']:.3f}" in out[1]
