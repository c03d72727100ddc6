"""The sequence split of the MoE, RWKV6 and hybrid families in the sharded
LM sweep: ``run_sharded_2d(runner, batch, mesh,
activation_spec=P(None, "model", None))`` on a ``make_2d_mesh(1, 2)`` of
two CPU ranks (gloo, one pool for the module, one intra-op thread a
worker), for ``mixtral-8x22b``, ``llama4-maverick-400b-a17b``,
``rwkv6-3b`` and ``jamba-1.5-large-398b``, each against the
single-device runner on the same batch.

A rank holds every client and its half of every sequence; each layer takes
what the other rank carries into its chunk (the K/V prefix, the token
shifts' and the Mamba conv's last rows, the WKV6 and Mamba states, the MoE
rows' expert counts and whole-row sums), and the gradients and losses are
all-reduced. Bars: servers, losses and accuracies within ``SEQ_TOL`` =
1e-5 of one device (fp32 reassociation; the dense split's bar in
``tests/test_torch_shard_2d.py``), the link and algorithm state equal;
both model ranks' servers and outputs bitwise equal (their digests); every
rank's collectives equal to ``roofline.collective_stats`` with the
family's ``sequence_exchanges``; on the CPU no kernel launches, and every
WKV6 call the plain version's.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import shard as tshard  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch.mesh import make_2d_mesh  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    collective_stats,
    sequence_exchanges,
)
from repro_torch.sharding import pool as tpool  # noqa: E402

MESH = make_2d_mesh(1, 2, ["cpu"] * 2)
METRIC_KEYS = ("loss", "num_active")
SEQ_TOL = 1e-5
ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b", "rwkv6-3b",
         "jamba-1.5-large-398b")
# the LM sweep's lower lr: RWKV6's embedding gradient reaches ~26 at this
# width (its first norm divides by the embedding's 0.02 scale), so a
# few-ulp reassociation of it (4e-7 relative) grows through the SGD steps;
# after 2 rounds of 2 steps the largest server difference is 3.5e-6 at lr
# 0.05 and 1.3e-5 at 0.1 (the other archs': below 1.2e-6 at either)
SPEC = tgrid.SweepSpec(algorithms=("fedpbc", "fedavg"),
                       schemes=("bernoulli_ti",), seeds=(0,), rounds=2,
                       eval_every=2, num_clients=4, local_steps=2,
                       batch_size=1, per_client=8, lrs=(0.05,), task="lm",
                       lm_d_model=32, lm_layers=2, lm_seq=16, classes=4,
                       lm_n_seqs=32, lm_n_test=8)

_START = []


@pytest.fixture(scope="module", autouse=True)
def pools():
    """The module's pool, started in the background at the module's start
    (the first single-device run goes meanwhile) and closed at its end."""
    _START.append(threading.Thread(target=tpool.pool_for, args=(MESH,),
                                   kwargs={"threads": 1}))
    _START[0].start()
    yield
    _START[0].join(timeout=tpool.START_TIMEOUT_S)
    tpool.close_pools()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [] if tree is None else [tree]


@functools.lru_cache(maxsize=None)
def _split(arch):
    """One family batch of ``SPEC`` at ``arch`` on one device and split
    over the mesh's two model ranks: ``(want, got, pool result, batch,
    task, spec, the one-device run's plain WKV6 calls)``."""
    spec = dataclasses.replace(SPEC, lm_arch=arch)
    task = tgrid.get_traced_task(spec, "cpu")
    fed = spec.cell_config(spec.algorithms[0], spec.schemes[0])
    batch = tgrid.make_cell_batch(spec, fed, task, algos=spec.algorithms,
                                  device="cpu")
    plain = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                              device="cpu")
    r2d = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                            device="cpu", shard_mesh=MESH)
    dispatch.plain_wkv6_calls = 0
    want = plain(batch)
    wkv = dispatch.plain_wkv6_calls
    _START[0].join(timeout=tpool.START_TIMEOUT_S)
    got = tshard.run_sharded_2d(r2d, batch, MESH,
                                activation_spec=tshard.SEQUENCE_SPEC)
    return want, got, tshard.last_run(), batch, task, spec, wkv


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_matches_one_device(arch):
    """Servers, losses and accuracies within ``SEQ_TOL`` of one device;
    the link and algorithm state and the active counts equal; both ranks
    split their sequences; no kernel launched on the CPU; every WKV6 call
    the plain version's, one more a layer and local step than on one
    device (the chunk's state from zero, then its outputs from the carried
    state; the evals run whole)."""
    want, got, res, batch, _, spec, one_device_wkv = _split(arch)
    (gs, go), (ws, wo) = got, want
    for x, y in zip(_leaves(gs), _leaves(ws)):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=SEQ_TOL)
        elif isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            assert x == y
    np.testing.assert_allclose(go["metrics"]["loss"].numpy(),
                               wo["metrics"]["loss"].numpy(), rtol=0,
                               atol=SEQ_TOL)
    np.testing.assert_allclose(go["evals"].numpy(), wo["evals"].numpy(),
                               rtol=0, atol=SEQ_TOL)
    assert gs.server.shape[0] == batch.batch_size
    assert all(v["seq_split"] for v in res.values)
    steps = spec.rounds * spec.local_steps
    wkv = one_device_wkv + (spec.lm_layers * steps if arch == "rwkv6-3b"
                            else 0)
    assert (one_device_wkv > 0) == (arch == "rwkv6-3b")
    for v in res.values:
        assert not any(v["launches"].values())
        assert v["plain_wkv6"] == wkv


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_model_ranks_are_bitwise_equal(arch):
    """Both model ranks end with the same bits: the digests of their
    servers and outputs agree."""
    digests = [v["digest"] for v in _split(arch)[2].values]
    assert digests[0] == digests[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_collectives_are_counted(arch):
    """Each rank's collectives equal ``collective_stats``'s sequence-split
    count with the family's ``sequence_exchanges``: the attention layers'
    K/V gathers, the carries and the MoE exchanges every local step, the
    gradient all-reduce every step and the losses' every round."""
    _, _, res, batch, task, spec, _ = _split(arch)
    cfg = dataclasses.replace(
        reduced(get_config(arch), d_model=spec.lm_d_model,
                layers=spec.lm_layers), dtype="float32")
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    kv = (spec.batch_size * spec.lm_seq * cfg.attention.num_kv_heads
          * cfg.head_dim * 4)
    want = collective_stats(
        MESH.shape["model"], rows=batch.batch_size,
        clients=spec.num_clients, group_bytes=[4 * task.layout.size],
        rounds=spec.rounds, sequence=(attn, spec.local_steps, kv),
        exchanges=sequence_exchanges(cfg, batch=spec.batch_size,
                                     seq_len=spec.lm_seq,
                                     ranks=MESH.shape["model"]))
    for v in res.values:
        assert v["gathers"]["bytes_by_kind"] == want.bytes_by_kind
        assert v["gathers"]["count_by_kind"] == want.count_by_kind
        assert v["gathers"]["seconds"] > 0
