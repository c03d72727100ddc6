"""The sharded sweep on a 2-D ``("batch", "model")`` mesh: the port of the
four mesh contracts of ``tests/test_lm_sweep.py``, with the port's
collective count and the stateful rules.

A model rank holds ``m / model`` clients of each of its trajectories,
trains them, and all-gathers the local updates over ``"model"`` before the
aggregation, which every model rank computes whole
(``repro_torch.experiments.sweep.make_batched_run_rounds(shard_mesh=...)``).
The reference pins bitwise equality with the single-device sweep on a
``make_2d_mesh(4, 2)`` of 8 forced host devices in one process; the port
runs one worker process per rank, so to keep the cost down it pins the same
on ``make_2d_mesh(2, 2)`` over 4 CPU ranks (gloo, a ``FileStore``
rendezvous, one pool for the module). The reference's "zero extra jit
entries" has no counterpart, since torch does not jit: here each rank
builds one runner for the whole family. ``collective_stats`` counts the
bytes the ranks' gathers move.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.algorithms import algo_family  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import shard as tshard  # noqa: E402
from repro_torch.launch.mesh import make_2d_mesh  # noqa: E402
from repro_torch.launch.roofline import LINK_BW, collective_stats  # noqa: E402
from repro_torch.sharding import pool as tpool  # noqa: E402
from repro_torch.sharding.specs import P  # noqa: E402

FAMILY = algo_family("fedavg")   # fedpbc/fedavg/fedavg_all/fedavg_known_p
METRIC_KEYS = ("loss", "num_active")
MESH = make_2d_mesh(2, 2, ["cpu"] * 4)
CELL_FIELDS = ("test_acc", "train_acc", "loss", "num_active", "server")

LM = tgrid.SweepSpec(algorithms=FAMILY, schemes=("bernoulli_ti",),
                     seeds=(0, 1), rounds=3, eval_every=2, num_clients=4,
                     local_steps=2, batch_size=1, per_client=8,
                     lrs=(0.05, 0.1), task="lm", lm_d_model=32, lm_layers=1,
                     lm_seq=16, classes=4, lm_n_seqs=64, lm_n_test=16)


_START = []


@pytest.fixture(scope="module", autouse=True)
def pools():
    """The module's pool, started in the background when the module starts
    (the single-device runs before its first use run meanwhile; ``_ready``
    waits for it) and closed when it ends. Its workers take one intra-op
    thread each: under ``pytest -n 6`` this module's process shares the
    host with five others."""
    _START.append(threading.Thread(target=tpool.pool_for, args=(MESH,),
                                   kwargs={"threads": 1}))
    _START[0].start()
    yield
    _ready()
    tpool.close_pools()


def _ready():
    _START[0].join(timeout=tpool.START_TIMEOUT_S)
    assert not _START[0].is_alive()


def _cells_equal(a, b):
    assert (a.algo, a.scheme, a.hparams, a.strategy) == \
        (b.algo, b.scheme, b.hparams, b.strategy)
    for f in CELL_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


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
def _family_sweeps():
    """One single-device and one 2-D-mesh run of the LM family sweep, the
    pool's first call, with its pool result (shared by the bitwise, runner
    and collective tests)."""
    plain = tgrid.run_sweep(LM, metric_keys=METRIC_KEYS, mesh=None,
                            device="cpu")
    _ready()
    sharded = tgrid.run_sweep(LM, metric_keys=METRIC_KEYS, mesh=MESH,
                              device="cpu")
    return plain, sharded, tshard.last_run()


def test_lm_family_sweep_2d_bit_for_bit():
    """All 4 family members x 2 lrs x 2 seeds: every row of the 2-D-mesh
    sweep equals the single-device sweep bitwise."""
    plain, sharded, res = _family_sweeps()
    assert len(plain) == len(FAMILY) * len(LM.lrs)
    for a, b in zip(plain, sharded):
        _cells_equal(a, b)
    # 16 trajectories: 8 a batch index, each model rank 2 of the 4 clients
    assert [v["rows"] for v in res.values] == [8] * 4
    assert [v["value"] is not None for v in res.values] == \
        [True, False, True, False]


def test_lm_sweep_2d_one_runner_per_rank():
    """The whole 4-member family sweep on the 2-D path builds exactly one
    runner in each rank: swept lrs, seeds and the algorithm axis all ride
    the same runner (the reference's one compiled (init, scan) pair)."""
    _, _, res = _family_sweeps()
    assert [v["runners_built"] for v in res.values] == [1] * 4
    fed = LM.cell_config(FAMILY[0], "bernoulli_ti")
    runner = tgrid.make_runner(LM, fed, tgrid.get_traced_task(LM, "cpu"),
                               metric_keys=METRIC_KEYS, device="cpu",
                               shard_mesh=MESH)
    assert runner.shard_mesh == MESH
    assert runner.recipe.shard_mesh == MESH


def test_lm_cohort_2d_bit_for_bit():
    """Cohort mode (stateless clients, a C = 2 subsample a round, split 1
    and 1 over the model axis) on the 2-D mesh equals the single-device
    sweep bitwise."""
    spec = dataclasses.replace(LM, algorithms=("fedpbc", "fedavg"),
                               num_clients=8, cohort_size=2, seeds=(0,),
                               lrs=(0.1,))
    plain = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, mesh=None,
                            device="cpu")
    _ready()
    sharded = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, mesh=MESH,
                              device="cpu")
    assert len(plain) == 2
    for a, b in zip(plain, sharded):
        _cells_equal(a, b)


def test_run_sharded_2d_pads_ragged_batch():
    """B = 3 trajectories on a batch axis of 2: padding rows are sliced off
    on the host and the result equals the unsharded runner bitwise."""
    spec = dataclasses.replace(LM, seeds=(0,), lrs=(0.1,))
    task = tgrid.get_traced_task(spec, "cpu")
    fed = spec.cell_config(FAMILY[0], "bernoulli_ti")
    batch = tgrid.make_cell_batch(spec, fed, task, algos=FAMILY[:3],
                                  device="cpu")
    assert batch.batch_size == 3
    r2d = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                            device="cpu", shard_mesh=MESH)
    plain = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                              device="cpu")
    _ready()
    got = tshard.run_sharded_2d(r2d, batch, MESH)
    want = plain(batch)
    for x, y in zip(_leaves(got), _leaves(want)):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            assert x == y
    assert [v["rows"] for v in tshard.last_run().values] == [2] * 4
    # a runner built without the mesh is rejected up front, and one built
    # for it runs only in the mesh's workers
    with pytest.raises(ValueError, match="not built for this mesh"):
        tshard.run_sharded_2d(plain, batch, MESH)
    with pytest.raises(RuntimeError, match="pool workers"):
        r2d(batch)


def test_collective_stats_counts_what_the_ranks_gathered():
    """Each rank's all-gathers in the family sweep (3 rounds: the updates
    of 8 trajectories x 4 clients and their losses each round; then the
    clients and the optimizer's step counter) move exactly the bytes and
    ops ``collective_stats`` counts from the mesh and the shapes."""
    _, _, res = _family_sweeps()
    n = tgrid.get_traced_task(LM, "cpu").layout.size
    want = collective_stats(MESH.shape["model"], rows=8, clients=4,
                            group_bytes=[4 * n], rounds=LM.rounds,
                            final_bytes=[4 * n, 4])
    assert want.count_by_kind == {"all-gather": 2 * LM.rounds + 2}
    for v in res.values:
        assert v["gathers"]["bytes_by_kind"] == want.bytes_by_kind
        assert v["gathers"]["count_by_kind"] == want.count_by_kind
        assert v["gathers"]["seconds"] > 0
    assert want.t_collective == want.total_bytes / LINK_BW
    assert collective_stats(1, rows=8, clients=4, group_bytes=[4 * n],
                            rounds=3).total_bytes == 0


def test_stateful_rules_on_2d_mesh_match_single_device():
    """The reference's 2-D runner takes the stateful rules too: fedau,
    mifa and f3ast (one family each) on the classification task, m = 8
    split 4 and 4, equal the single-device sweep bitwise; their per-client
    state stays whole on every model rank."""
    spec = tgrid.SweepSpec(
        algorithms=("fedau", "mifa", "f3ast"), schemes=("bernoulli_tv",),
        seeds=(0, 1), num_clients=8, dim=16, hidden=16, classes=10,
        n_per_class=60, n_train=480, per_client=24, batch_size=4,
        local_steps=2, rounds=4, eval_every=2, lrs=(0.1,))
    plain = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, mesh=None,
                            device="cpu")
    _ready()
    sharded = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, mesh=MESH,
                              device="cpu")
    assert [c.algo for c in sharded] == list(spec.algorithms)
    for a, b in zip(plain, sharded):
        _cells_equal(a, b)


# -- sequence-parallel activations (activation_spec=P(None, "model", None))

SEQ_TOL = 1e-5     # fp32 reassociation (the reference's own gap: 4.77e-7)


def _seq_parallel(spec, algos):
    """One cell batch of ``spec`` through the single-device runner and
    through ``run_sharded_2d`` with ``SEQUENCE_SPEC`` on the module's mesh:
    ``(want, got, pool result, batch, task)``."""
    task = tgrid.get_traced_task(spec, "cpu")
    fed = spec.cell_config(algos[0], spec.schemes[0])
    batch = tgrid.make_cell_batch(spec, fed, task, algos=algos, device="cpu")
    plain = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                              device="cpu")
    r2d = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                            device="cpu", shard_mesh=MESH)
    want = plain(batch)
    _ready()
    got = tshard.run_sharded_2d(r2d, batch, MESH,
                                activation_spec=tshard.SEQUENCE_SPEC)
    return want, got, tshard.last_run(), batch, task


@functools.lru_cache(maxsize=None)
def _seq_family():
    return _seq_parallel(LM, FAMILY)


@functools.lru_cache(maxsize=None)
def _seq_cohort():
    spec = dataclasses.replace(LM, algorithms=("fedpbc", "fedavg"),
                               num_clients=8, cohort_size=2, seeds=(0,),
                               lrs=(0.1,))
    return _seq_parallel(spec, spec.algorithms)


@functools.lru_cache(maxsize=None)
def _seq_ragged():
    return _seq_parallel(dataclasses.replace(LM, seeds=(0,), lrs=(0.1,)),
                         FAMILY[:3])


SEQ_ARMS = {"family": _seq_family, "cohort": _seq_cohort,
            "ragged": _seq_ragged}


def _close(got, want):
    """Servers, losses and accuracies within ``SEQ_TOL``; everything else
    (the link and algorithm state, the active counts) equal."""
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
    np.testing.assert_array_equal(go["metrics"]["num_active"].numpy(),
                                  wo["metrics"]["num_active"].numpy())
    np.testing.assert_allclose(go["evals"].numpy(), wo["evals"].numpy(),
                               rtol=0, atol=SEQ_TOL)


@pytest.mark.parametrize("arm", list(SEQ_ARMS))
def test_sequence_parallel_matches_one_device(arm):
    """lm-family (all 4 members x 2 lrs x 2 seeds), the cohort arm (C = 2
    of m = 8) and a ragged B = 3 (padded to 4) with each sequence split
    over the 2 model ranks: the servers, losses and accuracies equal the
    single-device run within ``SEQ_TOL``, every rank split its sequences,
    and no padding row reached the result."""
    want, got, res, batch, _ = SEQ_ARMS[arm]()
    _close(got, want)
    assert got[0].server.shape[0] == batch.batch_size
    assert all(v["seq_split"] for v in res.values)
    assert [v["rows"] for v in res.values] == \
        [-(-batch.batch_size // 2)] * 4
    assert all(v["peak_bytes"] is None for v in res.values)


@pytest.mark.parametrize("arm", list(SEQ_ARMS))
def test_sequence_parallel_model_ranks_are_bitwise_equal(arm):
    """The model ranks of one batch index end with the same bits (the
    all-reduces hand every rank the same sums): the digests of their
    servers and outputs agree (the family's batch indices, other
    trajectories, differ)."""
    digests = [v["digest"] for v in SEQ_ARMS[arm]()[2].values]
    assert digests[0] == digests[1] and digests[2] == digests[3]
    if arm == "family":
        assert digests[0] != digests[2]


@pytest.mark.parametrize("arm", ["family", "cohort"])
def test_sequence_parallel_collectives_are_counted(arm):
    """Each rank's collectives equal ``collective_stats``'s sequence-split
    count: per local step an all-gather of K and of V a layer and the
    all-reduces of their gradients and of the parameter gradient; per
    round one all-reduce of the losses; no final gather."""
    spec = LM if arm == "family" else dataclasses.replace(
        LM, num_clients=8, cohort_size=2)
    _, _, res, batch, task = SEQ_ARMS[arm]()
    cfg = reduced(get_config(spec.lm_arch), d_model=spec.lm_d_model,
                  layers=spec.lm_layers)
    # one client's K of one layer over the whole sequence, fp32
    kv = (spec.batch_size * spec.lm_seq * cfg.attention.num_kv_heads
          * cfg.head_dim * 4)
    want = collective_stats(
        MESH.shape["model"], rows=batch.batch_size // 2,
        clients=spec.cohort_size or spec.num_clients,
        group_bytes=[4 * task.layout.size], rounds=spec.rounds,
        sequence=(spec.lm_layers, spec.local_steps, kv))
    steps = spec.rounds * spec.local_steps
    assert want.count_by_kind == {
        "all-gather": 2 * spec.lm_layers * steps,
        "all-reduce": (2 * spec.lm_layers + 1) * steps + spec.rounds}
    for v in res.values:
        assert v["gathers"]["bytes_by_kind"] == want.bytes_by_kind
        assert v["gathers"]["count_by_kind"] == want.count_by_kind
        assert v["gathers"]["seconds"] > 0


def _as_none(spec, algos):
    """A batch of ``spec`` through ``run_sharded_2d`` with
    ``SEQUENCE_SPEC`` and with ``None``: both results and the first's pool
    result."""
    task = tgrid.get_traced_task(spec, "cpu")
    fed = spec.cell_config(algos[0], spec.schemes[0])
    batch = tgrid.make_cell_batch(spec, fed, task, algos=algos, device="cpu")
    r2d = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                            device="cpu", shard_mesh=MESH)
    _ready()
    got = tshard.run_sharded_2d(r2d, batch, MESH,
                                activation_spec=tshard.SEQUENCE_SPEC)
    res = tshard.last_run()
    return got, tshard.run_sharded_2d(r2d, batch, MESH), res


@pytest.mark.parametrize("case", ["other-spec", "t-does-not-divide",
                                  "mlp-task", "runner-not-for-mesh"])
def test_activation_spec_refusals_and_fallbacks(case):
    """Another spec raises, naming the supported one; a sequence of 9 on
    2 model ranks and the MLP task (no sequence) run as ``None`` (the
    clients split, the same bits); a runner not built for the mesh is
    refused with or without a spec."""
    if case in ("other-spec", "runner-not-for-mesh"):
        spec = dataclasses.replace(LM, seeds=(0,), lrs=(0.1,))
        task = tgrid.get_traced_task(spec, "cpu")
        fed = spec.cell_config(FAMILY[0], "bernoulli_ti")
        batch = tgrid.make_cell_batch(spec, fed, task, algos=FAMILY[:2],
                                      device="cpu")
        mesh_for = MESH if case == "other-spec" else None
        runner = tgrid.make_runner(spec, fed, task, metric_keys=METRIC_KEYS,
                                   device="cpu", shard_mesh=mesh_for)
        if case == "other-spec":
            with pytest.raises(ValueError, match=r"P\(None, 'model', None\)"):
                tshard.run_sharded_2d(runner, batch, MESH,
                                      activation_spec=P(None, None, "model"))
        else:
            for a_spec in (None, tshard.SEQUENCE_SPEC):
                with pytest.raises(ValueError, match="not built for this mesh"):
                    tshard.run_sharded_2d(runner, batch, MESH,
                                          activation_spec=a_spec)
        return
    if case == "t-does-not-divide":
        spec = dataclasses.replace(LM, seeds=(0,), lrs=(0.1,), lm_seq=9,
                                   rounds=1, eval_every=1)
        algos = FAMILY[:2]
    else:
        spec = tgrid.SweepSpec(
            algorithms=("fedpbc",), schemes=("bernoulli_tv",), seeds=(0, 1),
            num_clients=4, dim=8, hidden=8, classes=4, n_per_class=20,
            n_train=80, per_client=8, batch_size=2, local_steps=1, rounds=2,
            eval_every=1, lrs=(0.1,))
        algos = spec.algorithms
    got, as_none, res = _as_none(spec, algos)
    assert not any(v["seq_split"] for v in res.values)
    for x, y in zip(_leaves(got), _leaves(as_none)):
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            assert x == y
