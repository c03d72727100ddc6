"""The port's multi-device split of the sweep's batch axis
(``repro_torch.experiments.shard``): the port of
``tests/test_sharded_sweep.py`` and of
``tests/test_scale.py::test_buffered_sweep_sharded_matches_single_device``,
plus two checks against the JAX package.

The guarantee is the reference's: splitting the flattened batch axis over a
``("batch",)`` mesh, including padding B up to a multiple of the axis,
changes nothing per trajectory. Every result leaf of the sharded path equals
the single-device path bit for bit, and padding rows never reach a
``CellResult`` or a ``ResultsStore`` row.

The reference forces 8 host devices into one process; the port runs one
worker process per mesh device (``repro_torch.sharding.pool``), here 4 CPU
ranks under gloo that meet through a ``FileStore`` in a temporary
directory, one pool for the whole module (a 1-rank pool for the explicit
single-device mesh). ``BASE`` has B = 6 trajectories, padded to 8 on the
4 ranks, so the padding path runs end to end. Against the JAX package: the
reference's per-trajectory draws through the port's 4-rank run of a family
cell (the tolerances of
``tests/test_torch_sweep.py::test_batched_family_cell_matches_per_trajectory_reference``),
and ``pad_batch`` against the reference's on the same arrays.
"""
import dataclasses
import functools
import operator
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import FAMILY, JaxKeyDraws, np_tree  # noqa: E402
from repro.experiments import shard as jshard  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.experiments import ResultsStore  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import shard as tshard  # noqa: E402
from repro_torch.experiments.shard import (  # noqa: E402
    pad_batch,
    resolve_batch_mesh,
    run_sharded,
    shard_batch,
)
from repro_torch.launch.mesh import (  # noqa: E402
    make_2d_mesh,
    make_batch_mesh,
    make_host_mesh,
)
from repro_torch.scale import BUFFER_METRIC_KEYS, SYNC, Strategy  # noqa: E402
from repro_torch.sharding import pool as tpool  # noqa: E402
from test_torch_sweep import _reference_trajectories, _spec  # noqa: E402

SEEDS = (0, 1, 2)
# B = 2 lrs x 3 seeds = 6 trajectories: NOT divisible by the 4 ranks, so
# the sharded tests run the padding path end to end
BASE = tgrid.SweepSpec(seeds=SEEDS, num_clients=8, dim=16, hidden=16,
                       classes=10, n_per_class=60, n_train=480, per_client=24,
                       batch_size=4, local_steps=3, rounds=5, eval_every=2,
                       lrs=(0.05, 0.1))
METRIC_KEYS = ("loss", "num_active")
MESH = make_batch_mesh(["cpu"] * 4)
ONE = ["cpu"]
MESH1 = make_batch_mesh(ONE)
CELL_FIELDS = ("test_acc", "train_acc", "loss", "num_active", "server")
_STARTS = {}
WORKER_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def pools():
    """The module's pools, 4 CPU ranks and 1, started together in the
    background when the module starts (the tests before their first use
    run meanwhile; ``_ready`` waits for them) and closed when it ends. Their
    workers take one intra-op thread each: under ``pytest -n 6`` this
    module's process shares the host with five others."""
    for mesh in (MESH, MESH1):
        _STARTS[mesh] = threading.Thread(target=tpool.pool_for, args=(mesh,),
                                         kwargs={"threads": WORKER_THREADS})
        _STARTS[mesh].start()
    yield
    _ready(MESH, MESH1)
    tpool.close_pools()


def _ready(*meshes):
    for mesh in meshes:
        _STARTS[mesh].join(timeout=tpool.START_TIMEOUT_S)
        assert not _STARTS[mesh].is_alive()


@functools.lru_cache(maxsize=None)
def _plain_cells():
    """BASE's fedpbc cell on one device in this process."""
    return tuple(tgrid.run_cell_batch(BASE, "fedpbc", "bernoulli_tv",
                                      metric_keys=METRIC_KEYS, mesh=None,
                                      device="cpu"))


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


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            assert x == y


def _assert_cells_equal(a, b):
    assert (a.algo, a.scheme, a.hparams, a.strategy) == \
        (b.algo, b.scheme, b.hparams, b.strategy)
    for f in CELL_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _cell_batch(spec=BASE, algos=None):
    task = tgrid.get_traced_task(spec, "cpu")
    fed = spec.cell_config("fedpbc", "bernoulli_tv")
    return task, fed, tgrid.make_cell_batch(spec, fed, task, algos=algos,
                                            device="cpu")


def test_pad_batch_repeats_last_trajectory():
    _, _, batch = _cell_batch()
    B = batch.batch_size
    assert B == 6

    same, b_real = pad_batch(batch, 3)          # 3 | 6: no-op, same object
    assert same is batch and b_real == B

    padded, b_real = pad_batch(batch, 4)        # 6 -> 8
    assert b_real == B and padded.batch_size == 8
    for x, p in zip(_leaves((batch.p_base, batch.hparams, batch.data)),
                    _leaves((padded.p_base, padded.hparams, padded.data))):
        np.testing.assert_array_equal(p[:B].numpy(), x.numpy())
        for row in p[B:]:
            np.testing.assert_array_equal(row.numpy(), x[-1].numpy())
    # a padding row draws from its twin's bundle; the bundles and shared
    # are untouched (shared has no batch axis to pad)
    assert padded.gen_index == batch.gen_index + [batch.gen_index[-1]] * 2
    assert padded.gens is batch.gens and padded.gen_tags == batch.gen_tags
    assert padded.shared is batch.shared


def test_pad_batch_matches_the_reference_pad_batch():
    """A family batch (4 algorithms x 2 lrs x 3 seeds = 24) padded to a
    multiple of 7: ``p_base``, ``hparams`` and ``algo_id`` equal the
    reference's ``pad_batch`` of the same arrays, and each padded row's
    bundle is the seed whose key the reference repeats."""
    _, _, batch = _cell_batch(algos=FAMILY)
    assert batch.batch_size == 24
    padded, b_real = pad_batch(batch, 7)
    seeds = [batch.gen_tags[i] for i in batch.gen_index]
    ref = jsweep.CellBatch(
        keys=jax.tree.map(lambda *k: jnp.stack(k),
                          *[jsweep.seed_keys(s) for s in seeds]),
        p_base=jnp.asarray(batch.p_base.numpy()),
        hparams={k: jnp.asarray(v.numpy()) for k, v in batch.hparams.items()},
        data={"idx": jnp.asarray(batch.data["idx"].numpy())}, shared=(),
        algo_id=jnp.asarray(batch.algo_id.numpy(), jnp.int32))
    want, want_b = jshard.pad_batch(ref, 7)
    assert b_real == want_b == 24 and padded.batch_size == 28
    np.testing.assert_array_equal(padded.p_base.numpy(),
                                  np.asarray(want.p_base))
    for k, v in padded.hparams.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want.hparams[k]))
    np.testing.assert_array_equal(padded.algo_id.numpy(),
                                  np.asarray(want.algo_id))
    np.testing.assert_array_equal(padded.data["idx"].numpy(),
                                  np.asarray(want.data["idx"]))
    padded_seeds = [padded.gen_tags[i] for i in padded.gen_index]
    for name, keys in want.keys.items():
        for s, k in zip(padded_seeds, np.asarray(keys)):
            np.testing.assert_array_equal(
                k, np.asarray(jsweep.seed_keys(s)[name]))


def test_resolve_batch_mesh_semantics():
    assert resolve_batch_mesh(None) is None
    assert resolve_batch_mesh(None, devices=ONE) is None
    # an explicit device list opts in, even with a single device
    mesh1 = resolve_batch_mesh("auto", devices=ONE)
    assert mesh1.axis_names == ("batch",) and mesh1.size == 1
    auto = resolve_batch_mesh()
    if torch.cuda.device_count() > 1:
        assert auto is not None and auto.size == torch.cuda.device_count()
    else:
        assert auto is None
    explicit = make_batch_mesh(["cpu"] * 4)
    assert resolve_batch_mesh(explicit) is explicit
    # equal meshes hash equal (the batch cache keys on them)
    assert explicit == MESH and hash(explicit) == hash(MESH)
    assert explicit.shape == {"batch": 4}
    with pytest.raises(ValueError, match="'batch' axis"):
        resolve_batch_mesh(make_host_mesh())
    with pytest.raises(ValueError, match="mesh must be"):
        resolve_batch_mesh("everywhere")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_batch_mesh()
    errors = []
    for make, devs in ((make_2d_mesh, ["cpu"]), (jmesh.make_2d_mesh,
                                                 jax.devices()[:1])):
        with pytest.raises(ValueError, match="needs 6 devices") as err:
            make(3, 2, devs)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_backend_follows_the_mesh_devices():
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert tpool.backend_for(MESH) == "gloo"
    assert tpool.backend_for(make_batch_mesh(cuda)) == "nccl"
    # NCCL refuses two ranks on one card
    assert tpool.backend_for(make_batch_mesh(cuda[:1] * 2)) == "gloo"
    assert tpool.backend_for(make_2d_mesh(2, 2, cuda)) == "nccl"


def test_shard_batch_requires_divisible_batch():
    _, _, batch = _cell_batch()                 # B = 6
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, MESH)
    padded, _ = pad_batch(batch, 4)
    parts = shard_batch(padded, MESH)
    assert [p.batch_size for p in parts] == [2, 2, 2, 2]
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part.p_base.numpy(),
                                      padded.p_base[2 * r:2 * r + 2].numpy())
        # each slice carries the bundles of its own rows only
        rows = padded.gen_index[2 * r:2 * r + 2]
        assert [part.gen_tags[i] for i in part.gen_index] == \
            [padded.gen_tags[i] for i in rows]
        assert len(part.gens) == len(set(rows))


def test_sharded_family_cell_matches_the_reference_on_its_draws():
    """The whole slice against the JAX package: the reference's
    per-trajectory draws (``JaxKeyDraws``, sliced per rank with ``take``)
    through the port's 4-rank run of a family cell (4 algorithms x 2
    seeds, 3 rounds and one eval), each trajectory within the tolerances
    of the single-device parity test: server and losses rtol = atol =
    1e-4, active counts exact, test accuracy within one test example."""
    scheme, rounds = "bernoulli_tv", 3
    fed, jtask, ref = _reference_trajectories(scheme, rounds, rounds)
    spec = _spec(tgrid, use_kernel=False, rounds=rounds, eval_every=rounds)
    task = tgrid.get_traced_task(spec, "cpu")
    tfed = spec.cell_config("fedpbc", scheme)
    batch = tgrid.make_cell_batch(spec, tfed, task, algos=FAMILY,
                                  device="cpu")
    batch.p_base = torch.as_tensor(np.stack([p for _, p in ref]))
    draws = JaxKeyDraws([s for _ in FAMILY for s in (0, 1)], fed, jtask,
                        task.layout, rounds)
    runner = tgrid.make_runner(spec, tfed, task, device="cpu")
    _ready(MESH)
    states, out = run_sharded(runner, batch, MESH, draws=draws)
    assert [v["rows"] for v in tshard.last_run().values] == [2, 2, 2, 2]
    for b, ((st, evals, mets), _) in enumerate(ref):
        np.testing.assert_allclose(
            states.server[b].numpy(),
            convert.params_from_jax(np_tree(st.server), task.layout).numpy(),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out["metrics"]["num_active"][b].numpy(),
                                      np.asarray(mets["num_active"]))
        np.testing.assert_allclose(out["metrics"]["loss"][b].numpy(),
                                   np.asarray(mets["loss"]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(out["evals"][b].numpy(), np.asarray(evals),
                                   rtol=0,
                                   atol=1.0 / task.meta["n_test"] + 1e-6)


def test_explicit_single_device_mesh_matches_plain_path():
    """The pad/shard/slice wrapper itself must be a numeric no-op: an
    explicit 1-device mesh (one worker process) equals the plain path
    bitwise."""
    plain = _plain_cells()
    _ready(MESH1)
    wrapped = tgrid.run_cell_batch(BASE, "fedpbc", "bernoulli_tv",
                                   metric_keys=METRIC_KEYS, devices=ONE,
                                   device="cpu")
    assert len(plain) == len(wrapped) == 2
    for a, b in zip(plain, wrapped):
        _assert_cells_equal(a, b)
    assert len(tshard.last_run().values) == 1


def test_sharded_batch_cache_is_period_independent():
    """Cells differing only in a ``period`` fed_override must reuse ONE
    committed copy of the batch rows (the cache key excludes fed); only
    the [B] period column is rebuilt, in the workers, and it must still be
    wired: the two periods give different activation trajectories."""
    spec20 = dataclasses.replace(BASE, fed_overrides=(("period", 20),))
    spec40 = dataclasses.replace(spec20, fed_overrides=(("period", 40),))
    _ready(MESH1)
    n0 = len(tgrid._SHARDED_BATCH_CACHE)
    c20 = tgrid.run_cell_batch(spec20, "fedpbc", "bernoulli_tv",
                               metric_keys=METRIC_KEYS, devices=ONE,
                               device="cpu")
    c40 = tgrid.run_cell_batch(spec40, "fedpbc", "bernoulli_tv",
                               metric_keys=METRIC_KEYS, devices=ONE,
                               device="cpu")
    assert len(tgrid._SHARDED_BATCH_CACHE) <= n0 + 1
    (entry,) = tgrid._SHARDED_BATCH_CACHE.values()
    assert len(entry) == 1
    assert not np.array_equal(np.concatenate([c.num_active for c in c20]),
                              np.concatenate([c.num_active for c in c40]))


def test_sharded_runner_bit_for_bit_with_padding():
    """4 CPU ranks, B = 6 (padded to 8): every leaf of (states, out) from
    the sharded path equals the single-device run of the SAME runner, per
    trajectory; the workers rebuild that runner once each."""
    task, fed, batch = _cell_batch()
    runner = tgrid.make_runner(BASE, fed, task, metric_keys=METRIC_KEYS,
                               device="cpu")
    assert batch.batch_size % MESH.size != 0
    ref = runner(batch)                                  # single-device
    _ready(MESH)
    got = run_sharded(runner, batch, MESH)
    _assert_trees_equal(got, ref)
    built = [v["runners_built"] for v in tshard.last_run().values]
    again = run_sharded(runner, batch, MESH)
    _assert_trees_equal(again, ref)
    assert [v["runners_built"] for v in tshard.last_run().values] == built


def test_sharded_outputs_live_on_all_devices():
    """The sharded run must actually split the batch axis: each of the 4
    ranks is its own process on its mesh device and ran its 2 rows."""
    task, fed, batch = _cell_batch()
    runner = tgrid.make_runner(BASE, fed, task, metric_keys=METRIC_KEYS,
                               device="cpu")
    _ready(MESH)
    states, out = run_sharded(runner, batch, MESH)
    assert out["metrics"]["loss"].shape == (6, BASE.rounds)
    assert states.server.shape[0] == 6
    res = tshard.last_run()
    assert res.backend == "gloo"
    assert [r.rank for r in res.ranks] == [0, 1, 2, 3]
    assert [r.device for r in res.ranks] == ["cpu"] * 4
    assert len({r.pid for r in res.ranks}) == 4
    assert [v["rows"] for v in res.values] == [2, 2, 2, 2]
    assert all(v["value"] is not None for v in res.values)


def test_run_cell_batch_auto_shards_and_matches(monkeypatch):
    """``mesh="auto"`` keeps a CPU call in this process (no pool call) and
    resolves to a mesh of every card when more than one is visible (here
    the 4 ranks stand in for them); the sharded per-point results equal
    ``mesh=None``."""
    plain = _plain_cells()
    _ready(MESH)
    before = tshard.last_run()
    auto = tgrid.run_cell_batch(BASE, "fedpbc", "bernoulli_tv",
                                metric_keys=METRIC_KEYS, device="cpu")
    assert tshard.last_run() is before
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tshard, "make_batch_mesh", lambda: MESH)
    mesh = resolve_batch_mesh()
    assert mesh is MESH
    sharded = tgrid.run_cell_batch(BASE, "fedpbc", "bernoulli_tv",
                                   metric_keys=METRIC_KEYS, mesh=mesh,
                                   device="cpu")
    assert tshard.last_run() is not before
    for a, b, c in zip(plain, auto, sharded):
        _assert_cells_equal(a, b)
        _assert_cells_equal(a, c)


def test_padded_sharded_sweep_writes_exactly_b_real_rows(tmp_path):
    """End to end through the store: a padded-B sharded sweep (2 algorithms
    x 3 seeds, 6 -> 8) appends exactly one row per (algorithm, point) with
    [S]-seed arrays; the padding trajectories never reach a row."""
    spec = dataclasses.replace(BASE, lrs=(0.1,))
    store = ResultsStore(str(tmp_path / "sweeps"))
    _ready(MESH)
    n_sharded = len(tgrid._SHARDED_BATCH_CACHE)
    cells = tgrid.run_sweep(spec, store=store, suite="shard-smoke",
                            metric_keys=METRIC_KEYS, mesh=MESH, device="cpu")
    assert len(tgrid._SHARDED_BATCH_CACHE) <= n_sharded + 1
    assert [v["rows"] for v in tshard.last_run().values] == [2, 2, 2, 2]
    assert len(cells) == len(spec.algorithms) * len(spec.schemes)
    rows = store.records(suite="shard-smoke")
    assert len(rows) == len(cells)
    plain = tgrid.run_sweep(spec, metric_keys=METRIC_KEYS, mesh=None,
                            device="cpu")
    for row, cell, want in zip(rows, cells, plain):
        arrays = store.load_arrays(row)
        assert arrays["test_acc"].shape == (len(SEEDS), 3)
        assert arrays["loss"].shape == (len(SEEDS), spec.rounds)
        np.testing.assert_array_equal(arrays["test_acc"], cell.test_acc)
        _assert_cells_equal(cell, want)
        # padding repeats the LAST real trajectory; a leaked padding row
        # would duplicate it: all seeds stay distinct
        assert len({a.tobytes() for a in arrays["loss"]}) == len(SEEDS)


def test_buffered_sweep_sharded_matches_single_device():
    """tests/test_scale.py's pin: a (SYNC, buffered) sweep, B = 4, on 4
    ranks equals the explicit 1-device mesh, commits included."""
    spec = tgrid.SweepSpec(
        algorithms=("fedpbc",), seeds=(0, 1), num_clients=8, dim=16,
        hidden=16, classes=10, n_per_class=60, n_train=480, per_client=24,
        batch_size=4, local_steps=2, rounds=4, eval_every=2, lrs=(0.1,),
        strategies=(SYNC, Strategy("buffered", buffer_size=4,
                                   deadline_rounds=3)),
        schemes=("bernoulli_ti",))
    keys = METRIC_KEYS + BUFFER_METRIC_KEYS
    _ready(MESH, MESH1)
    ref = tgrid.run_sweep(spec, metric_keys=keys, devices=ONE, device="cpu")
    sh = tgrid.run_sweep(spec, metric_keys=keys, mesh=MESH, device="cpu")
    assert [c.strategy for c in sh] == [c.strategy for c in ref] == \
        ["sync", "buffered"]
    for a, b in zip(sh, ref):
        _assert_cells_equal(a, b)
        np.testing.assert_array_equal(a.commit, b.commit)
        np.testing.assert_array_equal(a.commit_staleness, b.commit_staleness)


def test_pool_workers_take_the_callers_thread_count():
    """``pool_for(mesh, threads=...)`` sets every worker's intra-op
    threads; the pool is then reused as it is."""
    _ready(MESH)
    pool = tpool.pool_for(MESH)
    got = pool.run(torch.get_num_threads, [()] * MESH.size).values
    assert got == [WORKER_THREADS] * MESH.size
    assert tpool.pool_for(MESH, threads=3) is pool


def test_worker_error_fails_the_call_and_a_slow_rendezvous_times_out(
        monkeypatch):
    """A worker's exception reaches the caller with its traceback and
    closes the pool (other ranks may wait in a collective); a rendezvous
    that does not finish within ``START_TIMEOUT_S`` raises."""
    _ready(MESH1)
    mesh = MESH1
    pool = tpool.pool_for(mesh)
    assert pool.run(operator.truediv, [(1, 2)]).values == [0.5]
    with pytest.raises(RuntimeError, match="(?s)rank 0.*ZeroDivisionError"):
        pool.run(operator.truediv, [(1, 0)])
    assert pool.closed
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(operator.truediv, [(1, 2)])
    monkeypatch.setattr(tpool, "START_TIMEOUT_S", 0.01)
    with pytest.raises(TimeoutError, match="rendezvous"):
        tpool.Pool(mesh)
