"""The port's last seven suites of ``benchmarks/run.py`` (``extensions``,
``kernels``, ``roofline``, ``scale``, ``throughput``, ``sweep``,
``lm_sweep``) against the reference's.

- Output from identical results: the pieces that compute (``run_training``,
  the timers, the kernel calls, the suites' arms) are replaced, in the
  reference's ``benchmarks`` module and in its port, by fakes giving the
  same numbers; the printed lines, the returned values and the JSON each
  writes must then be equal (exactly: the same numbers through the same
  formatting). The fakes stand in for computation only: the reduction,
  formatting and key layout are each package's own.
- Each suite also runs for real on the CPU at a tiny size: it prints the
  reference's CSV header, and its ``BENCH`` dict has the keys of the
  reference's committed run of the same suite (``benchmarks/out/*.json``,
  read only), nested, with the single-device branch where the reference
  ran a sharded one.
- ``roofline``: one dry-run JSON printed by ``benchmarks.roofline.run`` and
  by the port gives identical lines.
- ``lm_sweep.run(smoke=True, mesh=...)`` on ``make_2d_mesh(1, 2)`` over two
  CPU ranks (one pool for the module, started in the background when the
  module starts, as ``tests/test_torch_shard_2d.py``): both arms bit for
  bit against one device, the reference's keys
  (``benchmarks/out/lm_sweep.json``, read only), and a roofline row whose
  counts are the meta count of one round and ``collective_stats`` of its
  gathers.

Every call that writes a JSON gets ``out_path`` under ``tmp_path``: nothing
is written under ``benchmarks/out/``.
"""
import itertools
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:        # the reference's benchmarks/ (no package)
    sys.path.insert(0, ROOT)

from benchmarks import extensions as jext  # noqa: E402
from benchmarks import kernels_bench as jkern  # noqa: E402
from benchmarks import lm_sweep as jlm  # noqa: E402
from benchmarks import roofline as jroof  # noqa: E402
from benchmarks import scale as jscale  # noqa: E402
from benchmarks import sweep_throughput as jsweep  # noqa: E402
from benchmarks import throughput as jtp  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.launch.mesh import make_2d_mesh  # noqa: E402
from repro_torch.launch.roofline import collective_stats  # noqa: E402
from repro_torch.paper import common as tcommon  # noqa: E402
from repro_torch.paper import extensions as text  # noqa: E402
from repro_torch.paper import kernels_bench as tkern  # noqa: E402
from repro_torch.paper import lm_sweep as tlm  # noqa: E402
from repro_torch.paper import roofline as troof  # noqa: E402
from repro_torch.paper import scale as tscale  # noqa: E402
from repro_torch.paper import sweep_throughput as tsweep  # noqa: E402
from repro_torch.paper import throughput as ttp  # noqa: E402
from repro_torch.sharding import pool as tpool  # noqa: E402

SUITES = {"extensions": (jext, text), "kernels": (jkern, tkern),
          "scale": (jscale, tscale), "throughput": (jtp, ttp),
          "sweep": (jsweep, tsweep), "lm_sweep": (jlm, tlm)}
REFERENCE_OUT = {"kernels": "kernels.json", "scale": "scale.json",
                 "throughput": "throughput.json",
                 "sweep": "sweep_throughput.json",
                 "lm_sweep": "lm_sweep.json"}

MESH = make_2d_mesh(1, 2, ["cpu"] * 2)
_START = []


@pytest.fixture(scope="module", autouse=True)
def pools():
    """The module's pool of two CPU ranks, started in the background when
    the module starts and closed when it ends (one intra-op thread a
    worker: this process shares the host under ``pytest -n``)."""
    _START.append(threading.Thread(target=tpool.pool_for, args=(MESH,),
                                   kwargs={"threads": 1}))
    _START[0].start()
    yield
    _START[0].join(timeout=tpool.START_TIMEOUT_S)
    tpool.close_pools()


class _Clock:
    """A ``time`` module whose ``perf_counter`` ticks by one a call."""

    def __init__(self):
        self._t = itertools.count()

    def perf_counter(self):
        return float(next(self._t))


def _array(pkg):
    return (lambda x: torch.as_tensor(np.asarray(x, np.float32))) \
        if pkg == "port" else (lambda x: jnp.asarray(x, jnp.float32))


# -- the fakes of each suite ---------------------------------------------------


def _fake_extensions(mod, pkg, mp):
    def run_training(algo, scheme, *, rounds, m, seed, **kw):
        rng = np.random.default_rng([len(algo), len(scheme), seed, m])
        return [(t, float(v)) for t, v in zip(range(25, rounds + 1, 25),
                                              rng.random(rounds // 25))], 0.5
    mp.setattr(mod, "run_training", run_training)
    return dict(rounds=100, m=10, seeds=(0, 1))


def _fake_kernels(mod, pkg, mp):
    arr = _array(pkg)
    mp.setattr(mod, "_time", lambda fn, *a, reps=5: 12.25)
    mp.setattr(mod, "resolve_backend", lambda *a: "fake")
    mp.setattr(mod, "batched_agg_arms", lambda *a, **k: [
        {"arm": f"batched_agg_B{B}_m{m}_n1024", "B": B, "m": m, "n": 1024,
         "kernel_backend": "fake", "kernel_us": 3.5 * B, "xla_us": 7.0 * m,
         "speedup": round(2.0 * m / B, 3), "max_abs_diff": 1e-7 * B}
        for B, m in ((8, 32), (64, 256))])
    for name, off in (("masked_agg", 1e-3), ("flash_attention", 2e-3)):
        mp.setattr(mod, name, lambda *a, off=off, **k: arr([1.0 + off, 1.0]))
        mp.setattr(mod, name + "_ref", lambda *a, **k: arr([1.0, 1.0]))
    mp.setattr(mod, "rwkv6_chunk",
               lambda *a, **k: (arr([0.5 + 3e-4]), arr([0.0])))
    mp.setattr(mod, "rwkv6_chunk_ref",
               lambda *a, **k: (arr([0.5]), arr([0.0])))
    return {}


def _fake_scale(mod, pkg, mp):
    def bench_m(m, *, cohort, rounds, seeds, **kw):
        return {"m": m, "cohort": min(cohort, m), "rounds": rounds,
                "warm_seconds": 0.001 * m, "warm_rounds_per_s": 1e4 / m,
                "final_test_acc_buffered": 0.25, "commits": [7.0]}
    mp.setattr(mod, "_bench_m", bench_m)
    return dict(ms=(1000, 10000), rounds=6)


class _St:
    def __init__(self, server):
        self.server = server


def _fake_throughput(mod, pkg, mp):
    arr = _array(pkg)
    loss = arr([[0.75, 0.5, 0.25]] if pkg == "port" else [0.75, 0.5, 0.25])

    def rounds_fn(st, ds, key, n, **kw):
        return st, ds, {"loss": loss}

    st = _St(arr([0.0]))
    if pkg == "port":
        setup = (None,) * 5 + (type("T", (), {"loss_fn": None}),
                               lambda seed: (st, None, None))
    else:
        setup = (None,) * 5 + (lambda seed: (st, None),)
    mp.setattr(mod, "_setup", lambda *a, **k: setup)
    mp.setattr(mod, "make_round_fn", lambda *a, **k: None)
    mp.setattr(mod, "make_round_step", lambda *a, **k: (lambda *b: None))
    mp.setattr(mod, "make_run_rounds", lambda *a, **k: rounds_fn)
    mp.setattr(mod, "run_rounds_loop", rounds_fn)
    mp.setattr(mod, "time", _Clock())
    return dict(rounds=3, m=4)


def _evals(shape, salt):
    return np.random.default_rng(salt).random(shape).astype(np.float32)


def _fake_sweep(mod, pkg, mp):
    S, E, P, AS = 3, 2, 8, 2       # seeds, evals, ablation points and seeds

    def run_cell(spec, *a, **k):
        return type("C", (), {"test_acc": _evals((S, E), 1)})()

    mp.setattr(mod, "run_cell", run_cell)
    mp.setattr(mod, "_sequential_seed_arm",
               lambda *a, **k: _array(pkg)(_evals((S, E), 1)))
    mp.setattr(mod, "_algo_axis_arm",
               lambda spec, *a: {"n_cells": 4 * len(spec.seeds),
                                 "rounds": spec.rounds, "diff": 0.0})
    mp.setattr(mod, "_device_scaling_arm",
               lambda spec, *a, **k: {"n_devices": 1, "rounds": spec.rounds,
                                      "lrs": list(k["scaling_lrs"])})
    # the port's suites time through paper.common.timed
    mp.setattr(tcommon if pkg == "port" else mod, "time", _Clock())
    per_point = _evals((P, AS, E), 2)
    if pkg == "port":
        mp.setattr(mod, "get_traced_task", lambda *a, **k: None)
        mp.setattr(mod, "make_cell_batch", lambda *a, **k: None)
        mp.setattr(mod, "make_runner", lambda *a, **k: (
            lambda batch: (None, {"evals": torch.as_tensor(
                per_point.reshape(P * AS, E))})))
        mp.setattr(mod, "_per_value_arm", lambda spec, points, dev: (
            torch.as_tensor(per_point), P))
    else:
        mp.setattr(mod, "run_cell_batch", lambda *a, **k: [
            type("C", (), {"test_acc": per_point[i]})() for i in range(P)])
        mp.setattr(mod, "get_traced_task", lambda *a, **k: None)
        mp.setattr(mod, "_runner_for", lambda *a, **k: None)
        mp.setattr(mod, "_cache_entries", lambda runner: 1)
        mp.setattr(mod, "_per_value_recompile_arm",
                   lambda spec, points: (per_point, P))
    return dict(rounds=60, m=8, n_seeds=S, ablation_seeds=AS)


def _fake_lm_sweep(mod, pkg, mp):
    def arm(spec, algos, mesh, *a, with_roofline=False):
        out = {"algos": list(algos), "lrs": list(spec.lrs),
               "rounds": spec.rounds, "num_clients": spec.num_clients,
               "cohort_size": spec.cohort_size, "mesh": mesh}
        if with_roofline:
            out["roofline"] = {"useful_fraction": 0.5}
        return out
    mp.setattr(mod, "_throughput_arm", arm)
    return dict(rounds=6)


FAKES = {"extensions": _fake_extensions, "kernels": _fake_kernels,
         "scale": _fake_scale, "throughput": _fake_throughput,
         "sweep": _fake_sweep, "lm_sweep": _fake_lm_sweep}
WRITES = {"kernels", "scale", "throughput", "sweep", "lm_sweep"}


def _run_suite(name, pkg, monkeypatch, capsys, tmp_path):
    """``(stdout lines, returned value, written JSON or None)`` of one
    package's suite on the fakes."""
    mod = SUITES[name][pkg == "port"]
    kw = FAKES[name](mod, pkg, monkeypatch)
    kw["csv"] = True
    if pkg == "port":
        kw["device"] = "cpu"
    out_path = None
    if name in WRITES:
        out_path = str(tmp_path / pkg / f"{name}.json")
        kw["out_path"] = out_path
    capsys.readouterr()
    result = mod.run(**kw)
    lines = capsys.readouterr().out.splitlines()
    blob = None
    if out_path:
        with open(out_path) as f:
            blob = json.load(f)
    return lines, result, blob


@pytest.mark.parametrize("name", list(SUITES))
def test_suite_output_from_identical_results_matches_reference(
        name, monkeypatch, capsys, tmp_path):
    ref = _run_suite(name, "ref", monkeypatch, capsys, tmp_path)
    monkeypatch.undo()
    port = _run_suite(name, "port", monkeypatch, capsys, tmp_path)
    assert ref[0]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    bench = [ln for ln in port[0] if ln.startswith("BENCH ")]
    if name in WRITES:
        assert len(bench) == 1
        assert json.loads(bench[0][6:]) == port[2]


# -- roofline -------------------------------------------------------------------


def _dryrun_rows():
    ok = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "1xH100",
          "status": "ok", "t_compute_s": 1.5912345, "t_memory_s": 5.2291,
          "t_collective_s": 0.0, "bottleneck": "memory",
          "useful_fraction": 0.61234, "temp_bytes_per_device": None}
    return [ok, dict(ok, arch="gemma2-9b", temp_bytes_per_device=3.2e9),
            {"arch": "rwkv6-3b", "shape": "long_500k", "mesh": "1xH100",
             "status": "skip"},
            {"arch": "x", "shape": "train_4k", "status": "FAIL"}]


def test_roofline_prints_the_reference_lines(capsys, tmp_path):
    path = tmp_path / "dryrun_all.json"
    path.write_text(json.dumps(_dryrun_rows()))
    capsys.readouterr()
    want_rows = jroof.run(path=str(path))
    want = capsys.readouterr().out.splitlines()
    got_rows = troof.run(path=str(path))
    assert capsys.readouterr().out.splitlines() == want
    assert got_rows == want_rows
    assert len(want) == 5
    # a missing file: the hint names the port's dry run, and no rows
    missing = str(tmp_path / "none.json")
    assert troof.run(path=missing) == []
    hint = capsys.readouterr().out
    assert "python -m repro_torch.launch.dryrun --all --out " + missing \
        in hint
    assert troof.DEFAULT.endswith(os.path.join("build", "paper",
                                               "dryrun_all.json"))


# -- real runs on the CPU ---------------------------------------------------------


def _keys(d):
    """The nested key structure of a BENCH dict: dicts by key, a list of
    dicts by its first element."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


def _reference_keys(name):
    with open(os.path.join(ROOT, "benchmarks", "out",
                           REFERENCE_OUT[name])) as f:
        want = _keys(json.load(f))
    if name == "scale":       # one entry per m of the run's ladder
        entry = next(iter(want["by_m"].values()))
        want["by_m"] = {"scale_m300": entry}
    if name == "sweep":       # the reference's single-device branch
        want["device_scaling"] = {
            k: None for k in want["device_scaling"]
            if k not in ("sharded_seconds", "sharded_cells_per_s",
                         "speedup", "trajectory_max_abs_diff")}
        want["device_scaling"]["note"] = None
    if name == "lm_sweep":    # XLA names more collective kinds
        want["lm_family"]["roofline"]["coll_count"] = {"all-gather": None}
    return want


# tiny real runs: (suite, keyword arguments); lm_sweep's runs below, on
# a 2-D mesh of two CPU ranks
CPU_RUNS = {
    "extensions": dict(rounds=4, m=10),
    "kernels": {},
    "scale": dict(ms=(300,), cohort=16, rounds=3),
    "throughput": dict(rounds=3, m=6),
    "sweep": dict(rounds=4, m=6, n_seeds=2, ablation_seeds=2,
                  ablation_rounds=2),
}
HEADERS = {"extensions": "extensions,scheme,algo,test_acc_mean",
           "kernels": "kernels,name,us_per_call,derived"}


@pytest.fixture
def one_thread():
    """One intra-op thread for a real run: this process shares the host
    with the other workers under ``pytest -n``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CPU_RUNS))
def test_suite_runs_on_the_cpu_with_the_reference_keys(
        name, monkeypatch, capsys, tmp_path, one_thread):
    mod = SUITES[name][1]
    kw = dict(CPU_RUNS[name], device="cpu")
    if name != "extensions":
        kw["out_path"] = str(tmp_path / f"{name}.json")
    capsys.readouterr()
    result = mod.run(**kw)
    lines = capsys.readouterr().out.splitlines()
    if name in HEADERS:
        assert HEADERS[name] in lines
    if name == "extensions":
        assert len(result) == 4
        assert all(0.0 <= v <= 1.0 for v in result.values())
        return
    bench = [json.loads(ln[6:]) for ln in lines if ln.startswith("BENCH ")]
    assert len(bench) == 1
    assert _keys(bench[0]) == _reference_keys(name)
    with open(kw["out_path"]) as f:
        assert json.load(f) == bench[0]
    if name == "kernels":
        assert bench[0]["kernel_backend"] == "torch"
        assert all(a["max_abs_diff"] == 0.0 for a in bench[0]["batched_agg"])
    if name == "throughput":
        assert result["final_loss_loop"] == result["final_loss_scan"]
    if name == "sweep":
        assert result["trajectory_max_abs_diff"] == 0.0
        assert result["hparam_ablation"]["trajectory_max_abs_diff"] == 0.0
        assert result["algo_axis"]["batched_compile_programs"] == 1
        assert result["algo_axis"]["per_algo_compile_programs"] == 4


def test_seed_base_probs_is_point_base_probs_at_the_default_point():
    """The spec's scalar point, whatever its swept axes."""
    spec = tgrid.SweepSpec(seeds=(0, 3), num_clients=12, alpha=0.5,
                           sigma0=2.0, delta=0.05, alphas=(0.1, 1.0))
    got = tgrid.seed_base_probs(spec)
    want = tgrid.point_base_probs(spec, dict(alpha=0.5, sigma0=2.0,
                                             delta=0.05))
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


def test_lm_sweep_2d_arm_on_two_cpu_ranks(capsys, one_thread):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_step

    _START[0].join(timeout=tpool.START_TIMEOUT_S)
    capsys.readouterr()
    res = tlm.run(smoke=True, device="cpu", mesh=MESH)
    bench = [json.loads(ln[6:]) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("BENCH ")]
    assert bench == [res]
    with open(os.path.join(ROOT, "benchmarks", "out", "lm_sweep.json")) as f:
        want = _keys(json.load(f))
    want["lm_family"]["roofline"]["coll_count"] = {"all-gather": None}
    assert _keys(res) == want
    for arm in ("lm_family", "cohort"):
        assert res[arm]["bitwise"], res[arm]
        assert res[arm]["mesh"] == {"batch": 1, "model": 2}
    # the roofline: one round counted on meta for each trajectory a card
    # holds, and the round's gathers of a rank
    row = res["lm_family"]["roofline"]
    lm = tgrid.SweepSpec(algorithms=("fedpbc",), seeds=(0,), num_clients=4,
                         local_steps=1, batch_size=1, per_client=8,
                         task="lm", lm_d_model=32, lm_layers=1, lm_seq=16,
                         classes=4, lm_n_seqs=64, lm_n_test=16)
    one = count_step(tlm._lm_config(lm), ShapeConfig("lm_sweep", 16, 4,
                                                     "train"),
                     num_clients=4, local_steps=1)
    B = res["lm_family"]["padded_trajectories"]
    assert row["hlo_flops"] == pytest.approx(one["flops"] * B / 2)
    n = row["param_count"]
    coll = collective_stats(2, rows=B, clients=4, group_bytes=[4 * n],
                            rounds=1)
    assert row["coll_bytes"] == coll.total_bytes
    assert row["coll_count"] == {"all-gather": 2}
    assert row["model_flops"] == 6.0 * n * B * 4 * 1 * 1 * 16
    assert 0 < row["useful_fraction"] < 1
