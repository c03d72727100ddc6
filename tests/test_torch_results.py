"""The port's results store and curve export (``repro_torch.experiments``
``results`` / ``plots``) against the JAX reference's.

- The reference's own store, ``cell_key``, merge and export contracts
  (``tests/test_results_tools.py``, ``tests/test_plots.py``) run against the
  port's functions.
- Cross-package parity: both packages' ``run_sweep(store=...)`` on one spec
  (7 algorithms, 1 scheme, m = 8, 6 rounds, 2 seeds) write rows with the
  same keys, the same ``spec`` record, the same npz array names and equal
  ``cell_key``s; each package reads the other's store; ``merge`` of the two
  dedups every pair (the later store wins); both ``export_curves`` write the
  same file names with the same bytes. Tolerance: exact for keys, names,
  identities and bytes (the accuracy values themselves come from two
  frameworks' draws and are not compared here).
- The port's ``run_sweep`` keeps the rows of a finished family group when a
  later group crashes, and ``CellResult.summary`` writes the reference's
  keys.
"""
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_plots as ref_plot_tests  # noqa: E402
import test_results_tools as ref_store_tests  # noqa: E402
from _torch_parity import SMALL  # noqa: E402
from repro.experiments import grid as jgrid  # noqa: E402
from repro.experiments import plots as jplots  # noqa: E402
from repro.experiments import results as jres  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import plots as tplots  # noqa: E402
from repro_torch.experiments import results as tres  # noqa: E402

ALGOS = ("fedpbc", "fedavg", "fedavg_all", "fedau", "f3ast",
         "fedavg_known_p", "mifa")

# the port's object for each name the reference's contract tests import
PORT_NAMES = {"ResultsStore": tres.ResultsStore, "cell_key": tres.cell_key,
              "group_by_sha": tres.group_by_sha, "results_main": tres.main,
              "export_curves": tplots.export_curves,
              "plots_main": tplots.main}
# every contract of the two reference files but the one that imports the
# reference's summarize() inside its body
CONTRACTS = [(ref_store_tests, n) for n in dir(ref_store_tests)
             if n.startswith("test_") and n != "test_summarize_ignores_nan_padding"] + \
            [(ref_plot_tests, n) for n in dir(ref_plot_tests)
             if n.startswith("test_")]


@pytest.mark.parametrize("module,name", CONTRACTS,
                         ids=[n for _, n in CONTRACTS])
def test_reference_store_contract_holds_for_the_port(module, name, tmp_path,
                                                     capsys, monkeypatch):
    for attr, port_obj in PORT_NAMES.items():
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, port_obj)
    fn = getattr(module, name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys,
                "monkeypatch": monkeypatch}
    fn(**{a: fixtures[a] for a in inspect.signature(fn).parameters})


def test_summarize_matches_reference_on_nan_padding():
    for vals in ([0.5, float("nan"), 0.7], [float("nan")], [0.3], []):
        assert tres.summarize(vals) == pytest.approx(jres.summarize(vals),
                                                     nan_ok=True)


# ---------------------------------------------------------------------------
# cross-package parity on one spec
# ---------------------------------------------------------------------------


def _spec(module):
    return module.SweepSpec(
        algorithms=ALGOS, schemes=("bernoulli_tv",), seeds=(0, 1), rounds=6,
        eval_every=3, data_seed=0,
        **{k: SMALL[k] for k in ("num_clients", "dim", "hidden", "per_client",
                                 "local_steps", "batch_size", "n_per_class",
                                 "n_train")})


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """``{"port": root, "ref": root}``: the same spec swept by each package
    into its own store."""
    base = tmp_path_factory.mktemp("stores")
    roots = {"port": str(base / "port"), "ref": str(base / "ref")}
    tgrid.run_sweep(_spec(tgrid), store=tres.ResultsStore(roots["port"]),
                    suite="parity", device="cpu")
    jgrid.run_sweep(_spec(jgrid), store=jres.ResultsStore(roots["ref"]),
                    suite="parity")
    return roots


def test_port_rows_match_reference_rows_key_for_key(stores):
    port = tres.ResultsStore(stores["port"]).records()
    ref = jres.ResultsStore(stores["ref"]).records()
    assert [r["algo"] for r in port] == list(ALGOS)
    assert len(port) == len(ref) == len(ALGOS)
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        assert tres.cell_key(p) == jres.cell_key(r) == jres.cell_key(p)
        assert p["spec"] == r["spec"]
        assert set(p["summary"]) == set(r["summary"]) == {"test_acc",
                                                          "train_acc"}
        for k in ("suite", "algo", "scheme", "strategy", "seeds", "rounds",
                  "eval_every", "hparams", "eval_rounds", "record_id",
                  "git_sha"):
            assert p[k] == r[k], k


@pytest.mark.parametrize("writer,reader", [("port", jres), ("ref", tres)])
def test_each_package_reads_the_others_store(stores, writer, reader):
    rows = reader.ResultsStore(stores[writer]).records(suite="parity")
    assert [r["algo"] for r in rows] == list(ALGOS)
    for rec in rows:
        arrays = reader.ResultsStore(stores[writer]).load_arrays(rec)
        assert set(arrays) == {"test_acc", "train_acc", "loss", "num_active"}
        assert arrays["test_acc"].shape == (2, 2)
        assert arrays["loss"].shape == arrays["num_active"].shape == (2, 6)
        assert arrays["num_active"].dtype == np.int32
        assert np.isfinite(arrays["test_acc"]).all()


@pytest.mark.parametrize("merger", [tres, jres], ids=["port", "reference"])
@pytest.mark.parametrize("order", [("ref", "port"), ("port", "ref")])
def test_merge_of_both_stores_dedups_every_pair_later_wins(stores, tmp_path,
                                                           merger, order):
    merged = merger.ResultsStore.merge(str(tmp_path / "m"),
                                       *(stores[o] for o in order))
    rows = merged.records()
    assert [r["algo"] for r in rows] == list(ALGOS)
    last = merger.ResultsStore(stores[order[-1]])
    for rec, src in zip(rows, last.records()):
        assert rec["source_record_id"] == src["record_id"]
        got, want = merged.load_arrays(rec), last.load_arrays(src)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("which", ["port", "ref"])
def test_export_curves_writes_the_same_files_as_the_reference(stores, which,
                                                              tmp_path):
    store = tres.ResultsStore(stores[which])
    got = tplots.export_curves(store, str(tmp_path / "port"), suite="parity")
    want = jplots.export_curves(jres.ResultsStore(stores[which]),
                                str(tmp_path / "ref"), suite="parity")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == 2 * len(ALGOS)
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


# ---------------------------------------------------------------------------
# the port's persistence contracts
# ---------------------------------------------------------------------------


def test_run_sweep_persists_completed_groups_before_later_failures(
        tmp_path, monkeypatch):
    """Port of ``tests/test_algo_axis.py``'s crash salvage: a failing fedau
    group leaves the fedpbc and fedavg rows (fedavg ran with fedpbc but is
    spec-ordered after fedau) in the store."""
    spec = tgrid.SweepSpec(
        algorithms=("fedpbc", "fedau", "fedavg"), schemes=("bernoulli_ti",),
        seeds=(0,), rounds=3, eval_every=0,
        **{k: SMALL[k] for k in ("num_clients", "dim", "hidden", "per_client",
                                 "local_steps", "batch_size", "n_per_class",
                                 "n_train")})
    real = tgrid._run_batch

    def failing(spec_, algos, scheme, **kw):
        if "fedau" in algos:
            raise RuntimeError("simulated OOM in fedau group")
        return real(spec_, algos, scheme, **kw)

    monkeypatch.setattr(tgrid, "_run_batch", failing)
    store = tres.ResultsStore(str(tmp_path / "sweeps"))
    with pytest.raises(RuntimeError, match="simulated OOM"):
        tgrid.run_sweep(spec, store=store, suite="crash", device="cpu")
    assert [r["algo"] for r in store.records(suite="crash")] == [
        "fedpbc", "fedavg"]


def test_cell_summary_matches_reference_keys():
    """A dense sync cell writes the reference's two-key summary; with
    ``num_clients`` set, ``participation`` joins, as in the reference."""
    rng = np.random.default_rng(0)
    kw = dict(algo="fedpbc", scheme="bernoulli_ti", seeds=(0, 1), rounds=4,
              eval_rounds=[2, 4], test_acc=rng.random((2, 2)),
              train_acc=rng.random(2), loss=rng.random((2, 4)),
              num_active=rng.integers(0, 9, (2, 4)).astype(np.int32))
    for n in (0, 8):
        port = tgrid.CellResult(num_clients=n, **kw).summary()
        ref = jgrid.CellResult(num_clients=n, **kw).summary()
        assert port == ref
        assert set(port) == ({"test_acc", "train_acc"} if n == 0 else
                             {"test_acc", "train_acc", "participation"})


def test_sweep_cli_appends_to_a_store_with_out(tmp_path, capsys):
    from repro_torch.experiments import sweep as tsweep

    args = ["--device", "cpu", "--algos", "fedpbc,fedavg", "--rounds", "2",
            "--eval-every", "1", "--clients", "8", "--seeds", "0",
            "--lrs", "0.05,0.1", "--suite", "cli-test"]
    tsweep.main(args)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == ("sweep,scheme,algo,strategy,hparams,seeds,"
                                   "test_acc_mean,test_acc_ci95,"
                                   "train_acc_mean")
    assert "appended" not in out                # no --out: print only
    tsweep.main(args + ["--out", str(tmp_path / "s")])
    rows = jres.ResultsStore(str(tmp_path / "s")).records(suite="cli-test")
    assert [(r["algo"], r["hparams"]["lr"]) for r in rows] == [
        ("fedpbc", 0.05), ("fedpbc", 0.1), ("fedavg", 0.05), ("fedavg", 0.1)]
