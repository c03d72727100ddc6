"""The port's paper suites (``repro_torch.paper``) and the numpy modules
behind Fig. 2 (``repro_torch.core.bias``, ``repro_torch.core.mixing``)
against the JAX reference.

- Suite outputs from identical results: ``run_sweep`` (Table 1, Table 2,
  Fig. 8) and Fig. 3's ``run_one`` are replaced, in the reference's
  ``benchmarks`` modules and in their ports, by fakes returning the same
  numbers; the printed CSV lines, the returned values and Table 2's JSON
  must then be equal (exactly: the same numbers through the same
  formatting).
- Each suite also runs for real on the CPU at a tiny size and prints the
  reference's CSV header.
- bias / mixing: the port's functions equal the reference's on seeded
  ``p``, ``u`` and active sets within rtol 1e-12 (float64 numpy in both).
- Fig. 3 on the reference's draws: the port's ``run_one`` given the ``u``
  and the link uniforms the reference draws from its own keys follows the
  reference's distance trajectory within atol 1e-5 (fp32 local steps on
  d = 4, summed in another order).
- The Eq.-9 connection probabilities ``p_base``: the port's numpy draw
  (``build_base_probs``) follows the distribution of the reference's
  ``jax.random`` draw over 300 seeds (per-seed mean and quantiles over
  clients within 4 standard errors, a two-sample KS test at 1e-3), and
  ``scripts/table1_reference_p_base.json``, which ``chip_smoke.py`` hands
  the port's Table 1, is the reference's draw for seeds 0-2.
- Eq. 3 by simulation through the port's engine (``slow``, as its
  reference ``tests/test_bias.py::test_fedavg_simulation_converges_to_eq3``).
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:        # the reference's benchmarks/ (no package)
    sys.path.insert(0, ROOT)

from benchmarks import fig2_bias as jfig2  # noqa: E402
from benchmarks import fig3_quadratic as jfig3  # noqa: E402
from benchmarks import fig8_ablations as jfig8  # noqa: E402
from benchmarks import table1_accuracy as jtable1  # noqa: E402
from benchmarks import table2_rounds_to_target as jtable2  # noqa: E402
from repro.core import bias as jbias  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.experiments import grid as jgrid  # noqa: E402
from repro.experiments import results as jres  # noqa: E402
from repro.experiments.sweep import eval_rounds  # noqa: E402
from repro_torch.core import bias as tbias  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.experiments import grid as tgrid  # noqa: E402
from repro_torch.experiments import results as tres  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.paper import fig2_bias as tfig2  # noqa: E402
from repro_torch.paper import fig3_quadratic as tfig3  # noqa: E402
from repro_torch.paper import fig8_ablations as tfig8  # noqa: E402
from repro_torch.paper import run as trun  # noqa: E402
from repro_torch.paper import table1_accuracy as ttable1  # noqa: E402
from repro_torch.paper import table2_rounds_to_target as ttable2  # noqa: E402

SUITES = {"table1": (jtable1, ttable1), "table2": (jtable2, ttable2),
          "fig8": (jfig8, tfig8), "fig3": (jfig3, tfig3),
          "fig2": (jfig2, tfig2)}
# tiny arguments the fakes run every suite at
SMALL_ARGS = {"table1": dict(rounds=50, m=8, seeds=(0, 1)),
              "table2": dict(rounds=40, m=8),
              "fig8": dict(rounds=30, m=8),
              "fig3": dict(m=6, d=3, s=2, rounds=40, eta=0.1, seeds=(0, 1)),
              "fig2": {}}


def _fake_run_sweep(CellResult):
    """A ``run_sweep`` returning seeded cells in the real one's order (the
    same numbers for either package's ``CellResult``)."""

    def run_sweep(spec, store=None, suite="sweep", **kw):
        E = len(eval_rounds(spec.rounds, spec.eval_every))
        S, K = len(spec.seeds), spec.rounds
        cells = []
        for si, scheme in enumerate(spec.schemes):
            for ai, algo in enumerate(spec.algorithms):
                for pi, pt in enumerate(spec.hparam_points()):
                    rng = np.random.default_rng([si, ai, pi])
                    cells.append(CellResult(
                        algo=algo, scheme=scheme, seeds=tuple(spec.seeds),
                        rounds=K,
                        eval_rounds=eval_rounds(K, spec.eval_every),
                        test_acc=np.sort(rng.random((S, E)),
                                         axis=1).astype(np.float32),
                        train_acc=rng.random(S).astype(np.float32),
                        loss=rng.random((S, K)).astype(np.float32),
                        num_active=rng.integers(0, spec.num_clients,
                                                (S, K)).astype(np.int32),
                        hparams=dict(pt)))
        return cells

    return run_sweep


def _fake_run_one(algo_name, p0, p1, *, m, d, s, rounds, eta, seed, **kw):
    rng = np.random.default_rng([int(100 * p0), int(100 * p1), seed,
                                 len(algo_name)])
    chunk = max(rounds // 20, 1)
    return [(t, float(v)) for t, v in zip(range(chunk, rounds + 1, chunk),
                                          rng.random(rounds // chunk))]


def _fake_run_batch(algo_name, points, *, seeds, **kw):
    """The port's ``run_batch`` on ``_fake_run_one``'s numbers."""
    return {(p0, p1): [_fake_run_one(algo_name, p0, p1, seed=sd, **kw)
                       for sd in seeds] for p0, p1 in points}


def _run_suite(name, pkg, monkeypatch, capsys, tmp_path):
    """``(stdout lines, returned value, Table 2's JSON or None)`` of one
    package's suite on the fakes."""
    mod = SUITES[name][pkg == "port"]
    kw = dict(SMALL_ARGS[name], csv=True)
    res = tres if pkg == "port" else jres
    if name in ("table1", "table2", "fig8"):
        CellResult = (tgrid if pkg == "port" else jgrid).CellResult
        monkeypatch.setattr(mod, "run_sweep", _fake_run_sweep(CellResult))
        kw["store"] = res.ResultsStore(str(tmp_path / pkg / "store"))
    if name == "fig3":
        monkeypatch.setattr(mod, "run_one", _fake_run_one)
        if pkg == "port":
            monkeypatch.setattr(mod, "run_batch", _fake_run_batch)
    out_path = None
    if name == "table2":
        out_path = str(tmp_path / pkg / "table2.json")
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
    port = _run_suite(name, "port", monkeypatch, capsys, tmp_path)
    assert len(ref[0]) > 1
    assert port[0] == ref[0]
    if name == "fig3":
        assert port[1].keys() == ref[1].keys()
        for k in ref[1]:
            assert port[1][k] == ref[1][k]
    else:
        assert port[1] == ref[1]
    assert port[2] == ref[2]
    if name == "table2":
        bench = [ln for ln in port[0] if ln.startswith("BENCH ")]
        assert len(bench) == 1
        assert json.loads(bench[0][6:]) == port[2]


# tiny real runs on the CPU: (suite, keyword arguments)
CPU_RUNS = {
    "table1": dict(schemes=("bernoulli_tv",), algos=("fedpbc", "fedau"),
                   rounds=2, m=8),
    "table2": dict(algos=("fedavg", "mifa"), rounds=3, m=8),
    "fig8": dict(rounds=2, m=8),
    "fig3": dict(m=6, d=3, s=2, rounds=4, seeds=(0,)),
    "fig2": {},
}


@pytest.mark.parametrize("name", list(CPU_RUNS))
def test_suite_runs_on_the_cpu_with_the_reference_header(
        name, monkeypatch, capsys, tmp_path):
    want = _run_suite(name, "ref", monkeypatch, capsys, tmp_path)[0][0]
    mod = SUITES[name][1]
    kw = dict(CPU_RUNS[name])
    if name != "fig2":
        kw.update(device="cpu")
    if name in ("table1", "table2", "fig8"):
        store = tres.ResultsStore(str(tmp_path / "store"))
        kw["store"] = store
    if name == "table2":
        kw["out_path"] = str(tmp_path / "t2.json")
    capsys.readouterr()
    mod.run(**kw)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == want
    if name in ("table1", "table2", "fig8"):
        n = {"table1": 2, "table2": 2, "fig8": 20}[name]
        assert len(store.records()) == n
        assert all(np.isfinite(r["summary"]["test_acc"]["mean"])
                   for r in store.records())


def test_run_lists_exactly_the_five_paper_suites(capsys):
    """The port's driver lists the reference's 13 suites, in its order and
    with its BENCH arms (``benchmarks/run.py``'s ``SUITE_INFO``)."""
    from benchmarks import run as jrun

    assert list(trun.SUITE_INFO) == list(jrun.SUITE_INFO)
    assert {k: v[1] for k, v in trun.SUITE_INFO.items()} == \
        {k: v[1] for k, v in jrun.SUITE_INFO.items()}
    trun.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(jrun.SUITE_INFO)
    assert [ln.partition("[arms: ")[2] for ln in lines] == [
        (", ".join(arms) + "]") if arms else ""
        for _, arms in jrun.SUITE_INFO.values()]
    with pytest.raises(SystemExit):
        trun.main(["--only", "fig2,nope"])
    trun.main(["--only", "fig2"])
    assert "fig2_bias,p2,E_x_fedavg" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# bias / mixing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 3, 5, 7])
def test_bias_functions_match_reference(m):
    rng = np.random.default_rng(m)
    p = rng.uniform(0.05, 0.95, size=m)
    u = rng.normal(size=(m, 3))
    for fn in ("fedavg_fixed_point", "fedavg_fixed_point_series"):
        np.testing.assert_allclose(getattr(tbias, fn)(p, u),
                                   getattr(jbias, fn)(p, u), rtol=1e-12)
    np.testing.assert_allclose(tbias.fedavg_client_weights(p),
                               jbias.fedavg_client_weights(p), rtol=1e-12)
    np.testing.assert_allclose(
        tbias.two_client_fixed_point(u[0], u[1], p[0], p[1]),
        jbias.two_client_fixed_point(u[0], u[1], p[0], p[1]), rtol=1e-12)


@pytest.mark.parametrize("m", [3, 6])
def test_mixing_functions_match_reference(m):
    rng = np.random.default_rng(10 + m)
    p = rng.uniform(0.1, 0.9, size=m)
    for _ in range(5):
        active = rng.random(m) < 0.5
        np.testing.assert_allclose(tmixing.mixing_matrix(active),
                                   jmixing.mixing_matrix(active), rtol=1e-12)
    M = tmixing.expected_w2(p)
    np.testing.assert_allclose(M, jmixing.expected_w2(p), rtol=1e-12)
    np.testing.assert_allclose(tmixing.expected_w2_mc(p, 50, seed=3),
                               jmixing.expected_w2_mc(p, 50, seed=3),
                               rtol=1e-12)
    assert tmixing.rho_of(M) == pytest.approx(jmixing.rho_of(M), rel=1e-12)
    for c in (0.1, 0.5):
        assert tmixing.lemma3_general_bound(c, m) == \
            jmixing.lemma3_general_bound(c, m)
    assert tmixing.lemma3_uniform_bound(2, m) == \
        jmixing.lemma3_uniform_bound(2, m)
    xs = rng.normal(size=(m, 4))
    want = jmixing.consensus_error(xs)
    assert tmixing.consensus_error(xs) == pytest.approx(want, rel=1e-12)
    # a FedState-style [m, n] client buffer, fp64 and fp32
    assert tmixing.consensus_error(torch.as_tensor(xs)) == \
        pytest.approx(want, rel=1e-12)
    assert tmixing.consensus_error(torch.as_tensor(xs, dtype=torch.float32)) \
        == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# Fig. 3 on the reference's draws
# ---------------------------------------------------------------------------


class _ReferenceLinkDraws:
    """The link uniforms the reference's fig3 ``run_one`` draws from
    ``PRNGKey(seed + 1)`` (its ``init_fed_state`` key): the initial draw,
    then one ``[m]`` uniform a round; no data draw (fixed source)."""

    def __init__(self, seed, m, rounds):
        k_link, key = jax.random.split(jax.random.PRNGKey(seed + 1))
        self._init = torch.as_tensor(np.array(
            jax.random.uniform(k_link, (m,))))[None]
        self._u = []
        for _ in range(rounds):
            key, k_round = jax.random.split(key)
            self._u.append(torch.as_tensor(np.array(
                jax.random.uniform(k_round, (m,))))[None])

    def link_init(self):
        return self._init

    def __call__(self, t):
        return tfed.RoundDraws(self._u[t])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("algo", ["fedpbc", "fedavg"])
def test_fig3_run_one_on_reference_draws_matches_reference(algo, use_kernel):
    m, d, s, rounds, eta, seed = 8, 4, 3, 20, 0.05, 0
    u = np.array((jnp.arange(m) / (10.0 * m))[:, None]
                   + 0.1 * jax.random.normal(jax.random.PRNGKey(seed),
                                             (m, d)))
    kw = dict(m=m, d=d, s=s, rounds=rounds, eta=eta, seed=seed)
    want = jfig3.run_one(algo, 0.9, 0.1, **kw)
    got = tfig3.run_one(algo, 0.9, 0.1, device="cpu", use_kernel=use_kernel,
                        u=u, draws=_ReferenceLinkDraws(seed, m, rounds), **kw)
    assert [t for t, _ in got] == [t for t, _ in want] == list(range(1, 21))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-5)
    assert want[-1][1] < 0.9 * want[0][1]        # the trajectory moved


@pytest.mark.parametrize("algo", ["fedpbc", "fedavg"])
def test_fig3_run_batch_matches_run_one_per_trajectory(algo):
    """``run_batch`` (every point and seed of one algorithm in one batch)
    gives each trajectory what ``run_one`` gives it, bit for bit on the
    CPU."""
    kw = dict(m=6, d=3, s=2, rounds=40, eta=0.1)
    seeds = (0, 1)
    got = tfig3.run_batch(algo, tfig3.POINTS, seeds=seeds, device="cpu",
                          use_kernel=True, **kw)
    assert list(got) == list(tfig3.POINTS)
    for (p0, p1), rows in got.items():
        assert len(rows) == len(seeds)
        for sd, row in zip(seeds, rows):
            want = tfig3.run_one(algo, p0, p1, seed=sd, device="cpu",
                                 use_kernel=True, **kw)
            assert row == want


def _p_stats(p):
    """Per-seed statistics of ``p [S, m]``: mean, 10/50/90 % quantiles over
    clients, share clipped at delta."""
    return np.stack([p.mean(1), *np.quantile(p, [0.1, 0.5, 0.9], axis=1),
                     (p <= 0.02 + 1e-7).mean(1)], axis=1)


def test_base_probs_follow_the_reference_distribution():
    from scipy import stats

    from repro.core.connectivity import build_base_probs as jbuild
    from repro_torch.core.connectivity import build_base_probs as tbuild

    S, m, classes = 300, 100, 10          # the Table-1 point's draw
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(S))
    jp = np.asarray(jax.vmap(lambda k: jbuild(k, m, classes)[0])(keys))
    tp = np.stack([tbuild(s, m, classes)[0] for s in range(S)])
    js, ts = _p_stats(jp), _p_stats(tp)
    diff = np.abs(js.mean(0) - ts.mean(0))
    se = np.sqrt(js.var(0, ddof=1) / S + ts.var(0, ddof=1) / S)
    assert (diff <= 4 * se + 1e-7).all(), (diff, se)
    assert stats.ks_2samp(js[:, 0], ts[:, 0]).pvalue > 1e-3


def test_reference_p_base_file_is_the_reference_draw():
    with open(os.path.join(ROOT, "scripts",
                           "table1_reference_p_base.json")) as f:
        data = json.load(f)
    spec = jgrid.SweepSpec(schemes=("bernoulli_tv",), seeds=(0, 1, 2),
                           num_clients=data["protocol"]["num_clients"])
    point = {k: data["protocol"][k] for k in ("alpha", "sigma0", "delta")}
    assert point == dict(alpha=spec.alpha, sigma0=spec.sigma0,
                         delta=spec.delta)
    want = np.asarray(jgrid.point_base_probs(spec, point), np.float32)
    got = np.asarray([data["p_base"][str(s)] for s in spec.seeds],
                     np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_fedavg_simulation_converges_to_eq3():
    """Port of ``tests/test_bias.py``'s: Monte-Carlo FedAvg on quadratics
    through the port's engine lands on Eq. (3), not on x*."""
    from repro_torch.configs import FederationConfig
    from repro_torch.core import algorithms as talg
    from repro_torch.core import connectivity as tconn
    from repro_torch.data import fixed_source
    from repro_torch.experiments.sweep import seed_generators
    from repro_torch.optim import sgd

    m, d, s = 6, 4, 30
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32)
    p = np.linspace(0.15, 0.9, m)
    fed = FederationConfig(algorithm="fedavg", num_clients=m, local_steps=s)
    algo = talg.make_algorithm(fed)
    link = tconn.make_link_process(torch.as_tensor(p, dtype=torch.float32)[None],
                                   fed)
    opt = sgd(0.02)
    source = fixed_source({"u": u[:, None].expand(m, s, d)})
    run_rounds = tfed.make_run_rounds(
        lambda x, b: 0.5 * ((x - b["u"]) ** 2).sum(-1), opt, algo, link, fed,
        source, metric_keys=(), device="cpu")
    draws = tfed.GeneratorDraws([seed_generators(0)], num_clients=m)
    st = tfed.init_fed_state(draws.link_init(), torch.zeros(1, d), fed, algo,
                             link, opt)
    ds = source.init()
    st, ds, _ = run_rounds(st, ds, draws, 2001)
    tail = []
    for _ in range(999):
        st, ds, _ = run_rounds(st, ds, draws, 1)
        tail.append(st.server[0].numpy().copy())
    avg_tail = np.mean(tail, 0)
    eq3 = tbias.fedavg_fixed_point(p, u.numpy())
    x_star = u.numpy().mean(0)
    assert np.linalg.norm(avg_tail - eq3) < \
        0.35 * np.linalg.norm(avg_tail - x_star)
