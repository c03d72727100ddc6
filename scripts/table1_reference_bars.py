"""Accuracy bars for the PyTorch port's smoke run, measured on the JAX reference.

Runs the JAX package's batched sweep at the Table-1 protocol that
``chip_smoke.py`` drives on the port (by default the fedpbc / fedavg /
fedavg_all / fedavg_known_p family on ``bernoulli_tv``, seeds 0-2, 250
rounds, evals every 25 rounds, m = 100, the full-width MLP: dim 32, hidden
64, 10 classes, 5 local steps of batch 32, 64 examples per client) and
prints, per algorithm, the mean over seeds of the final test accuracy (the
mean of the last three evals, ``CellResult.final_test``) and the bar the
port must clear: that mean less 0.05. ``--algos`` and ``--schemes`` widen
the grid; each scheme prints one JSON line of the same form.

``--p-base`` instead prints the Eq.-9 connection probabilities ``p_base``
that this sweep draws for seeds 0-2 at the default hyperparameter point
(``repro.experiments.grid.point_base_probs``: ``jax.random`` from
``PRNGKey(seed)``), one list of m = 100 per seed. The port draws its own
with numpy; ``chip_smoke.py`` hands it these, so that the port's Table 1
runs at the probabilities the bars were measured at.

``--fig3`` instead runs the reference's Fig.-3 quadratic counterexample
(``benchmarks/fig3_quadratic.run_one`` at its defaults: m = 50, d = 50,
s = 20, 800 rounds, eta = 5e-4, seeds 0-2) and prints, per (algorithm, p0,
p1), the final ||x_PS - x*|| of each seed with their mean and std;
``--fig3-rounds`` sets the rounds (``chip_smoke.py`` runs 400).

The reference runs its XLA aggregation path here (``use_kernel=False``);
on the CPU it is bit-for-bit equal to the Pallas kernel in interpret mode.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table1_reference_bars.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table1_reference_bars.py \\
        --algos fedpbc,fedavg,fedavg_all,fedau,f3ast,fedavg_known_p,mifa \\
        --schemes bernoulli_ti,bernoulli_tv
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table1_reference_bars.py \\
        --p-base > scripts/table1_reference_p_base.json
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table1_reference_bars.py \\
        --fig3 --fig3-rounds 400
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ALGOS = ("fedpbc", "fedavg", "fedavg_all", "fedavg_known_p")
MARGIN = 0.05
SEEDS = (0, 1, 2)
FIG3_POINTS = ((0.5, 0.5), (0.9, 0.1), (0.5, 0.1))
FIG3_PROTOCOL = dict(m=50, d=50, s=20, rounds=800, eta=5e-4)


def table1(algos, scheme) -> None:
    import jax

    from repro.experiments import SweepSpec, run_sweep

    spec = SweepSpec(algorithms=algos, schemes=(scheme,),
                     seeds=SEEDS, rounds=250, eval_every=25,
                     num_clients=100, use_kernel=False)
    t0 = time.perf_counter()
    cells = run_sweep(spec, mesh=None)
    seconds = time.perf_counter() - t0
    out = {}
    for cell in cells:
        s = cell.summary()["test_acc"]
        out[cell.algo] = {"mean": s["mean"], "std": s["std"],
                          "per_seed": cell.final_test().tolist(),
                          "bar": s["mean"] - MARGIN}
    protocol = {"scheme": scheme, "seeds": list(SEEDS), "rounds": 250,
                "eval_every": 25, "num_clients": 100}
    print(json.dumps({"reference": "jax", "backend": jax.default_backend(),
                      "protocol": protocol, "seconds": seconds,
                      "final_test_acc": out}), flush=True)


def p_base() -> None:
    import jax
    import numpy as np

    from repro.experiments import SweepSpec
    from repro.experiments.grid import point_base_probs

    spec = SweepSpec(schemes=("bernoulli_tv",), seeds=SEEDS,
                     num_clients=100)
    point = dict(alpha=spec.alpha, sigma0=spec.sigma0, delta=spec.delta)
    probs = np.asarray(point_base_probs(spec, point), np.float32)
    print(json.dumps({"reference": "jax", "backend": jax.default_backend(),
                      "protocol": dict(point, num_clients=spec.num_clients,
                                       classes=spec.classes),
                      "p_base": {str(s): [float(v) for v in row]
                                 for s, row in zip(SEEDS, probs)}}),
          flush=True)


def fig3(rounds: int) -> None:
    import jax
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.fig3_quadratic import run_one

    t0 = time.perf_counter()
    out = {}
    protocol = dict(FIG3_PROTOCOL, rounds=rounds)
    for p0, p1 in FIG3_POINTS:
        for algo in ("fedpbc", "fedavg"):
            finals = [run_one(algo, p0, p1, seed=sd, **protocol)[-1][1]
                      for sd in SEEDS]
            out[f"{algo},{p0},{p1}"] = {
                "mean": float(np.mean(finals)), "std": float(np.std(finals)),
                "per_seed": finals}
    print(json.dumps({"reference": "jax", "backend": jax.default_backend(),
                      "protocol": dict(protocol, seeds=list(SEEDS)),
                      "seconds": time.perf_counter() - t0,
                      "final_distance": out}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algos", default=",".join(ALGOS),
                    help="comma list of algorithms (default: the quartet)")
    ap.add_argument("--schemes", default="bernoulli_tv",
                    help="comma list of link schemes; one JSON line each")
    ap.add_argument("--p-base", action="store_true",
                    help="the Eq.-9 p_base of seeds 0-2 instead of Table 1")
    ap.add_argument("--fig3", action="store_true",
                    help="the Fig.-3 final distances instead of Table 1")
    ap.add_argument("--fig3-rounds", type=int,
                    default=FIG3_PROTOCOL["rounds"],
                    help="rounds of the Fig.-3 runs (default 800)")
    args = ap.parse_args(argv)
    if args.fig3:
        fig3(args.fig3_rounds)
        return
    if args.p_base:
        p_base()
        return
    for scheme in args.schemes.split(","):
        table1(tuple(args.algos.split(",")), scheme)


if __name__ == "__main__":
    main()
