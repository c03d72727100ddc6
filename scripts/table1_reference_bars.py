"""Accuracy bars for the PyTorch port's smoke run, measured on the JAX reference.

Runs the JAX package's batched sweep at the Table-1 protocol that
``chip_smoke.py`` drives on the port (the fedpbc / fedavg / fedavg_all /
fedavg_known_p family on ``bernoulli_tv``, seeds 0-2, 250 rounds, evals every
25 rounds, m = 100, the full-width MLP: dim 32, hidden 64, 10 classes,
5 local steps of batch 32, 64 examples per client) and prints, per
algorithm, the mean over seeds of the final test accuracy (the mean of the
last three evals, ``CellResult.final_test``) and the bar the port must clear:
that mean less 0.05.

The reference runs its XLA aggregation path here (``use_kernel=False``);
on the CPU it is bit-for-bit equal to the Pallas kernel in interpret mode.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/table1_reference_bars.py
"""
from __future__ import annotations

import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ALGOS = ("fedpbc", "fedavg", "fedavg_all", "fedavg_known_p")
MARGIN = 0.05


def main() -> None:
    import jax

    from repro.experiments import SweepSpec, run_sweep

    spec = SweepSpec(algorithms=ALGOS, schemes=("bernoulli_tv",),
                     seeds=(0, 1, 2), rounds=250, eval_every=25,
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
    print(json.dumps({"reference": "jax", "backend": jax.default_backend(),
                      "protocol": {"scheme": "bernoulli_tv",
                                   "seeds": [0, 1, 2], "rounds": 250,
                                   "eval_every": 25, "num_clients": 100},
                      "seconds": seconds, "final_test_acc": out}))


if __name__ == "__main__":
    main()
