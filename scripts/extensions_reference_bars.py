"""Accuracy bars of ``chip_smoke.py`` phase 21's ``extensions`` suite,
measured on the JAX reference.

Runs the reference's ``benchmarks/extensions.run`` at its defaults (FedPBC
and FedPBC-M on ``bernoulli_tv`` and ``markov_nonhom``, 250 rounds, m =
100, evals every 25 rounds, one ``benchmarks/common.run_training``
trajectory per (scheme, algorithm, seed)) at seeds 0-2 on the CPU, and
prints one JSON line: per scheme and algorithm each seed's accuracy (the
mean of the last three evals, the suite's own reduction), their mean and
std (ddof 1), and the bar the port must clear, the mean less 0.05 (Table
1's convention).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/extensions_reference_bars.py
"""
from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

SEEDS = (0, 1, 2)
MARGIN = 0.05
PROTOCOL = dict(rounds=250, m=100)


def main() -> None:
    import numpy as np

    t0 = time.time()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks import extensions

    per_seed = [extensions.run(csv=False, seeds=(sd,), **PROTOCOL)
                for sd in SEEDS]
    out = {}
    for key in per_seed[0]:
        accs = [float(r[key]) for r in per_seed]
        mean = float(np.mean(accs))
        out[f"{key[0]}/{key[1]}"] = {
            "seeds": accs, "mean": mean, "std": float(np.std(accs, ddof=1)),
            "bar": mean - MARGIN}
    print(json.dumps({"extensions": out, "seeds": list(SEEDS),
                      "protocol": PROTOCOL,
                      "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
