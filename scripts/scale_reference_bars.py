"""Accuracy and commit bars of ``chip_smoke.py`` phase 10, measured on the
JAX reference.

Runs ``benchmarks/scale.py``'s protocol (``benchmarks.scale._spec``: fedpbc
over ``bernoulli_ti``, a C = 256 cohort, the arms ``sync_cohort`` and
``buffered`` with a buffer of 128 and a deadline of 4 rounds, 30 rounds
with one eval at the end, 2 local steps of batch 16, MLP 32 / 32 / 10,
200 examples a class, 1,600 training examples, 32 a client) through the
reference's ``run_cell_batch`` for seeds 0-2 at m = 1,000, 10,000 and
50,000, and prints one JSON line: per m and arm the final test accuracy of
each seed with their mean and std (ddof 1), the buffered arm's commits per
seed and mean commit staleness per seed, and the mean Eq.-9 ``p_base`` of
each seed. The reference runs on the CPU (~1 min).

``--stateful`` instead runs phase 10's stateful cohort cell (fedau, mifa
and f3ast at m = 10,000, C = 256, the synchronous strategy, seed 0, the
same protocol otherwise) and prints each algorithm's final test accuracy.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/scale_reference_bars.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/scale_reference_bars.py \
        --stateful
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

SEEDS = (0, 1, 2)
MS = (1_000, 10_000, 50_000)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", default=",".join(map(str, MS)),
                    help="comma list of client counts")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--stateful", action="store_true",
                    help="the stateful cohort cell instead of the ladder")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.scale import METRIC_KEYS, SCHEME, _spec
    from repro.experiments import run_cell_batch, run_sweep
    from repro.experiments.grid import seed_base_probs
    from repro.scale import SYNC

    out = {}
    t0 = time.perf_counter()
    if args.stateful:
        spec = dataclasses.replace(
            _spec(10_000, cohort=256, rounds=args.rounds, seeds=(0,)),
            algorithms=("fedau", "mifa", "f3ast"), strategies=(SYNC,))
        for cell in run_sweep(spec, mesh=None):
            out[cell.algo] = float(cell.test_acc[0, -1])
        print(json.dumps({"reference": "jax",
                          "backend": jax.default_backend(),
                          "protocol": {"scheme": SCHEME, "seeds": [0],
                                       "num_clients": 10_000, "cohort": 256,
                                       "rounds": args.rounds},
                          "seconds": time.perf_counter() - t0,
                          "final_test_acc": out}), flush=True)
        return
    for m in (int(v) for v in args.ms.split(",")):
        spec = _spec(m, cohort=256, rounds=args.rounds, seeds=SEEDS)
        cells = run_cell_batch(spec, "fedpbc", SCHEME,
                               metric_keys=METRIC_KEYS, mesh=None)
        row = {"mean_p_base": np.asarray(seed_base_probs(spec)).mean(
            axis=1).tolist()}
        for cell in cells:
            acc = cell.test_acc[:, -1].astype(np.float64)
            arm = {"per_seed": acc.tolist(), "mean": float(acc.mean()),
                   "std": float(acc.std(ddof=1))}
            commit = np.asarray(cell.commit, np.float64)
            stale = np.asarray(cell.commit_staleness, np.float64)
            n = commit.sum(axis=1)
            arm["commits_per_seed"] = n.tolist()
            arm["mean_commit_staleness_per_seed"] = (
                (stale * commit).sum(axis=1) / np.maximum(n, 1.0)).tolist()
            row[cell.strategy] = arm
        out[str(m)] = row
    protocol = {"scheme": SCHEME, "seeds": list(SEEDS), "rounds": args.rounds,
                "cohort": 256, "buffer_size": 128, "deadline_rounds": 4}
    print(json.dumps({"reference": "jax", "backend": jax.default_backend(),
                      "protocol": protocol,
                      "seconds": time.perf_counter() - t0,
                      "final_test_acc": out}), flush=True)


if __name__ == "__main__":
    main()
