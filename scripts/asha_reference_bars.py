"""Bars of ``chip_smoke.py`` phase 11(b), measured on the JAX reference.

Runs the reference's ASHA-vs-grid suite, ``benchmarks.asha.run(csv=False,
out_path=None)``, at its own defaults (fedpbc over ``bernoulli_tv``, 64
rounds, m = 16, seeds 0 and 1, the 8 lrs 0.005-0.5, rung 8, eta 2, 4
points a batch) on the CPU, and prints one JSON line: the grid's and
ASHA's best accuracy and device rounds, the q75 target, ASHA's statuses,
waves and wave log, the per-seed final accuracy of every grid point (the
mean of its last 3 evals, the window the suite ranks on) and of ASHA's best
candidate (its last eval), and the reference's Eq.-9 ``p_base`` of seeds
0 and 1 at m = 16 (the baseline's seed 0 among them). Table 2's baseline
JSON is not written (the suite's ``benchmarks/out/`` stays as it is).
About half a minute.

``--spread`` instead runs the suite's grid arm (the same protocol and 8
lrs) at seeds 0-9 and prints each lr's per-seed final accuracies, their
mean and std (ddof 1), the std of the last eval alone (what ASHA ranks
on), and the reference's ``p_base`` of those seeds: the protocol's seed
spread, which two seeds cannot show.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/asha_reference_bars.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/asha_reference_bars.py \
        --spread > scripts/asha_reference_spread.json
"""
from __future__ import annotations

import json
import os
import sys
import time
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")


SPREAD_SEEDS = tuple(range(10))


def spread() -> None:
    """The grid arm at seeds 0-9: per lr, the per-seed final accuracies."""
    import dataclasses

    import jax
    import numpy as np

    from benchmarks import asha
    from repro.experiments import SweepSpec, run_cell_batch
    from repro.experiments.grid import point_base_probs

    spec = SweepSpec(algorithms=(asha.ALGO,), schemes=(asha.SCHEME,),
                     seeds=SPREAD_SEEDS, rounds=64, eval_every=8,
                     num_clients=16, lrs=asha.LRS)
    t0 = time.perf_counter()
    cells = run_cell_batch(spec, asha.ALGO, asha.SCHEME, mesh=None)
    point = dict(alpha=spec.alpha, sigma0=spec.sigma0, delta=spec.delta)
    p_base = np.asarray(point_base_probs(dataclasses.replace(spec, lrs=()),
                                         point))
    per_lr = {}
    for c in cells:
        acc = c.test_acc[:, -3:].mean(axis=1).astype(np.float64)
        last = c.test_acc[:, -1].astype(np.float64)
        per_lr[str(c.hparams["lr"])] = {
            "per_seed": acc.tolist(), "mean": float(acc.mean()),
            "std": float(acc.std(ddof=1)),
            "last_eval_std": float(last.std(ddof=1))}
    print(json.dumps({
        "reference": "jax", "backend": jax.default_backend(),
        "protocol": {"algo": asha.ALGO, "scheme": asha.SCHEME, "m": 16,
                     "rounds": 64, "eval_every": 8,
                     "seeds": list(SPREAD_SEEDS), "lrs": list(asha.LRS),
                     **point},
        "seconds": time.perf_counter() - t0,
        "final_test_acc": per_lr,
        "p_base": {str(s): p.astype(float).tolist()
                   for s, p in zip(SPREAD_SEEDS, p_base)}}), flush=True)


def main() -> None:
    import jax
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if "--spread" in sys.argv[1:]:
        return spread()
    from benchmarks import asha, table2_rounds_to_target
    from repro.experiments.grid import point_base_probs

    captured = {}
    real_cells, real_search = asha.run_cell_batch, asha.run_search

    def cells(*a, **kw):
        captured["grid"] = real_cells(*a, **kw)
        return captured["grid"]

    def search(s, **kw):
        captured["search"] = (s, real_search(s, **kw))
        return captured["search"][1]

    t0 = time.perf_counter()
    with mock.patch.object(asha, "run_cell_batch", cells), \
            mock.patch.object(asha, "run_search", search), \
            mock.patch.object(table2_rounds_to_target, "OUT_PATH", None):
        res = asha.run(csv=False, out_path=None)
    seconds = time.perf_counter() - t0
    spec, outcome = captured["search"]
    best = outcome.best
    proto = res["protocol"]
    point = dict(alpha=spec.base.alpha, sigma0=spec.base.sigma0,
                 delta=spec.base.delta)
    p_base = np.asarray(point_base_probs(spec.base, point))
    print(json.dumps({
        "reference": "jax", "backend": jax.default_backend(),
        "protocol": dict(proto, **point),
        "seconds": seconds,
        "target_q75": res["baseline"]["target_q75"],
        "grid": {"best_acc": res["grid"]["best_acc"],
                 "device_rounds": res["grid"]["device_rounds"],
                 "per_seed_final": {
                     str(c.hparams["lr"]): c.test_acc[:, -3:].mean(
                         axis=1).astype(float).tolist()
                     for c in captured["grid"]}},
        "asha": {"best_acc": res["asha"]["best_acc"],
                 "device_rounds": res["asha"]["device_rounds"],
                 "waves": res["asha"]["waves"],
                 "wave_log": res["asha"]["wave_log"],
                 "statuses": res["asha"]["statuses"],
                 "best_lr": best.point["lr"],
                 "best_per_seed_final": np.asarray(
                     best.test_acc[-1], float).tolist()},
        "resume_max_abs_diff": res["resume_max_abs_diff"],
        "p_base": {str(s): p.astype(float).tolist()
                   for s, p in zip(spec.base.seeds, p_base)},
    }), flush=True)


if __name__ == "__main__":
    main()
