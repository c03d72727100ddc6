"""Table 2: first round to reach 1/4, 1/2, 3/4, 1 of the best test accuracy
under Bernoulli time-varying links (port of
``benchmarks/table2_rounds_to_target.py``).

The per-round eval trajectory comes from the batched sweep's eval cadence
(``evals [S, E]`` at ``eval_rounds`` boundaries), so the 7-algorithm column
runs as 4 batches (the quartet, fedau, f3ast, mifa).

Besides the CSV view, ``run`` emits a machine-readable rounds-to-target
baseline — a ``BENCH {...}`` JSON line with the reference's keys, also
written to ``out_path`` (default ``build/paper/table2_rounds_to_target.json``)
— with the absolute accuracy targets and the first round each algorithm
reached them.
"""
from __future__ import annotations

import json
import os

from repro_torch.experiments import SweepSpec, run_sweep
from repro_torch.experiments.grid import ALGOS
from repro_torch.paper import OUT_DIR

OUT_PATH = os.path.join(OUT_DIR, "table2_rounds_to_target.json")


def run(csv=True, *, rounds=300, m=100, algos=ALGOS, seed=0, store=None,
        out_path=OUT_PATH, device=None, use_kernel=None):
    spec = SweepSpec(algorithms=tuple(algos), schemes=("bernoulli_tv",),
                     seeds=(seed,), rounds=rounds,
                     eval_every=min(10, rounds), num_clients=m,
                     use_kernel=use_kernel)
    cells = run_sweep(spec, store=store, suite="table2", device=device)
    trajs = {c.algo: list(zip(c.eval_rounds, c.test_acc.mean(axis=0)))
             for c in cells}
    best = max(a for tr in trajs.values() for _, a in tr)
    fractions = (0.25, 0.5, 0.75, 1.0)
    targets = [best * f for f in fractions]
    if csv:
        print("table2,algo,q25_round,q50_round,q75_round,q100_round,best_acc")
    firsts_by_algo = {}
    for algo, tr in trajs.items():
        firsts = []
        for tgt in targets:
            hit = next((r for r, a in tr if a >= tgt - 1e-9), None)
            firsts.append(int(hit) if hit is not None else -1)
        firsts_by_algo[algo] = firsts
        if csv:
            print(f"table2,{algo},{firsts[0]},{firsts[1]},{firsts[2]},"
                  f"{firsts[3]},{best:.4f}", flush=True)
    result = {
        "bench": "table2_rounds_to_target",
        "m": m,
        "rounds": rounds,
        "seeds": [seed],
        "scheme": "bernoulli_tv",
        "eval_every": min(10, rounds),
        "algos": list(algos),
        "best_acc": float(best),
        "fractions": list(fractions),
        "targets": [float(t) for t in targets],
        # first eval round at which each algorithm's seed-mean trajectory
        # reached each target (-1: never within the budget)
        "rounds_to_target": firsts_by_algo,
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
    return result


if __name__ == "__main__":
    run()
