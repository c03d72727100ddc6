"""Table 1: final train/test accuracy of all 7 algorithms under the six
unreliable-uplink schemes (synthetic stand-in dataset; port of
``benchmarks/table1_accuracy.py``).

Runs on the port's batched sweep: every state-compatible group of
algorithms of one scheme (the empty-state quartet, then fedau, f3ast and
mifa alone) runs as one batch of trajectories, the quartet's server update
one launch of the fused kernel a round with ``use_kernel``. Results append
to the JSONL/npz store under ``build/paper/sweeps`` with their
hyperparameter coordinates recorded (CSV stays as the console view).

Default: 2 schemes x 7 algos x 1 seed at 250 rounds; --full runs all 6
schemes x 3 seeds."""
from __future__ import annotations

import os

from repro_torch.experiments import ResultsStore, SweepSpec, run_sweep
from repro_torch.experiments.grid import ALGOS, SCHEMES
from repro_torch.paper import OUT_DIR


def _default_store():
    return ResultsStore(os.path.join(OUT_DIR, "sweeps"))


def run(csv=True, *, schemes=("bernoulli_ti", "bernoulli_tv"),
        algos=ALGOS, rounds=250, m=100, seeds=(0,), store=None, device=None,
        use_kernel=None):
    if store is None:
        store = _default_store()
    spec = SweepSpec(algorithms=tuple(algos), schemes=tuple(schemes),
                     seeds=tuple(seeds), rounds=rounds,
                     eval_every=min(25, rounds), num_clients=m,
                     use_kernel=use_kernel)
    if csv:
        print("table1,scheme,algo,test_acc_mean,test_acc_std,train_acc")
    results = {}
    for cell in run_sweep(spec, store=store, suite="table1", device=device):
        # same summarize() reduction the store records (ddof=1 std), so the
        # CSV view and the JSONL summary agree
        s = cell.summary()
        mean, std = s["test_acc"]["mean"], s["test_acc"]["std"]
        results[(cell.scheme, cell.algo)] = (mean, std)
        if csv:
            print(f"table1,{cell.scheme},{cell.algo},{mean:.4f},"
                  f"{std:.4f},{s['train_acc']['mean']:.4f}", flush=True)
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rounds", type=int, default=250)
    a = ap.parse_args()
    if a.full:
        run(schemes=tuple(SCHEMES), rounds=max(a.rounds, 400), seeds=(0, 1, 2))
    else:
        run(rounds=a.rounds)
