"""Accuracy bars of ``chip_smoke.py`` phase 12(b), measured on the JAX
reference.

Runs the ``lm_family`` arm of ``benchmarks/lm_sweep.py`` in its full mode
(``run``: the quartet fedpbc / fedavg / fedavg_all / fedavg_known_p over
``bernoulli_ti``, lrs 0.05 and 0.1, m = 4, 2 local steps of batch 2, 16
sequences a client, ``reduced(smollm-135m)`` at d_model 64 and 2 layers,
sequences of 32, 4 corpus styles, 256 training and 64 test sequences, 10
rounds with evals every 5) through the reference's ``run_sweep`` at seeds
0-2, and prints one JSON line: per member and lr the final test accuracy
of each seed (``CellResult.final_test``, the mean of the last evals),
their mean and std (ddof 1), and each seed's mean training loss over the
clients in the last round (for reading beside the accuracies, which lie
near chance, 1/512, after 10 rounds). The reference runs on the CPU
(~20 s).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_sweep_reference_bars.py
"""
from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

SEEDS = (0, 1, 2)
LRS = (0.05, 0.1)


def protocol(rounds: int = 10) -> dict:
    """The ``lm_family`` arm's ``SweepSpec`` fields (``benchmarks/
    lm_sweep.py``'s full mode) at seeds 0-2."""
    return dict(algorithms=("fedpbc", "fedavg", "fedavg_all",
                            "fedavg_known_p"), schemes=("bernoulli_ti",),
                seeds=SEEDS, rounds=rounds, eval_every=max(rounds // 2, 1),
                num_clients=4, local_steps=2, batch_size=2, per_client=16,
                lrs=LRS, task="lm", lm_d_model=64, lm_layers=2, lm_seq=32,
                classes=4, lm_n_seqs=256, lm_n_test=64)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from repro.experiments import SweepSpec, run_sweep

    t0 = time.perf_counter()
    kw = protocol(args.rounds)
    out = {}
    for cell in run_sweep(SweepSpec(**kw), metric_keys=("loss",), mesh=None):
        acc = cell.final_test().astype(np.float64)
        out.setdefault(cell.algo, {})[str(cell.hparams["lr"])] = {
            "per_seed": acc.tolist(), "mean": float(acc.mean()),
            "std": float(acc.std(ddof=1)),
            "final_loss_per_seed": cell.loss[:, -1].astype(
                np.float64).tolist()}
    print(json.dumps({"reference": "jax", "backend": jax.default_backend(),
                      "protocol": {k: list(v) if isinstance(v, tuple) else v
                                   for k, v in kw.items()},
                      "seconds": time.perf_counter() - t0,
                      "final_test_acc": out}), flush=True)


if __name__ == "__main__":
    main()
