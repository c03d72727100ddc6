"""Fig. 8 ablations: impact of alpha (data heterogeneity), gamma (p_i^t
fluctuation), delta (p_i floor), sigma0 (class-weight spread) on FedPBC and
FedAvg under Bernoulli time-varying links (port of
``benchmarks/fig8_ablations.py``).

Each swept parameter is ONE ``SweepSpec`` whose hyperparameter axis carries
all the values: every (algorithm x value x seed) trajectory of an ablation
runs as one batch (fedpbc and fedavg share a family), its server update one
launch of the fused kernel a round with ``use_kernel``."""
from __future__ import annotations

import dataclasses

from repro_torch.experiments import SweepSpec, run_sweep

SWEEPS = {
    "alpha": [0.1, 1.0],
    "gamma": [0.1, 0.5, 0.9],
    "delta": [0.001, 0.02, 0.1],
    "sigma0": [1.0, 10.0],
}


def run(csv=True, *, rounds=200, m=100, algos=("fedpbc", "fedavg"), seed=0,
        store=None, device=None, use_kernel=None):
    if csv:
        print("fig8,param,value,algo,test_acc")
    base = SweepSpec(algorithms=tuple(algos), schemes=("bernoulli_tv",),
                     seeds=(seed,), rounds=rounds,
                     eval_every=min(25, rounds), num_clients=m,
                     use_kernel=use_kernel)
    out = {}
    for param, values in SWEEPS.items():
        # the axis field for a scalar knob is its plural (SweepSpec naming)
        spec = dataclasses.replace(base, **{param + "s": tuple(values)})
        for cell in run_sweep(spec, store=store, suite=f"fig8_{param}",
                              device=device):
            v = cell.hparams[param]
            acc = float(cell.final_test().mean())
            out[(param, v, cell.algo)] = acc
            if csv:
                print(f"fig8,{param},{v},{cell.algo},{acc:.4f}",
                      flush=True)
    return out


if __name__ == "__main__":
    run()
