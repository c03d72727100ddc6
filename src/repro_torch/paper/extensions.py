"""Beyond-paper extension: FedPBC-M (server momentum on the aggregated
direction) vs FedPBC under sparse, heterogeneous participation (port of
``benchmarks/extensions.py``). One ``run_training`` trajectory per (scheme,
algorithm, seed); with ``use_kernel`` FedPBC's server update is one launch
of the fused aggregation a round, and FedPBC-M, a stateful rule, keeps the
branch path (``dispatch.FUSED_OPS``)."""
from __future__ import annotations

import numpy as np

from repro_torch.paper.common import run_training


def run(csv=True, *, rounds=250, m=100, seeds=(0,), device=None,
        use_kernel=None):
    if csv:
        print("extensions,scheme,algo,test_acc_mean")
    out = {}
    for scheme in ("bernoulli_tv", "markov_nonhom"):
        for algo in ("fedpbc", "fedpbc_m"):
            accs = []
            for sd in seeds:
                traj, _ = run_training(algo, scheme, rounds=rounds, m=m,
                                       seed=sd, device=device,
                                       use_kernel=use_kernel)
                accs.append(np.mean([a for _, a in traj[-3:]]))
            out[(scheme, algo)] = float(np.mean(accs))
            if csv:
                print(f"extensions,{scheme},{algo},{np.mean(accs):.4f}",
                      flush=True)
    return out


if __name__ == "__main__":
    run()
