"""The synchronous paths of one checkout on the card, hashed, so that two
checkouts (a parent and its change) can be held to each other bit for bit.

Runs ``chip_smoke.py`` phase 2's cell (the Table-1 family quartet on
bernoulli_tv, seeds 0-2, 250 rounds, m = 100, ``use_kernel=True``), Table 1
at phase 9's protocol (all seven algorithms on both Bernoulli schemes,
seeds 0-2, at the reference's ``p_base``) and one Fig. 3 ``run_one``
(fedpbc at (0.9, 0.1), seed 0, 400 rounds), with the checkout's own
``src/`` and ``chip_smoke.py``, and prints one ``COMPARE {...}`` JSON line:
per cell the seed-mean accuracy and sha256 prefixes of the test accuracy,
server params and losses, each part's aggregation launches and wall
seconds. Run it in turns from one call, one process a checkout (unpack the
other with ``git archive`` into ``build/``, which is gitignored):

    python3 scripts/compare_sync_paths.py build/parent
    python3 scripts/compare_sync_paths.py .
"""
import hashlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np


def h(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0])
    os.environ["TRITON_CACHE_DIR"] = os.path.join(tree, "build",
                                                  "triton-cache")
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.experiments import grid
    from repro_torch.kernels import masked_agg as masked
    from repro_torch.paper import fig3_quadratic, table1_accuracy

    out = {"tree": argv[0]}
    spec = grid.SweepSpec(algorithms=cs.FAMILY, schemes=("bernoulli_tv",),
                          seeds=cs.SEEDS, rounds=cs.ROUNDS,
                          eval_every=cs.EVAL_EVERY, num_clients=cs.CLIENTS,
                          use_kernel=True)
    masked.fused_masked_agg.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cells = grid.run_sweep(spec)
    torch.cuda.synchronize()
    out["phase2_s"] = time.perf_counter() - t0
    out["phase2_launches"] = masked.fused_masked_agg.launches
    out["phase2"] = {c.algo: {"acc": c.summary()["test_acc"]["mean"],
                              "test_acc": h(c.test_acc),
                              "server": h(c.server), "loss": h(c.loss)}
                     for c in cells}
    with mock.patch.object(grid, "point_base_probs", cs._reference_p_base):
        masked.fused_masked_agg.launches = 0
        t0 = time.perf_counter()
        t1 = table1_accuracy.run(seeds=cs.SEEDS, use_kernel=True)
        torch.cuda.synchronize()
        out["table1_s"] = time.perf_counter() - t0
    out["table1_launches"] = masked.fused_masked_agg.launches
    out["table1"] = {f"{s},{a}": float(v[0]) for (s, a), v in t1.items()}
    masked.fused_masked_agg.launches = 0
    t0 = time.perf_counter()
    tr = fig3_quadratic.run_one("fedpbc", 0.9, 0.1, m=50, d=50, s=20,
                                eta=5e-4, rounds=400, seed=0,
                                use_kernel=True)
    torch.cuda.synchronize()
    out["fig3_run_one_s"] = time.perf_counter() - t0
    out["fig3_launches"] = masked.fused_masked_agg.launches
    out["fig3"] = {"final": tr[-1][1],
                   "hash": h(np.asarray([d for _, d in tr], np.float64))}
    print("COMPARE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
