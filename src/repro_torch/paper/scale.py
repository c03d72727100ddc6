"""Cross-device scale: cohort-subsampled buffered aggregation vs m (port of
``benchmarks/scale.py``).

The reference's workload of ``repro_torch.scale``: a FedPBC cell at m in
{1k, 10k, 50k} clients with a C = 256 cohort a round and a (sync,
buffered) strategy pair, the two arms as one batch through one runner
(the strategy knobs are per-trajectory columns), O(C) client memory a
round (no ``[B, m, n]`` client tensor: ``FedState.clients`` is ``[B, 0,
n]``). A cohort round aggregates through the buffer fold, so the fused
aggregation launches nothing here, with ``use_kernel`` or without.

Per m the suite reports cold (the first call: the task's dataset and
partition built, the card's first launches) and warm wall seconds,
rounds/s, the buffered arm's commits and mean per-commit staleness, and
both arms' final test accuracy. The reference reads XLA's jit caches
for ``compile_entries``; the eager port compiles nothing, so it reports
-1, the reference's value where no cache can be read. Prints a ``BENCH
{...}`` JSON line and writes ``build/paper/scale.json`` (or
``out_path``).

  python -m repro_torch.paper.scale             # full m ladder
  python -m repro_torch.paper.scale --smoke     # m=10k, few rounds
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.experiments import SweepSpec, run_cell_batch
from repro_torch.paper import OUT_DIR
from repro_torch.paper.common import backend_name, timed
from repro_torch.scale import BUFFER_METRIC_KEYS, Strategy

METRIC_KEYS = ("loss", "num_active") + BUFFER_METRIC_KEYS
SCHEME = "bernoulli_ti"


def _spec(m: int, *, cohort: int, rounds: int, seeds,
          use_kernel=None) -> SweepSpec:
    buffered = Strategy("buffered", buffer_size=max(cohort // 2, 1),
                        deadline_rounds=4)
    return SweepSpec(
        algorithms=("fedpbc",), schemes=(SCHEME,), seeds=tuple(seeds),
        rounds=rounds, eval_every=rounds,        # one eval at the end
        num_clients=m, cohort_size=min(cohort, m),
        strategies=(Strategy("sync_cohort"), buffered),
        local_steps=2, batch_size=16, dim=32, hidden=32,
        n_per_class=200, n_train=1600, per_client=32,
        use_kernel=use_kernel)


def _bench_m(m: int, *, cohort: int, rounds: int, seeds, device=None,
             use_kernel=None) -> dict:
    dev = resolve_device(device)
    spec = _spec(m, cohort=cohort, rounds=rounds, seeds=seeds,
                 use_kernel=use_kernel)
    C = spec.cohort_size

    def cell():
        return run_cell_batch(spec, "fedpbc", SCHEME,
                              metric_keys=METRIC_KEYS, mesh=None, device=dev)

    cold_s, cells = timed(cell, dev)
    warm_s, cells = timed(cell, dev)

    sync_c, buf_c = cells
    commits = np.asarray(buf_c.commit)
    stale = np.asarray(buf_c.commit_staleness)
    n_commits = commits.sum(axis=1)
    mean_stale = float(
        ((stale * commits).sum(axis=1) / np.maximum(n_commits, 1.0)).mean())
    n_traj = len(spec.seeds) * len(spec.strategies)
    return {
        "m": m,
        "cohort": C,
        "rounds": rounds,
        "n_seeds": len(spec.seeds),
        "strategies": [s.name for s in spec.strategies],
        "buffer_size": spec.strategies[1].buffer_size,
        "deadline_rounds": spec.strategies[1].deadline_rounds,
        "cold_seconds": round(cold_s, 4),
        "warm_seconds": round(warm_s, 4),
        "warm_rounds_per_s": round(n_traj * rounds / warm_s, 2),
        "compile_entries": -1,
        "commits_per_seed": [float(x) for x in n_commits],
        "mean_commit_staleness": round(mean_stale, 4),
        "final_test_acc_sync": round(float(sync_c.test_acc[:, -1].mean()), 4),
        "final_test_acc_buffered":
            round(float(buf_c.test_acc[:, -1].mean()), 4),
    }


def run(csv=True, *, ms=(1_000, 10_000, 50_000), cohort=256, rounds=30,
        seeds=(0,), out_path=None, device=None, use_kernel=None):
    dev = resolve_device(device)
    entries = []
    for m in ms:
        e = _bench_m(m, cohort=cohort, rounds=rounds, seeds=seeds,
                     device=dev, use_kernel=use_kernel)
        if csv:
            print(f"scale,m={m},C={e['cohort']},warm_s={e['warm_seconds']},"
                  f"rps={e['warm_rounds_per_s']},"
                  f"acc_buf={e['final_test_acc_buffered']}", flush=True)
        entries.append(e)
    result = {
        "bench": "scale",
        "cohort": cohort,
        "rounds": rounds,
        "by_m": {f"scale_m{e['m']}": e for e in entries},
        "backend": backend_name(dev),
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out_path is None:
        out_path = os.path.join(OUT_DIR, "scale.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--cohort", type=int, default=256)
    ap.add_argument("--ms", default="1000,10000,50000",
                    help="comma-separated client counts")
    ap.add_argument("--smoke", action="store_true",
                    help="one fast arm (m=10000, 6 rounds) for CI")
    ap.add_argument("--device", default=None)
    ap.add_argument("--use-kernel", action="store_true")
    a = ap.parse_args()
    kw = dict(cohort=a.cohort, device=a.device,
              use_kernel=a.use_kernel or None)
    if a.smoke:
        run(ms=(10_000,), rounds=6, **kw)
    else:
        run(ms=tuple(int(x) for x in a.ms.split(",")), rounds=a.rounds, **kw)
