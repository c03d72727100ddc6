"""Adaptive search (successive halving) vs the exhaustive grid:
time-to-target accuracy on the resumable segment runner (port of
``benchmarks/asha.py``).

Three arms over the same FedPBC / Bernoulli-time-varying cell:

1. **baseline** — ``table2_rounds_to_target`` on the same protocol; its
   JSON gives the absolute accuracy targets (the q75 target: 3/4 of the
   single-point run's best accuracy).
2. **grid** — the exhaustive lr grid through ``run_cell_batch``: every
   point runs the full ``rounds`` budget, so its device cost is fixed at
   ``points * seeds * rounds`` trajectory-rounds.
3. **asha** — ``run_search`` over the SAME lr pool with rung-sized
   segments: losers are pruned at each rung on the segments' evals,
   survivors are elastically re-packed into full batches, and the wave log
   gives the device rounds to the target (padding slots and all seeds
   counted).

Enforced bars (RuntimeError on regression):

- ASHA's total device rounds < the exhaustive grid's, at equal final-answer
  quality: ASHA's best accuracy within 0.02 of the grid's best and at or
  above the table-2 q75 target  [full mode only];
- one runner: the whole search and the resume probe use ONE segment runner
  (``grid.segment_runner_for`` builds at most one), and the Triton
  aggregation compiles at most one specialisation during the search
  (``None`` where Triton does not say);
- rung resume, bitwise: k chained ``rung_rounds`` segments reproduce one
  uninterrupted ``k * rung_rounds`` run bit for bit (evals, loss), on the
  CPU and on the card (same kernels, same shapes, same order; the Triton
  reduction over m is deterministic).

Prints a ``BENCH {...}`` JSON line with the reference's keys and writes it
to ``build/paper/asha.json``. ``--smoke`` shrinks everything (structural
bars only).

    python -m repro_torch.paper.asha --smoke --device cpu
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.experiments import SweepSpec, run_cell_batch
from repro_torch.experiments import grid
from repro_torch.experiments.search import SearchSpec, run_search
from repro_torch.paper import OUT_DIR, table2_rounds_to_target

OUT_PATH = os.path.join(OUT_DIR, "asha.json")

ALGO, SCHEME = "fedpbc", "bernoulli_tv"
LRS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5)


def _final_acc(test_acc: np.ndarray) -> float:
    """Seed-mean test accuracy over the last (up to) 3 evals — the window
    ``CellResult.summary`` and the search's persisted summary use."""
    w = min(3, test_acc.shape[1])
    return float(test_acc[:, -w:].mean(axis=1).mean())


def _resume_probe(base: SweepSpec, lrs, seg: int, segments: int = 2,
                  device=None):
    """Bitwise bar: chain ``segments`` rung-sized segments on the segment
    runner and compare against ONE uninterrupted ``segments * seg``-round
    run of the one-shot runner on the same batch. The probe batch has the
    search's width, and the structure-only cache key hands back the
    search's runner."""
    spec = dataclasses.replace(base, lrs=tuple(lrs),
                               rounds=segments * seg, eval_every=seg)
    task = grid.get_traced_task(spec, device)
    fed = spec.cell_config(ALGO, SCHEME)
    batch = grid.make_cell_batch(spec, fed, task, device=device)
    rseg = grid.segment_runner_for(spec, ALGO, SCHEME, segment_rounds=seg,
                                   device=device)
    carry, evals, losses = rseg.init(batch), [], []
    for _ in range(segments):
        carry, out = rseg.step(carry, batch)
        evals.append(out["evals"])
        losses.append(out["metrics"]["loss"])
    full = grid.make_runner(spec, fed, task, device=device)
    _, out = full(batch)
    with torch.no_grad():
        d_evals = (torch.cat(evals, 1) - out["evals"]).abs().max()
        d_loss = (torch.cat(losses, 1) - out["metrics"]["loss"]).abs().max()
    return float(max(d_evals, d_loss))


def run(csv=True, *, rounds=64, m=16, seeds=(0, 1), lrs=LRS,
        rung_rounds=8, eta=2, batch_points=4, smoke=False,
        out_path=OUT_PATH, store=None, device=None, use_kernel=None):
    if smoke:
        rounds, rung_rounds, m = 8, 4, 8
        seeds, lrs, batch_points = (0,), (0.05, 0.1, 0.2, 0.4), 2
        out_path = None
    # the budget cap must be a whole number of rungs; snap down (>= 2 rungs)
    rounds = max(rounds // rung_rounds, 2) * rung_rounds
    base = SweepSpec(algorithms=(ALGO,), schemes=(SCHEME,), seeds=seeds,
                     rounds=rounds, eval_every=rung_rounds, num_clients=m,
                     use_kernel=use_kernel)
    S = len(seeds)

    # arm 1: the table-2 single-point baseline on the same protocol fixes
    # the absolute accuracy targets
    baseline = table2_rounds_to_target.run(
        csv=False, rounds=rounds, m=m, algos=(ALGO,), seed=seeds[0],
        out_path=None if smoke else table2_rounds_to_target.OUT_PATH,
        device=device, use_kernel=use_kernel)
    target = baseline["targets"][2]             # q75

    # arm 2: exhaustive grid — every lr runs the full budget
    grid_spec = dataclasses.replace(base, lrs=tuple(lrs))
    grid_cells = run_cell_batch(grid_spec, ALGO, SCHEME, device=device)
    grid_total = len(lrs) * S * rounds
    grid_best = max(_final_acc(c.test_acc) for c in grid_cells)
    # post-hoc: first eval round at which the best cell's seed-mean curve
    # reached the target (the grid still had to RUN everything to know)
    grid_first = None
    for c in grid_cells:
        curve = c.test_acc.mean(axis=0)
        for r, a in zip(c.eval_rounds, curve):
            if a >= target - 1e-9:
                grid_first = min(grid_first or r, r)
                break

    # arm 3: successive halving over the SAME lr pool
    built = grid.segment_runner_for.built
    search = SearchSpec(base=base, rung_rounds=rung_rounds, eta=eta,
                        batch_points=batch_points,
                        points=tuple({"lr": v} for v in lrs))
    outcome = run_search(search, store=store, suite="asha", device=device)
    asha_best = outcome.best.last_eval
    asha_total = outcome.total_device_rounds
    asha_to_target = outcome.device_rounds_to(target)

    # structural bars on the very same runner the search used
    resume_diff = _resume_probe(base, lrs[:search.width], rung_rounds,
                                device=device)
    entries = dict(outcome.compile_entries,
                   segment_runners=grid.segment_runner_for.built - built)

    result = {
        "bench": "asha_vs_grid",
        "smoke": bool(smoke),
        "protocol": {"algo": ALGO, "scheme": SCHEME, "m": m,
                     "rounds": rounds, "seeds": list(seeds),
                     "rung_rounds": rung_rounds, "eta": eta,
                     "batch_points": batch_points, "lrs": list(lrs)},
        "baseline": {"best_acc": baseline["best_acc"],
                     "targets": baseline["targets"],
                     "target_q75": target},
        "grid": {"device_rounds": grid_total, "best_acc": grid_best,
                 "first_round_at_target": grid_first},
        "asha": {"device_rounds": asha_total, "best_acc": asha_best,
                 "device_rounds_to_target": asha_to_target,
                 "waves": outcome.waves,
                 "wave_log": outcome.wave_log,
                 "candidates": len(outcome.candidates),
                 "statuses": {s: sum(c.status == s
                                     for c in outcome.candidates)
                              for s in ("pruned", "finished", "stopped")}},
        "speedup": {"device_rounds_ratio": grid_total / max(asha_total, 1)},
        "compile_entries": entries,
        "resume_max_abs_diff": resume_diff,
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
    if csv:
        print("asha,arm,device_rounds,best_acc,rounds_to_target")
        print(f"asha,grid,{grid_total},{grid_best:.4f},"
              f"{grid_first if grid_first is not None else -1}")
        print(f"asha,asha,{asha_total},{asha_best:.4f},"
              f"{asha_to_target if asha_to_target is not None else -1}",
              flush=True)

    # -- enforced bars ----------------------------------------------------
    if asha_total >= grid_total:
        raise RuntimeError(
            f"ASHA spent {asha_total} device rounds, the exhaustive grid "
            f"{grid_total}: early pruning saved nothing")
    if entries["segment_runners"] > 1 or entries["agg_kernel"] not in (
            None, 0, 1):
        raise RuntimeError(
            f"the search and the resume probe built more than one segment "
            f"runner, or the aggregation compiled more than one "
            f"specialisation: {entries} (elastic re-pack must be "
            f"structure-stable)")
    if resume_diff != 0.0:
        raise RuntimeError(
            f"chained rung segments diverged from the uninterrupted run: "
            f"max|d|={resume_diff} (resume must be bit-for-bit)")
    if not smoke:
        if asha_best < target - 1e-9:
            raise RuntimeError(
                f"ASHA best accuracy {asha_best:.4f} missed the table-2 "
                f"q75 target {target:.4f}")
        if asha_best < grid_best - 0.02:
            raise RuntimeError(
                f"ASHA final-answer quality {asha_best:.4f} fell more than "
                f"0.02 below the exhaustive grid's {grid_best:.4f}")
    return result


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (structural bars only)")
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="server update through the fused Triton kernel")
    args = ap.parse_args()
    run(rounds=args.rounds, smoke=args.smoke, device=args.device,
        use_kernel=args.use_kernel or None)
