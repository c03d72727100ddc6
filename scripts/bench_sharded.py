"""The sweep's multi-device split on every visible card, against one card.

    python3 scripts/bench_sharded.py            # all visible cards
    python3 scripts/bench_sharded.py --cards 2

(1) ``chip_smoke.py`` phase 2's cell (the Table-1 family quartet on
bernoulli_tv, seeds 0-2, 250 rounds, m = 100, ``use_kernel=True``; B = 12)
on a ``("batch",)`` mesh of the cards, one worker process each, against
``mesh=None`` in this process on the first card. (2) lm-family at phase
12's widths (B = 8, m = 4, 10 rounds) on ``make_2d_mesh(cards / 2, 2)``:
the trajectories split over ``"batch"``, each one's clients over
``"model"``, the local updates all-gathered every round, against one card.
Each part runs twice on the mesh (the first call starts the pool), and
prints the backend, each rank's device and wall seconds, the largest
|difference| from one card, the aggregation's and flash kernels' launches
by rank and, for (2), each rank's all-gathers (bytes, ops, wall seconds)
beside ``roofline.collective_stats``'s count. The last line is one
``SHARDED {...}`` JSON object with the card's name and power limit.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="cards to split over (default: every visible one)")
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton-cache"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.experiments import grid, shard, sweep
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_2d_mesh, make_batch_mesh
    from repro_torch.launch.roofline import collective_stats
    from repro_torch.sharding import pool

    if not torch.cuda.is_available():
        raise SystemExit("bench_sharded: CUDA is not available")
    n = args.cards or torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    build.compile_all([fa.SOURCE])
    out = {"card": cs.card_line(), "cards": n}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def ranks(label, res):
        row = {"backend": res.backend,
               "ranks": [(r.device, round(r.seconds, 4)) for r in res.ranks],
               "launches": [v["launches"] for v in res.values]}
        print(f"{label}: {row}", flush=True)
        return row

    # (1) the Table-1 family cell on a ("batch",) mesh of the cards
    spec = grid.SweepSpec(algorithms=cs.FAMILY, schemes=("bernoulli_tv",),
                          seeds=cs.SEEDS, rounds=cs.ROUNDS,
                          eval_every=cs.EVAL_EVERY, num_clients=cs.CLIENTS,
                          use_kernel=True)
    grid.run_sweep(spec, mesh=None)                 # warm: task, kernel
    plain, plain_s = timed(lambda: grid.run_sweep(spec, mesh=None))
    mesh = make_batch_mesh(cards)
    runs = []
    for call in ("first", "second"):
        cells, sec = timed(lambda: grid.run_sweep(spec, mesh=mesh))
        diff = cs._cells_diff(plain, cells)
        runs.append(dict(call=call, seconds=sec,
                         rounds_per_s=cs.ROUNDS / sec, max_abs_diff=diff,
                         **ranks(f"table1-family {call} call", shard.last_run())))
    out["table1_family"] = dict(B=len(cs.FAMILY) * len(cs.SEEDS),
                                one_card_s=plain_s,
                                one_card_rounds_per_s=cs.ROUNDS / plain_s,
                                mesh=runs)
    print(f"table1-family: one card {plain_s:.3f} s; mesh of {n}: "
          f"{[round(r['seconds'], 3) for r in runs]} s, largest |diff| "
          f"{[max(r['max_abs_diff'].values()) for r in runs]}", flush=True)
    pool.close_pools()

    # (2) lm-family on a ("batch", "model") mesh, 2 model ranks
    if n >= 2 and n % 2 == 0:
        lm = grid.SweepSpec(**cs.LM_SWEEP)
        grid.run_batch_states(lm, cs.FAMILY, "bernoulli_ti", mesh=None)
        (task, st_p, _), lm_plain_s = timed(lambda: grid.run_batch_states(
            lm, cs.FAMILY, "bernoulli_ti", mesh=None))
        mesh2d = make_2d_mesh(n // 2, 2, cards)
        B = len(cs.FAMILY) * len(lm.lrs)
        rows = -(-B // (n // 2))
        want = collective_stats(2, rows=rows, clients=lm.num_clients,
                                group_bytes=[4 * task.layout.size],
                                rounds=lm.rounds,
                                final_bytes=[4 * task.layout.size, 4])
        runs = []
        for call in ("first", "second"):
            (_, st_s, _), sec = timed(lambda: grid.run_batch_states(
                lm, cs.FAMILY, "bernoulli_ti", mesh=mesh2d))
            res = shard.last_run()
            gathers = [v["gathers"] for v in res.values]
            runs.append(dict(
                call=call, seconds=sec,
                max_server_diff=float((st_p.server - st_s.server).abs()
                                      .max()),
                gathers=gathers,
                gathers_as_counted=all(
                    g["bytes_by_kind"] == want.bytes_by_kind
                    and g["count_by_kind"] == want.count_by_kind
                    for g in gathers),
                **ranks(f"lm-family 2-D {call} call", res)))
        out["lm_family_2d"] = dict(
            mesh=[n // 2, 2], B=B, one_card_s=lm_plain_s,
            eval_rounds=sweep.eval_rounds(lm.rounds, lm.eval_every),
            collective_stats=dict(bytes_by_kind=want.bytes_by_kind,
                                  count_by_kind=want.count_by_kind,
                                  t_collective_s=want.t_collective),
            runs=runs)
        print(f"lm-family 2-D: one card {lm_plain_s:.3f} s; mesh "
              f"{[r['seconds'] for r in runs]} s; largest |server diff| "
              f"{[r['max_server_diff'] for r in runs]}; gathers as counted "
              f"{[r['gathers_as_counted'] for r in runs]}", flush=True)
        pool.close_pools()
    print("SHARDED " + json.dumps(out, default=float), flush=True)


if __name__ == "__main__":
    main()
