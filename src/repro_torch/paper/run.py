"""Runs the paper's suites on the PyTorch port (the paper suites of the
reference's ``benchmarks/run.py``). Prints CSV.

  python -m repro_torch.paper.run                  # every suite, on the card
  python -m repro_torch.paper.run --list           # what can run, then exit
  python -m repro_torch.paper.run --only fig2,table1 --rounds 400
  python -m repro_torch.paper.run --only table1 --rounds 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

# suite name -> one-line description (--list prints this table)
SUITE_INFO = {
    "fig2": "Eq.-3 FedAvg bias series vs simulation",
    "fig3": "quadratic counterexample convergence curves",
    "table1": "final test accuracy grid (algorithms x schemes)",
    "table2": "rounds-to-target-accuracy grid (writes the machine-readable "
              "baseline JSON)",
    "fig8": "alpha/gamma/delta/sigma0 ablations on one batched axis",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of "
                         f"{'|'.join(SUITE_INFO)} (e.g. --only fig2,table1)")
    ap.add_argument("--list", action="store_true",
                    help="print available suites and exit")
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="server update through the fused Triton kernel "
                         "(default: the REPRO_USE_KERNEL environment switch)")
    args = ap.parse_args(argv)

    if args.list:
        for name, desc in SUITE_INFO.items():
            print(f"{name:12s} {desc}")
        return

    from repro_torch.paper import (
        fig2_bias,
        fig3_quadratic,
        fig8_ablations,
        table1_accuracy,
        table2_rounds_to_target,
    )

    kw = dict(device=args.device, use_kernel=args.use_kernel or None)
    suites = {
        "fig2": lambda: fig2_bias.run(),
        "fig3": lambda: fig3_quadratic.run(rounds=min(args.rounds * 2, 800),
                                           **kw),
        "table1": lambda: table1_accuracy.run(rounds=args.rounds, **kw),
        "table2": lambda: table2_rounds_to_target.run(rounds=args.rounds,
                                                      **kw),
        "fig8": lambda: fig8_ablations.run(rounds=max(args.rounds // 2, 100),
                                           **kw),
    }
    if args.only:
        names = [n.strip() for n in args.only.split(",") if n.strip()]
        unknown = [n for n in names if n not in suites]
        if unknown:
            ap.error(f"unknown suite(s) {','.join(unknown)}; "
                     f"available: {','.join(suites)}")
    else:
        names = list(suites)
    for name in names:
        t0 = time.time()
        print(f"# === {name} ===", flush=True)
        suites[name]()
        print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
