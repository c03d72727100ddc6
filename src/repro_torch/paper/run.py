"""Runs the suites of the reference's ``benchmarks/run.py`` on the PyTorch
port, all 13. Prints CSV.

  python -m repro_torch.paper.run                  # every suite, on the card
  python -m repro_torch.paper.run --list           # what can run, then exit
  python -m repro_torch.paper.run --only fig2,table1 --rounds 400
  python -m repro_torch.paper.run --only table1 --rounds 4 --device cpu

``--rounds`` maps to each suite as the reference's does (fig3 ``min(2r,
800)``, fig8 ``max(r // 2, 100)``, throughput ``max(r, 200)``, sweep
``max(r // 2, 100)``, scale ``max(r // 8, 20)``, lm_sweep ``max(r // 25,
4)``, extensions and the tables ``r``).
"""
from __future__ import annotations

import argparse
import time

# suite name -> (one-line description, arms within the suite's BENCH
# output): the reference's names and arms; --list prints this table
SUITE_INFO = {
    "fig2": ("Eq.-3 FedAvg bias series vs simulation", ()),
    "fig3": ("quadratic counterexample convergence curves", ()),
    "table1": ("final test accuracy grid (algorithms x schemes)", ()),
    "table2": ("rounds-to-target-accuracy grid (writes the machine-readable "
               "baseline JSON asha consumes)", ()),
    "fig8": ("alpha/gamma/delta/sigma0 ablations on one batched axis", ()),
    "extensions": ("beyond-paper extensions (fedpbc_m momentum)", ()),
    "throughput": ("multi-round engine vs per-round dispatch", ()),
    "sweep": ("batched sweep engine vs sequential/per-value baselines",
              ("seed_axis", "hparam_ablation", "algo_axis",
               "device_scaling")),
    "roofline": ("arithmetic-intensity roofline of the model zoo (the dry "
                 "run's rows)", ()),
    "kernels": ("hand-written kernels vs their plain versions (fused "
                "batched aggregation + the other kernel families)",
                ("batched_agg_B8_m32_n1024", "batched_agg_B8_m256_n1024",
                 "batched_agg_B64_m32_n1024", "batched_agg_B64_m256_n1024")),
    "scale": ("cross-device cohort + buffered aggregation vs client count",
              ("scale_m1000", "scale_m10000", "scale_m50000")),
    "lm_sweep": ("federated LM family sweep on the 2-D (batch, model) mesh "
                 "vs one device, with its roofline",
                 ("lm_family", "cohort")),
    "asha": ("successive-halving search vs exhaustive grid (time-to-target "
             "on the resumable segment runner)", ("asha_vs_grid",)),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of "
                         f"{'|'.join(SUITE_INFO)} (e.g. --only fig2,table1)")
    ap.add_argument("--list", action="store_true",
                    help="print available suites (and their BENCH arms) and "
                         "exit")
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="server update through the fused Triton kernel "
                         "(default: the REPRO_USE_KERNEL environment switch)")
    args = ap.parse_args(argv)

    if args.list:
        for name, (desc, arms) in SUITE_INFO.items():
            line = f"{name:12s} {desc}"
            if arms:
                line += f"  [arms: {', '.join(arms)}]"
            print(line)
        return

    from repro_torch.paper import (
        asha,
        extensions,
        fig2_bias,
        fig3_quadratic,
        fig8_ablations,
        kernels_bench,
        lm_sweep,
        roofline,
        scale,
        sweep_throughput,
        table1_accuracy,
        table2_rounds_to_target,
        throughput,
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
        "extensions": lambda: extensions.run(rounds=args.rounds, **kw),
        "throughput": lambda: throughput.run(rounds=max(args.rounds, 200),
                                             **kw),
        "sweep": lambda: sweep_throughput.run(
            rounds=max(args.rounds // 2, 100), **kw),
        "roofline": lambda: roofline.run(),
        "kernels": lambda: kernels_bench.run(device=args.device),
        "scale": lambda: scale.run(rounds=max(args.rounds // 8, 20), **kw),
        "lm_sweep": lambda: lm_sweep.run(rounds=max(args.rounds // 25, 4),
                                         **kw),
        "asha": lambda: asha.run(**kw),
    }
    assert set(suites) == set(SUITE_INFO)
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
