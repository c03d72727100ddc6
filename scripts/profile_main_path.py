"""Where the time of the PyTorch port's main path goes, on one card.

Runs the ``chip_smoke.py`` main-path cell (fedpbc / fedavg / fedavg_all /
fedavg_known_p on bernoulli_tv, seeds 0-2, m = 100, the full-width MLP,
``use_kernel=True``) through ``run_sweep``: once for warm-up, then
``--rounds`` rounds under ``torch.profiler`` (CPU + CUDA activities). Prints
one JSON line: wall time per round, device kernel time per round, the
device's idle share (1 - kernel time / wall time: kernels run on one stream,
so their times do not overlap), and the device time by kernel family
(the fused aggregation, matrix products, everything else), and writes the
profiler's ``key_averages`` table to ``--table``.

    python3 scripts/profile_main_path.py --rounds 50 \\
        --table build/profile_main_path.txt
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton-cache"))
sys.path.insert(0, os.path.join(ROOT, "src"))

FAMILY = ("fedpbc", "fedavg", "fedavg_all", "fedavg_known_p")


def _family(name: str) -> str:
    n = name.lower()
    if "fused_agg" in n:
        return "fused_masked_agg (Triton)"
    if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n:
        return "matrix products (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather / index"
    if "rand" in n or "philox" in n:
        return "random draws"
    if "memcpy" in n or "memset" in n:
        return "copies / fills"
    return "elementwise / reductions"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--table", default="build/profile_main_path.txt")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiments import grid

    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA card")
    spec = grid.SweepSpec(algorithms=FAMILY, schemes=("bernoulli_tv",),
                          seeds=(0, 1, 2), rounds=args.rounds,
                          eval_every=args.rounds, num_clients=100,
                          use_kernel=True)
    grid.run_sweep(spec)                        # warm-up: builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grid.run_sweep(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid.run_sweep(spec)                        # the same run, unprofiled
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    events = prof.key_averages()
    by_family, device_us, launches = {}, 0.0, 0
    for ev in events:
        if ev.device_type != DeviceType.CUDA:   # host ops; kernels are
            continue                             # their own CUDA events
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + us
        device_us += us
        launches += ev.count
    os.makedirs(os.path.dirname(args.table) or ".", exist_ok=True)
    with open(args.table, "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    per_round = 1e3 * wall / args.rounds
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "rounds": args.rounds,
        "wall_ms_per_round": per_round,
        "wall_ms_per_round_unprofiled": 1e3 * wall_plain / args.rounds,
        "device_ms_per_round": device_us / 1e3 / args.rounds,
        "device_idle_share": 1.0 - device_us / 1e3 / (1e3 * wall),
        "device_kernels_per_round": launches / args.rounds,
        "device_ms_per_round_by_family": {
            k: v / 1e3 / args.rounds for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])},
        "note": "wall time includes the cell's set-up and its one eval",
    }))


if __name__ == "__main__":
    main()
