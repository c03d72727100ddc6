"""Where the time of the port's federated LM training goes, on one card.

Runs ``repro_torch.launch.train --full --arch smollm-135m`` (8 clients, 2
local steps, batch 2, 2048 tokens, fedpbc over bernoulli links, the fused
aggregation on): one round for warm-up, then ``--rounds`` rounds under
``torch.profiler`` (CPU + CUDA activities), then the same rounds
unprofiled. Prints one JSON line: wall time per round (profiled and not),
device kernel time per round, the device's idle share (1 - kernel time /
wall time over the profiled run; kernels run on one stream, so their times
do not overlap) and the device time per round by kernel family (the flash
attention kernels, the fused aggregation, matrix products, the rest), and
writes the profiler's ``key_averages`` table to ``--table``.

    python3 scripts/profile_lm_path.py --rounds 3 \\
        --table build/profile_lm_path.txt
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


def _family(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        if kernel in n:
            return f"{kernel} (CUDA)"
    if "fused_agg" in n:
        return "fused_masked_agg (Triton)"
    if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n \
            or "nvjet" in n:
        return "matrix products (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n or "embedding" in n:
        return "gather / index"
    if "rand" in n or "philox" in n:
        return "random draws"
    if "memcpy" in n or "memset" in n:
        return "copies / fills"
    if "softmax" in n or "logsumexp" in n:
        return "cross-entropy (softmax / logsumexp)"
    return "elementwise / reductions"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--table", default="build/profile_lm_path.txt")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    if not torch.cuda.is_available():
        raise SystemExit("profile_lm_path needs a CUDA card")
    os.environ["REPRO_USE_KERNEL"] = "1"        # the fused aggregation

    def run(rounds):
        return train.main(["--full", "--arch", "smollm-135m", "--clients",
                           "8", "--local-steps", "2", "--batch",
                           str(args.batch), "--seq", str(args.seq),
                           "--rounds", str(rounds), "--log-every",
                           str(rounds)])

    run(1)                                   # warm-up: builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = run(args.rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    plain = run(args.rounds)
    events = prof.key_averages()
    by_family, device_us, launches = {}, 0.0, 0
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + us
        device_us += us
        launches += ev.count
    os.makedirs(os.path.dirname(args.table) or ".", exist_ok=True)
    with open(args.table, "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    r = args.rounds
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "rounds": r, "batch": args.batch, "seq": args.seq,
        "wall_ms_per_round": 1e3 * profiled["round_seconds"][-1] / r,
        "wall_ms_per_round_unprofiled": 1e3 * plain["round_seconds"][-1] / r,
        "wall_s_profiled_incl_setup": wall,
        "device_ms_per_round": device_us / 1e3 / r,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "device_kernels_per_round": launches / r,
        "device_ms_per_round_by_family": {
            k: v / 1e3 / r for k, v in sorted(
                by_family.items(), key=lambda kv: -kv[1])},
        "note": "device time includes the run's set-up (parameter init); "
                "the idle share is over the whole profiled run",
    }))


if __name__ == "__main__":
    main()
