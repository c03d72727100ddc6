#!/usr/bin/env python3
"""Device time of each CUDA kernel behind the port's WKV6 wrapper, on one
card: ``torch.profiler`` over ``--iters`` calls of each route at each shape,
then the kernels' self device time per call by name (the chunked route's
``wkv6_state`` and ``wkv6_output``, the step route's ``wkv6_step``).

    python3 scripts/profile_wkv6.py
    python3 scripts/profile_wkv6.py --shapes 4x40x4096x64,8x40x64x64

Prints one line per (shape, route) and, last, the card's name and power
limit. Inputs as in ``chip_smoke.py`` phase 7 (the reference's decays).
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import rwkv6_chunk as rk

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="4x40x4096x64,8x40x64x64,8x40x1x64")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wkv6: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for spec in args.shapes.split(","):
        b, h, t, d = map(int, spec.split("x"))
        r, k, v = (0.5 * torch.randn(b, h, t, d, generator=gen, device=dev)
                   for _ in range(3))
        w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(
            b, h, t, d, generator=gen, device=dev)))
        u = 0.3 * torch.randn(h, d, generator=gen, device=dev)
        s0 = 0.1 * torch.randn(b, h, d, d, generator=gen, device=dev)
        for route in rk.ROUTES:
            for _ in range(2):
                rk.rwkv6_chunk(r, k, v, w, u, s0, route=route)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    rk.rwkv6_chunk(r, k, v, w, u, s0, route=route)
                torch.cuda.synchronize()
            per = {}
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                name = next((n for n in rk.KERNELS if n in ev.key), ev.key)
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                per[name] = per.get(name, 0.0) + us / 1e3 / args.iters
            print(f"profile_wkv6 [{b},{h},{t},{d}] {route}: device ms per "
                  f"call by kernel " + json.dumps(per), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
