"""Kernel micro-benchmarks (port of ``benchmarks/kernels_bench.py``).

The ``batched_agg`` arms time the sweep's hot path both ways at the sweep
layout ``[B, m, 1024]`` with mixed per-trajectory opcodes, (B, m) in {8, 64}
x {32, 256}: the fused aggregation through ``dispatch.fused_agg`` (the
backend ``dispatch.resolve_backend`` gives the tensors: the hand-written
Triton kernel on the card) against its plain twin
``kernels.ref.fused_masked_agg_ref`` on the same device. The keys are the
reference's so that the outputs compare: ``kernel_us`` is the kernel,
``xla_us`` the plain PyTorch version (the reference's XLA twin),
``max_abs_diff`` the largest |kernel - plain|. The other three rows time
the plain version of each kernel family (``us_per_call``, as the reference
times its references) and report the kernel's largest difference from it
(``kernel_max_err``): ``masked_agg`` at ``[64, 65536]``, the fp32 flash
forward at ``[1, 4, 512, 64]`` causal (the kernel's default, as the
reference's), and WKV6 at ``[1, 4, 256, 64]`` (the chunked route:
``wkv6_state`` + ``wkv6_output``). Each time is the mean of ``reps`` calls
after a warm-up, with ``torch.cuda.synchronize()`` after each (the
reference's ``block_until_ready``).

On CUDA tensors every kernel launches, with no quiet fallback: a kernel
that fails to build or launch raises. On CPU tensors both columns are the
plain version and the aggregation's diff is 0, as interpret mode gives in
the reference. Emits a ``BENCH {...}`` JSON line and writes
``build/paper/kernels.json`` (or ``out_path``).
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (
    OP_ALL,
    OP_KNOWN_P,
    OP_MEAN,
    flash_attention,
    flash_attention_ref,
    fused_agg,
    fused_masked_agg_ref,
    masked_agg,
    masked_agg_ref,
    resolve_backend,
    rwkv6_chunk,
    rwkv6_chunk_ref,
)
from repro_torch.paper import OUT_DIR
from repro_torch.paper.common import backend_name

SIZES = ((8, 32), (8, 256), (64, 32), (64, 256))
N = 1024
MASKED_SHAPE = (64, 1 << 16)
FLASH_SHAPE = (1, 4, 512, 64)
WKV_SHAPE = (1, 4, 256, 64)


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _time(fn, *args, reps=5):
    """Microseconds a call: the mean of ``reps`` calls after one warm-up
    (which also builds the kernel), synchronised after each."""
    _sync(args[0])
    fn(*args)
    _sync(args[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        _sync(args[0])
    return (time.perf_counter() - t0) / reps * 1e6


def _gen(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def agg_inputs(B, m, n=N, device=None):
    """The arm's ``(x [B, m, n], mask [B, m], ops [B], prev [B, n], p [B,
    m])``, seeded by ``B * m`` (the reference folds ``B * m`` into its
    key): half the clients active, opcodes cycling mean / all / known-p."""
    dev = resolve_device(device)
    g = _gen(dev, B * m)
    x = torch.randn(B, m, n, generator=g, device=dev)
    mask = torch.rand(B, m, generator=g, device=dev) < 0.5
    prev = torch.randn(B, n, generator=g, device=dev)
    p = 0.05 + 0.95 * torch.rand(B, m, generator=g, device=dev)
    ops = torch.tensor([(OP_MEAN, OP_ALL, OP_KNOWN_P)[b % 3]
                        for b in range(B)], dtype=torch.int32, device=dev)
    return x, mask, ops, prev, p


def batched_agg_arms(sizes=SIZES, n=N, reps=5, device=None):
    """Time the fused kernel (the backend the tensors resolve to) against
    its plain version per ``[B, m, n]`` size; returns the BENCH sub-dict
    list."""
    arms = []
    for B, m in sizes:
        args = agg_inputs(B, m, n, device)
        backend = resolve_backend(args[0])
        kernel_us = _time(fused_agg, *args, reps=reps)
        xla_us = _time(fused_masked_agg_ref, *args, reps=reps)
        diff = float((fused_agg(*args)
                      - fused_masked_agg_ref(*args)).abs().max())
        arms.append({
            "arm": f"batched_agg_B{B}_m{m}_n{n}",
            "B": B, "m": m, "n": n,
            "kernel_backend": backend,
            "kernel_us": round(kernel_us, 1),
            "xla_us": round(xla_us, 1),
            "speedup": round(xla_us / kernel_us, 3),
            "max_abs_diff": diff,
        })
    return arms


def masked_inputs(device=None):
    dev = resolve_device(device)
    g = _gen(dev, 1)
    x = torch.randn(*MASKED_SHAPE, generator=g, device=dev)
    return x, torch.rand(MASKED_SHAPE[0], generator=g, device=dev) < 0.5


def flash_inputs(device=None):
    dev = resolve_device(device)
    g = _gen(dev, 2)
    return tuple(torch.randn(*FLASH_SHAPE, generator=g, device=dev)
                 for _ in range(3))


def wkv_inputs(device=None):
    """``(r, k, v, w, u, s0)`` at ``WKV_SHAPE``: the reference's scales
    (``0.5 N(0, 1)``; ``w = exp(-exp(-3 + 0.3 N(0, 1)))``; ``u = 0.2 N(0,
    1)``; a zero state)."""
    dev = resolve_device(device)
    g = _gen(dev, 10)
    b, h, t, d = WKV_SHAPE
    r, k, v = (0.5 * torch.randn(b, h, t, d, generator=g, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(-3.0 + 0.3 * torch.randn(
        b, h, t, d, generator=g, device=dev)))
    u = 0.2 * torch.randn(h, d, generator=g, device=dev)
    return r, k, v, w, u, torch.zeros(b, h, d, d, device=dev)


def run(csv=True, out_path=None, device=None):
    dev = resolve_device(device)
    rows = []

    agg_arms = batched_agg_arms(device=dev)
    for a in agg_arms:
        rows.append((a["arm"], a["kernel_us"],
                     f"xla_us={a['xla_us']};speedup={a['speedup']};"
                     f"max_abs_diff={a['max_abs_diff']:.2e}"))

    x, mask = masked_inputs(dev)
    us = _time(masked_agg_ref, x, mask)
    err = float((masked_agg(x, mask) - masked_agg_ref(x, mask)).abs().max())
    rows.append(("masked_agg_64x65536", us, f"kernel_max_err={err:.2e}"))

    q, k, v = flash_inputs(dev)
    us = _time(flash_attention_ref, q, k, v)
    err = float((flash_attention(q, k, v)
                 - flash_attention_ref(q, k, v)).abs().max())
    rows.append(("flash_attention_512", us, f"kernel_max_err={err:.2e}"))

    args = wkv_inputs(dev)
    us = _time(rwkv6_chunk_ref, *args)
    o1, _ = rwkv6_chunk(*args)
    o2, _ = rwkv6_chunk_ref(*args)
    err = float((o1 - o2).abs().max())
    rows.append(("rwkv6_chunk_256", us, f"kernel_max_err={err:.2e}"))

    result = {
        "suite": "kernels",
        "backend": backend_name(dev),
        "kernel_backend": resolve_backend(x),
        "batched_agg": agg_arms,
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out_path is None:
        out_path = os.path.join(OUT_DIR, "kernels.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)

    if csv:
        print("kernels,name,us_per_call,derived")
        for n, us, d_ in rows:
            print(f"kernels,{n},{us:.1f},{d_}")
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    run(device=ap.parse_args().device)
