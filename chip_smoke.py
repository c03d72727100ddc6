#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phase 1 builds the port's Triton kernel (``fused_masked_agg``) and holds it
against its plain PyTorch version on the card: the main path's shape, a
ragged shape, every opcode, a zero-active trajectory, ``prev=None`` and
bf16 input (fp32 atol/rtol 1e-5: summation order over <= 100 terms; bf16
2e-2). It times the kernel, the plain version and one ``torch.bmm`` call
computing the same weighted sum (the yardstick; the port never calls it)
as device time (CUDA events around CUDA-graph replays, so no host launch
cost), the kernel also with a cold L2 and eagerly from Python, and computes
the kernel's bound from its bytes.

Phase 2 drives the main path through ``run_sweep`` at the Table-1 protocol
(fedpbc / fedavg / fedavg_all / fedavg_known_p on bernoulli_tv, seeds 0-2,
250 rounds, evals every 25, m = 100, the full-width MLP) with
``use_kernel=True``; the kernel's launch counter must equal the rounds run,
every parameter must be finite and every algorithm must clear its accuracy
bar. Phase 3 runs the same cell for 5 rounds down the kernel and the plain
branch path from the same generators; the server params must agree to 1e-5.

Output: per-phase lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result line. Without CUDA, or without the repository beside it, it exits
non-zero at once.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# Triton's kernel cache goes into build/ (listed in .gitignore)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton-cache"))

FAMILY = ("fedpbc", "fedavg", "fedavg_all", "fedavg_known_p")
ROUNDS, EVAL_EVERY, SEEDS, CLIENTS = 250, 25, (0, 1, 2), 100
# Final test accuracy bars: the JAX reference's mean over seeds 0-2 at this
# protocol (scripts/table1_reference_bars.py, run on the CPU) less 0.05.
REFERENCE_MEAN = {"fedpbc": 0.7043333649635315,
                  "fedavg": 0.8031111558278402,
                  "fedavg_all": 0.3702222406864166,
                  "fedavg_known_p": 0.8238889575004578}
BARS = {k: v - 0.05 for k, v in REFERENCE_MEAN.items()}
FP32_TOL, BF16_TOL = 1e-5, 2e-2


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def peak_rates(name):
    """(bytes/s, fp32 flop/s) of the card from its data sheet."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12          # H100 SXM


def _graph(fn, iters):
    """``iters`` calls of ``fn`` captured in one CUDA graph (after a warm-up
    on a side stream, which also builds the kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph


def _replay_ms(graph, reps=5):
    import torch

    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_ms(fn, iters=100):
    """Device time per call: ``iters`` back-to-back calls replayed from a
    CUDA graph, so the host's launch cost is not in the number (the data
    stays in the 50 MB L2 between calls, as it does in the main path, where
    local training has just written it)."""
    return _replay_ms(_graph(fn, iters)) / iters


def time_ms_cold(fn, iters=50):
    """Device time per call with the L2 flushed before each call: a graph of
    (flush, call) pairs less a graph of the flushes alone."""
    import torch

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def both():
        flush.zero_()
        fn()

    pairs = _replay_ms(_graph(both, iters))
    alone = _replay_ms(_graph(flush.zero_, iters))
    return (pairs - alone) / iters


def time_ms_host(fn, iters=200):
    """Wall time per eager call, back to back: the wrapper's checks and the
    launch from Python included (what the round loop pays per call)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def phase1_kernel(torch, masked, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(B, m, n, ops, active_frac=0.5, dtype=torch.float32):
        x = torch.randn(B, m, n, generator=gen, device=dev).to(dtype)
        mask = torch.rand(B, m, generator=gen, device=dev) < active_frac
        p = torch.rand(B, m, generator=gen, device=dev)
        prev = torch.randn(B, n, generator=gen, device=dev)
        op = torch.as_tensor(ops, dtype=torch.int32, device=dev)
        return x, mask, op, prev, p

    def compare(label, got, want, tol):
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
        print(f"phase1 {label}: shape {tuple(got.shape)} max_abs_err "
              f"{err:.3e} tol {tol:g} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or not torch.isfinite(got).all():
            fail(f"kernel disagrees with its plain version: {label}")
        return err

    B, n = len(FAMILY) * len(SEEDS), 32 * 64 + 64 + 64 * 10 + 10
    main_ops = [op for op in (0, 0, 1, 2) for _ in SEEDS]
    main = inputs(B, CLIENTS, n, main_ops)
    main_err = compare("main path [12,100,2762] fp32",
                       masked.fused_masked_agg(*main),
                       ref.fused_masked_agg_ref(*main), FP32_TOL)
    rag = inputs(3, 37, 1000, [0, 1, 2])
    compare("ragged [3,37,1000] ops 0/1/2", masked.fused_masked_agg(*rag),
            ref.fused_masked_agg_ref(*rag), FP32_TOL)
    zero = inputs(3, 37, 1000, [0, 1, 2], active_frac=0.0)
    got = masked.fused_masked_agg(*zero)
    compare("zero-active [3,37,1000]", got,
            ref.fused_masked_agg_ref(*zero), FP32_TOL)
    if not torch.equal(got[0], zero[3][0]):
        fail("zero-active OP_MEAN must return prev exactly")
    x2, mk2 = rag[0][0], rag[1][0]
    compare("masked_agg prev=None [37,1000]", masked.masked_agg(x2, mk2),
            ref.masked_agg_ref(x2, mk2), FP32_TOL)
    got = masked.masked_agg(zero[0][0], zero[1][0])
    if not torch.equal(got, torch.zeros_like(got)):
        fail("masked_agg(prev=None) on an empty set must return zeros")
    compare("masked_agg prev [37,1000]",
            masked.masked_agg(x2, mk2, rag[3][0]),
            ref.masked_agg_ref(x2, mk2, rag[3][0]), FP32_TOL)
    bf = (main[0].to(torch.bfloat16),) + main[1:]
    compare("main path bf16 input", masked.fused_masked_agg(*bf),
            ref.fused_masked_agg_ref(*bf), BF16_TOL)
    torch.cuda.synchronize()

    # timing at the main path's shape
    x, mask, op, prev, p = main

    def kernel():
        return masked.fused_masked_agg(x, mask, op, prev, p)

    kernel_ms = time_ms(kernel)
    kernel_cold_ms = time_ms_cold(kernel)
    kernel_host_ms = time_ms_host(kernel)
    plain_ms = time_ms(lambda: ref.fused_masked_agg_ref(x, mask, op, prev, p))
    # the yardstick: per-branch weights made outside, then one bmm
    m = x.shape[1]
    mk = mask.float()
    w = torch.where((op == 2)[:, None], mk / p.clamp_min(1e-3) / m,
                    torch.where((op == 1)[:, None], mk / m, mk))
    library_ms = time_ms(lambda: torch.bmm(w[:, None, :], x))
    name = torch.cuda.get_device_name(0)
    bw, flops = peak_rates(name)
    nbytes = (x.numel() * x.element_size() + mask.numel() + p.numel() * 4
              + prev.numel() * 4 + op.numel() * 4 + prev.numel() * 4)
    bound_ms = max(nbytes / bw, 3 * x.numel() / flops) * 1e3
    print(f"phase1 timing [12,100,2762] fp32 (device time per call, CUDA "
          f"graph replay): kernel {kernel_ms:.5f} ms (L2 cold "
          f"{kernel_cold_ms:.5f} ms; eager from Python {kernel_host_ms:.5f} "
          f"ms wall), plain {plain_ms:.5f} ms, "
          f"torch.bmm {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
          f"({nbytes} bytes at {bw / 1e12:g} TB/s)", flush=True)
    return dict(max_abs_err=main_err, ms=kernel_ms, ms_l2_cold=kernel_cold_ms,
                host_ms=kernel_host_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bytes=nbytes)


def phase2_main_path(torch, masked, grid):
    spec = grid.SweepSpec(algorithms=FAMILY, schemes=("bernoulli_tv",),
                          seeds=SEEDS, rounds=ROUNDS, eval_every=EVAL_EVERY,
                          num_clients=CLIENTS, use_kernel=True)
    masked.fused_masked_agg.launches = 0
    t0 = time.perf_counter()
    cells = grid.run_sweep(spec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = masked.fused_masked_agg.launches
    print(f"phase2 run_sweep: {len(cells)} cells, {ROUNDS} rounds x "
          f"{len(FAMILY) * len(SEEDS)} trajectories in {seconds:.3f} s = "
          f"{ROUNDS / seconds:.2f} rounds/s; kernel launches {launches}",
          flush=True)
    if launches != ROUNDS:
        fail(f"fused_masked_agg launched {launches} times, expected one per "
             f"round ({ROUNDS})")
    for cell in cells:
        if not (np.isfinite(cell.server).all()
                and np.isfinite(cell.test_acc).all()):
            fail(f"{cell.algo}: non-finite parameters or accuracy")
        acc = cell.summary()["test_acc"]["mean"]
        ok = acc >= BARS[cell.algo]
        print(f"phase2 {cell.algo}: final test acc {acc:.4f} (per seed "
              f"{[round(float(a), 4) for a in cell.final_test()]}), bar "
              f"{BARS[cell.algo]:.4f} {'ok' if ok else 'BELOW'}", flush=True)
        if not ok:
            fail(f"{cell.algo} below its accuracy bar")
    return spec, launches, ROUNDS / seconds


def phase3_paths_agree(torch, grid, spec):
    short = dataclasses.replace(spec, rounds=5, eval_every=5)
    servers = {}
    for uk in (True, False):
        _, states, _ = grid.run_batch_states(
            dataclasses.replace(short, use_kernel=uk), FAMILY, "bernoulli_tv")
        servers[uk] = states.server
    err = (servers[True] - servers[False]).abs().max().item()
    print(f"phase3 kernel vs plain branch path, 5 rounds: max |server diff| "
          f"{err:.3e} (atol 1e-5)", flush=True)
    if not err <= 1e-5:
        fail("kernel and plain aggregation paths diverge")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs "
              "a card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.experiments import grid
    from repro_torch.kernels import masked_agg as masked
    from repro_torch.kernels import ref

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    k = phase1_kernel(torch, masked, ref)
    spec, launches, rounds_per_s = phase2_main_path(torch, masked, grid)
    phase3_paths_agree(torch, grid, spec)
    kernel = {"name": "fused_masked_agg", "route": "triton",
              "source": "src/repro_torch/kernels/masked_agg.py",
              "replaces": "src/repro/kernels/masked_agg.py:180 "
                          "(_fused_call_3d; also :156 _fused_call_2d, "
                          ":96 and :109 masked_agg)",
              "launches": launches, "max_abs_err": k["max_abs_err"],
              "ms": k["ms"], "plain_ms": k["plain_ms"],
              "bound_ms": k["bound_ms"], "bound_by": "bytes",
              "library_ms": k["library_ms"], "kernel_ms": k["ms"],
              "bound_us": 1e3 * k["bound_ms"], "ms_l2_cold": k["ms_l2_cold"],
              "host_ms": k["host_ms"],
              "bytes": k["bytes"], "main_path_rounds_per_s": rounds_per_s}
    print(f"# total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
