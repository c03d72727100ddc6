#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phase 1 builds the port's Triton kernel (``fused_masked_agg``) and holds it
against its plain PyTorch version on the card: the main path's shape, a
ragged shape, every opcode, a zero-active trajectory, ``prev=None`` and
bf16 input (fp32 atol/rtol 1e-5: summation order over <= 100 terms; bf16
2e-2), printing the block sizes (``masked_agg.block_sizes``) each shape
launched at. It times the kernel, the plain version and one ``torch.bmm`` call
computing the same weighted sum (the yardstick; the port never calls it)
as device time (CUDA events around CUDA-graph replays, so no host launch
cost), the kernel also with a cold L2 and eagerly from Python, and computes
the kernel's bound from the bytes these inputs need (``agg_work``: the
active clients' rows, ``prev`` only where the result reads it).

Phase 1 also runs the aggregation at the federated LM's shape,
``[1, 8, 134,515,008]`` bf16 (more column blocks than CUDA's grid y axis
holds), against the plain version, timed beside ``torch.bmm``.

Phase 2 drives the main path through ``run_sweep`` at the Table-1 protocol
(fedpbc / fedavg / fedavg_all / fedavg_known_p on bernoulli_tv, seeds 0-2,
250 rounds, evals every 25, m = 100, the full-width MLP) with
``use_kernel=True``; the kernel's launch counter must equal the rounds run,
every parameter must be finite and every algorithm must clear its accuracy
bar. Phase 3 runs the same cell for 5 rounds down the kernel and the plain
branch path from the same generators; the server params must agree to 1e-5.

Phase 4 builds the CUDA flash-attention kernels (``nvcc`` into
``build/cuda/``), prints each kernel's registers and spills from the
``-Xptxas -v`` report (and, for the tensor-core kernels of ``FLASH_TC``,
by head dim), and holds forward and dq/dk/dv against the plain
version and its autograd at the reference's kernel-test shapes, at bf16
shapes of the tensor-core backward (D = 128, a ragged T at D = 32, not
causal) and at the LM path's shape ``[144, 2048, 64]`` bf16 causal
(``FLASH_TOL``: fp32 atol and rtol 2e-3, the reference's; bf16 atol 1e-2
with the reference's rtol 3e-2, set from the measured errors), naming the
kernels each shape took (``FLASH_DESIGN``: bf16 takes the tensor-core
forward and backward, fp32 the CUDA-core ones) and the atol each output
needs; it times the three kernels and the forward of
``scaled_dot_product_attention`` (the yardstick; the port never calls it)
with CUDA-graph replays, the plain version and the yardstick's backward
(which allocate) with CUDA events around eager calls, prints the backward
total (dq + dkdv) against SDPA's backward, and computes each kernel's
bound from its flops at the card's bf16 dense peak. Phase 5
drives the LM slice: ``repro_torch.launch.train --full`` (SmolLM-135M,
30 layers, 8 clients, 2 local steps, batch 2, 2048 tokens, 10 rounds,
fedpbc over bernoulli links, the fused aggregation on); every loss must be
finite, each attention kernel must launch rounds x local steps x 30 times
and the aggregation once per round; it prints rounds/s, tokens/s and peak
memory. Phase 6 runs the LM at full width, 2 layers, 512 tokens for
2 rounds down the kernel path and down the plain path (plain attention by
an explicit argument, branch aggregation) from the same generators; the
plain path must launch no flash kernel, and the two server updates must
lie within a relative distance of ``PATHS_TOL`` of each other, over all
parameters and on each attention projection.

Phase 7 prints the ptxas registers, spills and shared memory of the WKV6
kernels (``csrc/rwkv6_chunk.cu``: the chunked route's ``wkv6_state`` and
``wkv6_output``, the step route's ``wkv6_step``) at D = 64 and 128, and
fails on a spill. It holds both routes, each forced, against the plain
chunked version, and against the step scan where the sequence is short,
at the reference's kernel-test shapes, at strong decay (w in [1e-3, 0.1],
T up to 4096: the kernels must stay finite), at T = 1, 2, 63, 65 and a
ragged T, and at the serving shapes: prefill ``[4, 40, 4096, 64]``
(T = 4096, the context of the published RWKV-6 World 3B checkpoints) and
one decode step ``[8, 40, 1, 64]`` (``WKV_TOL``; it prints the atol each
needs at that rtol). It times the prefill shape on the chunked route and
the decode shape on the step route with CUDA-graph replays (the other
route beside each), the plain version with CUDA events, both routes at
``[8, 40, T, 64]`` around ``rwkv6_chunk.STEP_MAX_T``, and computes the
bound from the bytes the call must move and the flops the recurrence
needs (``wkv_work``; bytes bound it at both shapes). No single PyTorch
call computes WKV6, so its library time is null. Phase 8 drives the
serving slice at full width (RWKV6-3B: 32 layers, d_model 2560, 40 heads of
64, vocab 65,536, bf16): (a) ``forward`` on ``[4, 4096]`` tokens, finite
logits, tokens/s and peak memory; (b) ``repro_torch.launch.serve --full
--arch rwkv6-3b --batch 8 --prompt-len 128 --gen 64``, its ids, tokens/s
and peak memory; the wrapper must run 32 times per forward, on the
chunked route, and 32 x (128 + 64) times per serve run, on the step route; (c) ``forward`` at full width,
2 layers, ``[4, 512]``, in bf16 and in fp32, through the kernel and with
``backend="torch"`` (0 launches), the logits within ``RWKV_PATHS_TOL``.
Phase 8 also profiles one forward and a short serve run (16 + 16 steps)
under ``torch.profiler``: device time by kernel family, kernels and
operator calls per step, and the device's idle share.

Phase 9 runs the paper on the card. First the aggregation against its
plain version at the suites' own shapes (Fig. 3's ``[1, 50, 50]`` and its
2-D route, Table 2's ``[4, 100, 2762]``, Fig. 8's ``[6, 100, 2762]``; every
op, with half the clients active and with none) within ``FP32_TOL``, and
Fig. 3's ``run_one`` through the kernel and through the plain path on the
same seeds (FedPBC and FedAvg at (0.9, 0.1), ``FIG3_AGREE_ROUNDS`` rounds),
the distance trajectories within ``FP32_TOL``; one such run is profiled
(kernels, device time and idle share a round). Then the port's
``repro_torch.paper`` suites with ``use_kernel=True`` into a fresh results
store in a temporary directory. Table 1 at the reference's protocol with
seeds 0-2 (all seven algorithms on bernoulli_ti and bernoulli_tv, 250
rounds, m = 100) and at the reference's Eq.-9 probabilities of those seeds
(``REFERENCE_P_BASE``): the aggregation launches once a round for each
scheme's quartet batch (500) and never for the fedau, f3ast and mifa
batches; every parameter and accuracy is finite; each of the 14 (algorithm,
scheme) seed-mean final test accuracies clears the JAX reference's mean
less 0.05 (``TABLE1_REFERENCE_MEAN``, the table phase 2's bars come from).
Table 2 (bernoulli_tv, 300 rounds, evals every 10): its ``BENCH`` JSON has
the reference's keys, a rounds-to-target row for all 7 algorithms, the 1.0
target reached, 300 launches. Fig. 8: 20 finite rows, 4 x 200 launches.
Fig. 3 (m = 50, d = 50, s = 20, seeds 0-2, cut from the module's 800
rounds to ``FIG3_ROUNDS`` = 400): FedPBC's final distance at (0.9, 0.1)
below FedAvg's, each seed-mean final distance within ``FIG3_TOL_STDS``
standard deviations of the difference of two 3-seed means of the
reference's (``FIG3_REFERENCE``), 18 x 400 launches. Fig. 2: its own
checks of Eq. 3's series against both closed forms. The store holds 14 + 7
+ 20 records, ``ResultsStore.merge`` into a second directory keeps them
all and ``export_curves`` writes one ``_acc.csv`` and one ``_loss.csv`` per
curve. It prints each suite's wall seconds, rounds/s of every family batch
and the suites' total, held to ``PHASE9_LIMIT_S`` (the checks before the
suites are timed apart); the suites' CSV goes to ``build/paper/smoke.csv``.

Both CUDA sources are built at the start, one ``nvcc`` each, started
together while phase 1 builds and checks the Triton kernel.

Output: per-phase lines, a ``{"paper": {...}}`` JSON line (phase 9's
seconds, launches, family batches and results), then a ``{"kernels":
[...]}`` JSON line (the aggregation with phase 9's launches by suite as
``paper_launches``; each flash kernel with its design and its registers and
spills at D = 64 and by head dim; the WKV6 wrapper once per route,
``rwkv6_chunk_fwd`` and ``rwkv6_step_fwd``, with their kernels' ptxas by
head dim), the card's name and power limit from nvidia-smi, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result line. Without CUDA, or without the repository beside it, it exits
non-zero at once.
"""
import dataclasses
import gc
import json
import os
import re
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
# Final test accuracy bars, phases 2 and 9: the JAX reference's mean final
# test accuracy over seeds 0-2 at the Table-1 protocol, by scheme and
# algorithm, less 0.05; run on the CPU:
#   PYTHONPATH=src python scripts/table1_reference_bars.py \
#       --algos fedpbc,fedavg,fedavg_all,fedau,f3ast,fedavg_known_p,mifa \
#       --schemes bernoulli_ti,bernoulli_tv
# (its default run prints the bernoulli_tv quartet that phase 2 reads)
TABLE1_REFERENCE_MEAN = {
    "bernoulli_ti": {"fedpbc": 0.7688889106114706,
                     "fedavg": 0.8175556063652039,
                     "fedavg_all": 0.5086666941642761,
                     "fedau": 0.8172222574551901,
                     "f3ast": 0.8275555968284607,
                     "fedavg_known_p": 0.8397778471310934,
                     "mifa": 0.8458889325459799},
    "bernoulli_tv": {"fedpbc": 0.7043333649635315,
                     "fedavg": 0.8031111558278402,
                     "fedavg_all": 0.3702222406864166,
                     "fedau": 0.7892222801844279,
                     "f3ast": 0.8083333571751913,
                     "fedavg_known_p": 0.8238889575004578,
                     "mifa": 0.8195556004842123}}
ACC_MARGIN = 0.05
BARS = {k: TABLE1_REFERENCE_MEAN["bernoulli_tv"][k] - ACC_MARGIN
        for k in FAMILY}
# The Eq.-9 probabilities p_base that the reference's sweep draws for seeds
# 0-2 (jax.random; the port draws its own with numpy): phase 9's Table 1
# runs at these, as the bars above were measured at them. Written by
#   PYTHONPATH=src python scripts/table1_reference_bars.py --p-base \
#       > scripts/table1_reference_p_base.json
REFERENCE_P_BASE = os.path.join(ROOT, "scripts",
                                "table1_reference_p_base.json")
# Fig. 3 (phase 9; the module's protocol m = 50, d = 50, s = 20, eta =
# 5e-4, cut here to 400 rounds to keep phase 9 within its limit): the JAX
# reference's final ||x_PS - x*|| for seeds 0, 1, 2 by (algorithm, p0, p1),
# run on the CPU:
#   PYTHONPATH=src python scripts/table1_reference_bars.py --fig3 \
#       --fig3-rounds 400
FIG3_ROUNDS = 400
FIG3_REFERENCE = {
    ("fedpbc", 0.5, 0.5): (0.006818769499659538, 0.007657024543732405,
                           0.004917568061500788),
    ("fedavg", 0.5, 0.5): (0.008902176283299923, 0.010392524302005768,
                           0.009168844670057297),
    ("fedpbc", 0.9, 0.1): (0.019130822271108627, 0.0186185110360384,
                           0.010473073460161686),
    ("fedavg", 0.9, 0.1): (0.16158367693424225, 0.1646115630865097,
                           0.16867224872112274),
    ("fedpbc", 0.5, 0.1): (0.02052866667509079, 0.018328601494431496,
                           0.009502017870545387),
    ("fedavg", 0.5, 0.1): (0.1397787183523178, 0.14204280078411102,
                           0.1390153169631958)}
# the port draws another u and other links than the reference, so its
# seed mean is another sample of the same quantity: the two 3-seed means
# may differ by FIG3_TOL_STDS standard deviations of their difference,
# sqrt(s_ref^2 / 3 + s_port^2 / 3), each s the seeds' std (ddof 1)
FIG3_TOL_STDS = 4.0
# Fig. 3's trajectory through the kernel against the plain path (phase 9)
FIG3_AGREE_ROUNDS = 100
# Table 2's BENCH JSON keys (benchmarks/table2_rounds_to_target.py)
TABLE2_KEYS = {"bench", "m", "rounds", "seeds", "scheme", "eval_every",
               "algos", "best_acc", "fractions", "targets",
               "rounds_to_target"}
# the five suites of phase 9 (not the kernel checks before them)
PHASE9_LIMIT_S = 240.0
FP32_TOL, BF16_TOL = 1e-5, 2e-2
# the LM slice (phase 5): SmolLM-135M at its published widths
LM_N = 134_515_008
LM_ROUNDS, LM_CLIENTS, LM_STEPS, LM_BATCH, LM_SEQ, LM_LAYERS = \
    10, 8, 2, 2, 2048, 30
# flash attention: the reference's kernel-test shapes, then bf16 shapes of
# the tensor-core backward (D = 128, a ragged T at D = 32, not causal),
# (b, h, t, d, window, softcap, dtype, causal); then the LM path's
# (b, h, t, d, window, softcap, dtype), causal: the LM's [B*m*b*H, T, D]
# is [1 * 8 * 2 * 9, 2048, 64]
FLASH_SHAPES = [(2, 2, 256, 64, 0, 0.0, "float32", True),
                (1, 3, 256, 128, 0, 0.0, "float32", True),
                (1, 2, 256, 64, 128, 0.0, "float32", True),
                (1, 2, 128, 64, 0, 50.0, "float32", True),
                (1, 2, 256, 64, 0, 0.0, "bfloat16", True),
                (1, 3, 256, 128, 0, 0.0, "bfloat16", True),
                (2, 3, 200, 32, 0, 0.0, "bfloat16", True),
                (2, 2, 200, 64, 0, 0.0, "bfloat16", False)]
FLASH_MAIN = (1, LM_CLIENTS * LM_BATCH * 9, LM_SEQ, 64, 0, 0.0, "bfloat16")
# the kernels by input dtype and pass (the C interface's BY_D switches)
FLASH_DESIGN = {
    "bfloat16": {"fwd": "tensor-core bf16 (flash_fwd_tc)",
                 "bwd": "tensor-core bf16 (flash_bwd_dq_tc, "
                        "flash_bwd_dkdv_tc)"},
    "float32": {"fwd": "CUDA-core fp32 (flash_fwd)",
                "bwd": "CUDA-core fp32 (flash_bwd_dq, flash_bwd_dkdv)"}}
# the tensor-core kernel of each pass, whose ptxas report phase 4 prints
FLASH_TC = {"fwd": "flash_fwd_tc", "dq": "flash_bwd_dq_tc",
            "dkdv": "flash_bwd_dkdv_tc"}
# (atol, rtol) of the kernel against the plain version: fp32 the
# reference's 2e-3; bf16 the reference's rtol 3e-2 with an atol of 1e-2,
# above the 7.7e-3 that dq needs at the LM's shape (the largest measured)
FLASH_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (1e-2, 3e-2)}
# kernel vs plain LM path: ||update_kernel - update_plain|| / ||update_plain||
# over all parameters and over each attention projection. Measured 0.13-0.15
# (bf16 parameters: only ~2 % of them move in 2 rounds, each by one bf16
# step, so a rounding flip decides whether an element moves); a zero dQ, dK
# or dV reads 1.0 on wq, wk or wv.
PATHS_TOL = 0.3
# the WKV6 kernels (phase 7): (b, h, t, d, decay) at the reference's
# kernel-test shapes (tests/test_kernels.py), strong decay, ragged T, T = 1,
# T = 2, 63, 65, strong decay over 4096 steps, then the serving shapes,
# prefill and one decode step
WKV_SHAPES = [(1, 1, 64, 64, "ref"), (2, 2, 128, 64, "ref"),
              (1, 2, 256, 128, "ref"), (1, 1, 192, 64, "ref"),
              (2, 4, 256, 64, "strong"), (3, 2, 100, 64, "ref"),
              (2, 4, 1, 128, "ref"), (2, 2, 2, 64, "ref"),
              (1, 2, 63, 64, "ref"), (2, 1, 65, 64, "strong"),
              (1, 4, 4096, 64, "strong")]
WKV_PREFILL = (4, 40, 4096, 64, "ref")
WKV_DECODE = (8, 40, 1, 64, "ref")
# both routes timed at [8, 40, T, 64] around rwkv6_chunk.STEP_MAX_T
WKV_CROSSOVER_T = (1, 2, 4, 8, 12, 16, 32, 64)
# kernel vs plain chunked version (and the step scan): fp32 atol = rtol,
# the reference's kernel tolerance 3e-3 cut to 1e-3 (7.6e-6 measured on the
# card, 1.2e-5 by the emulated build of the same source)
WKV_TOL = 1e-3
# the serving slice (phase 8): RWKV6-3B at full width
RWKV_LAYERS, PREFILL_B, PREFILL_T = 32, 4, 4096
SERVE_B, SERVE_P, SERVE_G = 8, 128, 64
PROFILE_P, PROFILE_G = 16, 16       # the profiled serve window's steps
# kernel vs plain forward (full width, 2 layers, T = 512): max |logit
# difference| / max |logit|. bf16: a few bf16 steps (2^-8 = 3.9e-3), where
# the fp32 WKV output rounds to bf16 differently (7.7e-3 measured); fp32:
# the WKV outputs' ~1e-6 relative differences carried through 2 layers
RWKV_PATHS_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def peak_rates(name):
    """(bytes/s, fp32 flop/s, bf16 dense tensor-core flop/s) of the card
    from its data sheet."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return 3.35e12, 67e12, 989e12          # H100 SXM


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


def time_ms_events(fn, iters=10):
    """Device time per eager call: CUDA events around ``iters`` calls after
    a warm-up (for ms-scale calls that allocate, such as an autograd
    backward, where the host's launch cost is small beside the work)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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


def agg_work(x, mask, op):
    """(bytes, flops) the aggregation needs at these inputs: per trajectory
    the mask, the opcode, the active clients' rows of ``x`` (and their
    ``p`` under OP_KNOWN_P), ``prev`` only where the result reads it
    (OP_ALL, OP_KNOWN_P, or no active client), and the fp32 output row
    written once; one multiply-add per active element."""
    _, m, n = x.shape
    nbytes = nops = 0
    for a, o in zip(mask.sum(1).tolist(), op.tolist()):
        nbytes += m * mask.element_size() + 4 + n * 4
        nbytes += a * n * x.element_size() + (a * 4 if o == 2 else 0)
        nbytes += n * 4 if (o != 0 or a == 0) else 0
        nops += 2 * a * n
    return nbytes, nops


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

    def compare(label, x, got, want, tol):
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
        blocks = masked.block_sizes(x.shape[-2], x.dtype)
        print(f"phase1 {label}: shape {tuple(got.shape)} max_abs_err "
              f"{err:.3e} tol {tol:g} {'ok' if ok else 'MISMATCH'}; "
              f"launched at (BLOCK_M, BLOCK_N, num_warps) {blocks}",
              flush=True)
        if not ok or not torch.isfinite(got).all():
            fail(f"kernel disagrees with its plain version: {label}")
        return err

    B, n = len(FAMILY) * len(SEEDS), 32 * 64 + 64 + 64 * 10 + 10
    main_ops = [op for op in (0, 0, 1, 2) for _ in SEEDS]
    main = inputs(B, CLIENTS, n, main_ops)
    main_err = compare("main path [12,100,2762] fp32", main[0],
                       masked.fused_masked_agg(*main),
                       ref.fused_masked_agg_ref(*main), FP32_TOL)
    rag = inputs(3, 37, 1000, [0, 1, 2])
    compare("ragged [3,37,1000] ops 0/1/2", rag[0],
            masked.fused_masked_agg(*rag),
            ref.fused_masked_agg_ref(*rag), FP32_TOL)
    zero = inputs(3, 37, 1000, [0, 1, 2], active_frac=0.0)
    got = masked.fused_masked_agg(*zero)
    compare("zero-active [3,37,1000]", zero[0], got,
            ref.fused_masked_agg_ref(*zero), FP32_TOL)
    if not torch.equal(got[0], zero[3][0]):
        fail("zero-active OP_MEAN must return prev exactly")
    x2, mk2 = rag[0][0], rag[1][0]
    compare("masked_agg prev=None [37,1000]", x2, masked.masked_agg(x2, mk2),
            ref.masked_agg_ref(x2, mk2), FP32_TOL)
    got = masked.masked_agg(zero[0][0], zero[1][0])
    if not torch.equal(got, torch.zeros_like(got)):
        fail("masked_agg(prev=None) on an empty set must return zeros")
    compare("masked_agg prev [37,1000]", x2,
            masked.masked_agg(x2, mk2, rag[3][0]),
            ref.masked_agg_ref(x2, mk2, rag[3][0]), FP32_TOL)
    bf = (main[0].to(torch.bfloat16),) + main[1:]
    compare("main path bf16 input", bf[0], masked.fused_masked_agg(*bf),
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
    bw, flops, _ = peak_rates(name)
    nbytes, nops = agg_work(x, mask, op)
    bound_ms = max(nbytes / bw, nops / flops) * 1e3
    print(f"phase1 timing [12,100,2762] fp32 (device time per call, CUDA "
          f"graph replay): kernel {kernel_ms:.5f} ms (L2 cold "
          f"{kernel_cold_ms:.5f} ms; eager from Python {kernel_host_ms:.5f} "
          f"ms wall), plain {plain_ms:.5f} ms, "
          f"torch.bmm {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
          f"({nbytes} bytes at {bw / 1e12:g} TB/s)", flush=True)
    lm = phase1_lm_shape(torch, masked, ref, inputs, compare, bw, flops)
    return dict(max_abs_err=main_err, ms=kernel_ms, ms_l2_cold=kernel_cold_ms,
                host_ms=kernel_host_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bytes=nbytes, lm=lm)


def phase1_lm_shape(torch, masked, ref, inputs, compare, bw, flops):
    """The aggregation at the LM's shape: one trajectory, 8 clients,
    134,515,008 bf16 parameters (525,450 column blocks, past gridDim.y)."""
    x, mask, op, prev, p = inputs(1, LM_CLIENTS, LM_N, [0],
                                  dtype=torch.bfloat16)
    mask[0, :2] = True
    err = compare(f"LM shape [1,{LM_CLIENTS},{LM_N}] bf16", x,
                  masked.fused_masked_agg(x, mask, op, prev, p),
                  ref.fused_masked_agg_ref(x, mask, op, prev, p), BF16_TOL)
    kernel_ms = time_ms(lambda: masked.fused_masked_agg(x, mask, op, prev, p),
                        iters=10)
    plain_ms = time_ms_events(
        lambda: ref.fused_masked_agg_ref(x, mask, op, prev, p), iters=3)
    w = mask.to(x.dtype)[:, None, :]
    library_ms = time_ms(lambda: torch.bmm(w, x), iters=10)
    nbytes, nops = agg_work(x, mask, op)
    bound_ms = max(nbytes / bw, nops / flops) * 1e3
    print(f"phase1 timing LM shape [1,{LM_CLIENTS},{LM_N}] bf16 (device "
          f"time per call): kernel {kernel_ms:.5f} ms, plain {plain_ms:.5f} "
          f"ms, torch.bmm {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
          f"({nbytes} bytes at {bw / 1e12:g} TB/s)", flush=True)
    del x, mask, op, prev, p, w
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes)


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


def _attention_pairs(t, window):
    """Allowed (query, key) pairs of one head under the causal mask and
    the window: sum over queries q of min(q + 1, window)."""
    q = np.arange(t)
    return int(np.minimum(q + 1, window if window else t).sum())


def print_ptxas(phase, log):
    """Registers and spills of every kernel in an ``nvcc -Xptxas -v``
    report (``build.compile_all``'s; for a cached build, the report kept
    beside the library, under a line that says so)."""
    entry = None
    for line in log.splitlines():
        if line.startswith("cached build"):
            print(f"{phase} {line.rstrip(':')}", flush=True)
        elif "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line and entry:
            print(f"{phase} ptxas {entry}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
        elif "spill" in line and entry:
            print(f"{phase} ptxas {entry}: {line.strip()}", flush=True)


def ptxas_table(log):
    """{(kernel, head dim): {registers, spill_stores, spill_loads}} from an
    ``nvcc -Xptxas -v`` report."""
    table, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(flash_[a-z_]+)ILi(\d+)E", line)
            key = None if m is None else (m.group(1), int(m.group(2)))
            if key:
                table[key] = {}
        elif key and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            table[key].update({f"spill_{kind}": int(n) for n, kind in nums})
        elif key and "Used" in line and "registers" in line:
            table[key]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return table


def phase4_flash(torch, fa, ref, bw, bf16_peak, build_log):
    import torch.nn.functional as F

    print_ptxas("phase4", build_log)
    ptxas = ptxas_table(build_log)
    for name in FLASH_TC.values():
        got = {kk[1]: vv for kk, vv in ptxas.items() if kk[0] == name}
        print(f"phase4 ptxas {name} by head dim: " + "; ".join(
            f"D={dd}: {vv.get('registers')} registers, spill stores "
            f"{vv.get('spill_stores')} B, loads {vv.get('spill_loads')} B"
            for dd, vv in sorted(got.items())), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}
    for shape in FLASH_SHAPES + [FLASH_MAIN + (True,)]:
        b, h, t, d, win, cap, dtype, causal = shape
        dt = getattr(torch, dtype)
        q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device=dev)
                      .to(dt) for _ in range(4))
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*ts, causal=causal, window=win,
                                 logit_softcap=cap)
        grads = torch.autograd.grad(out, ts, g)
        rs = [x.float().requires_grad_(True) for x in (q, k, v)]
        want = ref.flash_attention_ref(*rs, causal=causal, window=win,
                                       logit_softcap=cap)
        want_grads = torch.autograd.grad(want, rs, g.float())
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dtype]
        e, need = {}, {}
        for n, a, w in zip(("o", "dq", "dk", "dv"), (out,) + grads,
                           (want,) + want_grads):
            diff = (a.float() - w).abs()
            e[n] = diff.max().item()
            # the smallest atol that passes at this rtol, and |w|'s scale
            need[n] = ((diff - rtol * w.abs()).max().item(),
                       w.abs().max().item())
        ok = all(torch.allclose(a.float(), w, rtol=rtol, atol=atol)
                 and torch.isfinite(a).all()
                 for a, w in zip((out,) + grads, (want,) + want_grads))
        print(f"phase4 flash {list(shape)}: max_abs_err " + " ".join(
            f"{n} {x:.3e}" for n, x in e.items())
            + " | atol needed at rtol " + f"{rtol:g}: " + " ".join(
                f"{n} {x[0]:.3e}" for n, x in need.items())
            + " | max|ref| " + " ".join(
                f"{n} {x[1]:.3e}" for n, x in need.items())
            + f" | atol {atol:g} rtol {rtol:g} {'ok' if ok else 'MISMATCH'}"
            + f" | forward: {FLASH_DESIGN[dtype]['fwd']}; backward: "
            + FLASH_DESIGN[dtype]["bwd"], flush=True)
        if not ok:
            fail(f"flash attention disagrees with its plain version at "
                 f"{shape}")
        errs = e
        del q, k, v, g, ts, out, grads, rs, want, want_grads
    torch.cuda.empty_cache()

    # timing at the LM path's shape, [B*m*b*H, T, D] bf16 causal
    b, h, t, d, win, cap, dtype = FLASH_MAIN
    bh = b * h
    q, k, v, do = (torch.randn(bh, t, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse)
    ms = {"fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=20),
          "dq": time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, do,
                                                          lse), iters=20),
          "dkdv": time_ms(lambda: fa.flash_attention_bwd_dkdv(
              q, k, v, do, lse, delta), iters=20)}
    # the plain version: forward, and its autograd for dq alone and for
    # dk, dv alone (each less the forward it reruns)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))

    def plain_fwd():
        return ref.flash_attention_ref(qr, kr, vr)

    plain_f = time_ms_events(plain_fwd, iters=5)
    plain = {"fwd": plain_f,
             "dq": time_ms_events(lambda: torch.autograd.grad(
                 plain_fwd(), [qr], do), iters=5) - plain_f,
             "dkdv": time_ms_events(lambda: torch.autograd.grad(
                 plain_fwd(), [kr, vr], do), iters=5) - plain_f}
    # the yardstick: one scaled_dot_product_attention call, forward and
    # backward (its backward computes dq, dk and dv together)
    q4, k4, v4 = (x.view(1, bh, t, d).clone().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    sdpa_err = (sdpa().float() - o.view(1, bh, t, d).float()).abs().max()
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(
        q4.detach(), k4.detach(), v4.detach(), is_causal=True), iters=20)
    lib_b = time_ms_events(lambda: torch.autograd.grad(
        sdpa(), [q4, k4, v4], do.view(1, bh, t, d)), iters=10) \
        - time_ms_events(sdpa, iters=10)
    library = {"fwd": lib_f, "dq": lib_b, "dkdv": lib_b}
    pairs = bh * _attention_pairs(t, win)
    flops = {"fwd": 4 * pairs * d, "dq": 6 * pairs * d,
             "dkdv": 8 * pairs * d}
    row, mat = bh * t * 4, bh * t * d * 2
    nbytes = {"fwd": 3 * mat + mat + row,                # q,k,v -> o, lse
              "dq": 5 * mat + row + mat + row,           # +o,do,lse -> dq,delta
              "dkdv": 4 * mat + 2 * row + 2 * mat}       # -> dk, dv
    bound = {kk: max(nbytes[kk] / bw, flops[kk] / bf16_peak) * 1e3
             for kk in ms}
    by = {kk: "operations" if flops[kk] / bf16_peak > nbytes[kk] / bw
          else "bytes" for kk in ms}
    for kk in ms:
        print(f"phase4 timing flash_attention_{'fwd' if kk == 'fwd' else 'bwd_' + kk} "
              f"[{bh},{t},{d}] bf16 causal: kernel {ms[kk]:.5f} ms, plain "
              f"{plain[kk]:.5f} ms, scaled_dot_product_attention "
              f"{'fwd' if kk == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{library[kk]:.5f} ms, bound {bound[kk]:.5f} ms "
              f"({flops[kk]:.4e} flop at {bf16_peak / 1e12:g} TFLOP/s bf16; "
              f"{nbytes[kk]} bytes), {flops[kk] / ms[kk] / 1e9:.2f} "
              f"TFLOP/s achieved", flush=True)
    bwd = ms["dq"] + ms["dkdv"]
    print(f"phase4 backward total (dq + dkdv) vs SDPA backward, [{bh},{t},"
          f"{d}] bf16 causal: {ms['dq']:.5f} + {ms['dkdv']:.5f} = "
          f"{bwd:.5f} ms vs {lib_b:.5f} ms, {bwd / lib_b:.2f}x; "
          f"{(flops['dq'] + flops['dkdv']) / bwd / 1e9:.2f} TFLOP/s vs "
          f"{(flops['dq'] + flops['dkdv']) / lib_b / 1e9:.2f}", flush=True)
    print(f"phase4 scaled_dot_product_attention vs kernel forward: max "
          f"|diff| {sdpa_err.item():.3e}", flush=True)
    del q, k, v, do, o, lse, dq, delta, qr, kr, vr, q4, k4, v4
    torch.cuda.empty_cache()
    # registers and spills of the tensor-core kernels, by head dim
    tc = {kk: {f"D={key[1]}": vv for key, vv in sorted(ptxas.items())
               if key[0] == FLASH_TC[kk]} for kk in ms}
    return {kk: dict(ms=ms[kk], plain_ms=plain[kk], library_ms=library[kk],
                     bound_ms=bound[kk], bound_by=by[kk], flops=flops[kk],
                     bytes=nbytes[kk], ptxas=tc[kk],
                     max_abs_err=(errs["o"] if kk == "fwd" else errs["dq"]
                                  if kk == "dq" else max(errs["dk"],
                                                         errs["dv"])))
            for kk in ms}


def _lm_args(batch):
    return ["--full", "--arch", "smollm-135m", "--clients", str(LM_CLIENTS),
            "--local-steps", str(LM_STEPS), "--batch", str(batch),
            "--seq", str(LM_SEQ), "--rounds", str(LM_ROUNDS),
            "--algorithm", "fedpbc", "--scheme", "bernoulli",
            "--log-every", "1"]


def phase5_slice(torch, train, fa, masked, card):
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv, masked.fused_masked_agg)
    batch, out = LM_BATCH, None
    while out is None:
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        os.environ["REPRO_USE_KERNEL"] = "1"     # the fused aggregation
        try:
            out = train.main(_lm_args(batch))
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            print(f"phase5 out of memory at --batch {batch}; halving it",
                  flush=True)
            batch //= 2
        finally:
            os.environ.pop("REPRO_USE_KERNEL", None)
        if out is None:          # the failed run's tensors are released now
            gc.collect()
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = LM_ROUNDS * LM_STEPS * LM_LAYERS
    losses = np.asarray(out["losses"])
    stamps = out["round_seconds"]
    seconds = stamps[-1]
    tokens = LM_ROUNDS * LM_CLIENTS * LM_STEPS * batch * LM_SEQ
    steady = (LM_ROUNDS - 1) / (stamps[-1] - stamps[0])
    print(f"phase5 LM slice (SmolLM-135M, {LM_LAYERS} layers, m={LM_CLIENTS},"
          f" s={LM_STEPS}, b={batch}, T={LM_SEQ}, {LM_ROUNDS} rounds) on "
          f"{card}: {seconds:.3f} s = {LM_ROUNDS / seconds:.4f} rounds/s, "
          f"{tokens / seconds:.1f} tokens/s; after the first round "
          f"{steady:.4f} rounds/s, {steady * tokens / LM_ROUNDS:.1f} "
          f"tokens/s; first round {stamps[0]:.3f} s; peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    print(f"phase5 launches: flash fwd {launches[0]}, bwd_dq {launches[1]}, "
          f"bwd_dkdv {launches[2]} (want {want} each), fused_masked_agg "
          f"{launches[3]} (want {LM_ROUNDS}); losses "
          f"{[round(float(x), 4) for x in losses]}", flush=True)
    if len(losses) != LM_ROUNDS or not np.isfinite(losses).all():
        fail("the LM slice logged a non-finite loss")
    if launches[:3] != [want] * 3:
        fail(f"flash attention launches {launches[:3]}, expected {want} each")
    if launches[3] != LM_ROUNDS:
        fail(f"fused_masked_agg launched {launches[3]} times on the LM "
             f"path, expected {LM_ROUNDS}")
    if not torch.isfinite(out["state"].server.float()).all():
        fail("the LM slice's server params are not finite")
    return dict(launches=launches, seconds=seconds, batch=batch,
                rounds_per_s=LM_ROUNDS / seconds,
                tokens_per_s=tokens / seconds, steady_rounds_per_s=steady,
                peak_gib=peak_gib, first_round_s=stamps[0])


def phase6_paths_agree(torch, train, fa):
    """Full width, 2 layers, T = 512, 2 rounds, down the kernel path and the
    plain path (plain attention, branch aggregation) from the same
    generators. Compared: each path's server update (server minus the
    initial params) by its relative distance, over all parameters and over
    each attention projection; ``wq``, ``wk`` and ``wv`` get their gradient
    only through dQ, dK and dV, so a zero one of these reads 1.0 there."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import param_layout

    layers, rounds = 2, 2
    args = ["--full", "--layers", str(layers), "--seq", "512", "--rounds",
            str(rounds), "--clients", str(LM_CLIENTS), "--local-steps",
            str(LM_STEPS), "--batch", str(LM_BATCH), "--log-every", "2"]
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    updates, losses = {}, {}
    try:
        for path, backend, agg in (("kernel", None, "1"),
                                   ("plain", "torch", "0")):
            os.environ["REPRO_USE_KERNEL"] = agg
            for c in counters:
                c.launches = 0
            out = train.main(args, backend=backend)
            launches = [c.launches for c in counters]
            want = rounds * LM_STEPS * layers if path == "kernel" else 0
            print(f"phase6 {path} path: flash launches fwd/dq/dkdv "
                  f"{launches} (want {want} each)", flush=True)
            if launches != [want] * 3:
                fail(f"the {path} path launched the flash kernels "
                     f"{launches} times, expected {want} each")
            updates[path] = (out["state"].server.float()
                             - out["initial"].float())[0]
            losses[path] = out["losses"]
    finally:
        os.environ.pop("REPRO_USE_KERNEL", None)
    cfg = dataclasses.replace(get_config("smollm-135m"), num_layers=layers)
    groups = {"all": [(0, updates["plain"].numel())]}
    for name, _, a, b in param_layout(cfg).spans():
        for leaf in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
            if name.endswith(leaf):
                groups.setdefault(leaf, []).append((a, b))
    rel = {}
    for g, spans in groups.items():
        k = torch.cat([updates["kernel"][a:b] for a, b in spans])
        p = torch.cat([updates["plain"][a:b] for a, b in spans])
        rel[g] = ((k - p).norm() / p.norm()).item()
    diff = (updates["kernel"] - updates["plain"]).abs()
    print(f"phase6 kernel vs plain path, full width, {layers} layers, T=512, "
          f"{rounds} rounds: relative update distance " + " ".join(
              f"{g} {x:.4e}" for g, x in rel.items())
          + f" (limit {PATHS_TOL:g}); max |update diff| "
          f"{diff.max().item():.3e}, max |update| "
          f"{updates['plain'].abs().max().item():.3e}, elements updated "
          f"{(updates['plain'] != 0).float().mean().item():.4f}; losses "
          f"kernel {losses['kernel']} plain {losses['plain']}", flush=True)
    if not all(x <= PATHS_TOL for x in rel.values()):
        fail("the LM's kernel and plain paths diverge")
    return rel


def wkv_work(b, h, t, d):
    """(bytes, flops) one WKV6 call needs: r, k, v, w read and o written
    once (fp32), u, s0 read and S_T written once; the flops of the step
    recurrence (``ref.rwkv6_chunk_ref``), per (b, h) and step 5 D^2 + 5 D:
    r_t S (2 D^2), diag(w_t) S (D^2), S + k_t^T v_t (2 D^2) and the bonus
    (r_t . (u * k_t)) v_t added to o_t (5 D). The chunked form the kernel
    runs does more (pairwise scores, exponentials); that is its cost, not
    the function's."""
    nbytes = 4 * (5 * b * h * t * d + h * d + 2 * b * h * d * d)
    return nbytes, b * h * t * (5 * d * d + 5 * d)


def wkv_ptxas(log, kernels):
    """{kernel: {head dim: {registers, spill_stores, spill_loads, smem}}}
    of the WKV6 kernels from an ``nvcc -Xptxas -v`` report (``smem``: the
    static shared memory ptxas reports; the dynamic one is
    ``rk.shared_bytes``)."""
    table, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(wkv6_[a-z]+)ILi(\d+)E", line)
            key = None if m is None or m.group(1) not in kernels else (
                m.group(1), int(m.group(2)))
            if key:
                table.setdefault(key[0], {})[key[1]] = {}
        elif key and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            table[key[0]][key[1]].update(
                {f"spill_{kind}": int(n) for n, kind in nums})
        elif key and "Used" in line and "registers" in line:
            entry = table[key[0]][key[1]]
            entry["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(smem.group(1)) if smem else 0
    return table


def phase7_wkv(torch, rk, ref, bw, fp32_peak, build_log):
    print_ptxas("phase7", build_log)
    ptxas = wkv_ptxas(build_log, rk.KERNELS)
    for name in rk.KERNELS:
        by_d = ptxas.get(name, {})
        print(f"phase7 ptxas {name} by head dim: " + "; ".join(
            f"D={dd}: {vv.get('registers')} registers, spill stores "
            f"{vv.get('spill_stores')} B, loads {vv.get('spill_loads')} B, "
            f"shared {vv.get('smem')} B static + "
            f"{rk.shared_bytes(name, dd)} B dynamic"
            for dd, vv in sorted(by_d.items())), flush=True)
        if sorted(by_d) != list(rk.HEAD_DIMS) or any(
                vv.get("spill_stores") or vv.get("spill_loads")
                for vv in by_d.values()):
            fail(f"ptxas reports spills in {name}, or misses a head dim")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(b, h, t, d, decay):
        def rand(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        r, k, v = (0.5 * rand(b, h, t, d) for _ in range(3))
        if decay == "ref":          # tests/test_kernels.py's decays
            w = torch.exp(-torch.exp(-3.0 + 0.5 * rand(b, h, t, d)))
        else:
            w = 1e-3 + (0.1 - 1e-3) * torch.rand(b, h, t, d, generator=gen,
                                                   device=dev)
        return r, k, v, w, 0.3 * rand(h, d), 0.1 * rand(b, h, d, d)

    # every shape through both routes (the wrapper's pick is one of them);
    # the largest error of each route
    errs = dict.fromkeys(rk.ROUTES, 0.0)
    for shape in WKV_SHAPES + [WKV_DECODE, WKV_PREFILL]:
        ins = inputs(*shape)
        wants = {"plain": ref.rwkv6_chunk_plain(*ins)}
        if shape[2] <= 256:
            wants["step scan"] = ref.rwkv6_chunk_ref(*ins)
        for route in rk.ROUTES:
            o, s_t = rk.rwkv6_chunk(*ins, route=route)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(o).all()
                          and torch.isfinite(s_t).all())
            line, need, ok = [], [], finite
            for name, (wo, ws) in wants.items():
                e = max((o - wo).abs().max().item(),
                        (s_t - ws).abs().max().item())
                # the smallest atol that passes at rtol WKV_TOL
                need.append(max(
                    ((o - wo).abs() - WKV_TOL * wo.abs()).max().item(),
                    ((s_t - ws).abs() - WKV_TOL * ws.abs()).max().item()))
                ok = ok and torch.allclose(o, wo, rtol=WKV_TOL,
                                           atol=WKV_TOL) \
                    and torch.allclose(s_t, ws, rtol=WKV_TOL, atol=WKV_TOL)
                line.append(f"{name} {e:.3e}")
                errs[route] = max(errs[route], e)
            pick = " (the wrapper's route)" if route == rk.route_for(
                shape[2]) else ""
            print(f"phase7 wkv6 {route}{pick} {list(shape)}: max_abs_err "
                  f"(o, S_T) vs " + ", ".join(line) + "; atol needed at "
                  f"rtol {WKV_TOL:g}: " + ", ".join(f"{x:.3e}" for x in need)
                  + f"; max|o| {o.abs().max().item():.3e}; finite {finite};"
                  f" tol {WKV_TOL:g} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"the WKV6 {route} route disagrees with its plain "
                     f"version at {shape}")
            del o, s_t
        del ins, wants
    torch.cuda.empty_cache()

    out = {}
    for key, route, shape in (("prefill", "chunked", WKV_PREFILL),
                              ("decode", "step", WKV_DECODE)):
        ins = inputs(*shape)
        ms = time_ms(lambda: rk.rwkv6_chunk(*ins, route=route), iters=20)
        other = "step" if route == "chunked" else "chunked"
        other_ms = time_ms(lambda: rk.rwkv6_chunk(*ins, route=other),
                           iters=2 if other == "step" else 20)
        plain_ms = time_ms_events(lambda: ref.rwkv6_chunk_plain(*ins),
                                  iters=3)
        nbytes, flops = wkv_work(*shape[:4])
        bound_ms = max(nbytes / bw, flops / fp32_peak) * 1e3
        by = "operations" if flops / fp32_peak > nbytes / bw else "bytes"
        print(f"phase7 timing wkv6 {key} {list(shape[:4])} fp32, {route} "
              f"route: kernel {ms:.5f} ms ({other} route {other_ms:.5f} "
              f"ms), plain {plain_ms:.5f} ms, library none (no "
              f"single PyTorch call computes WKV6), bound {bound_ms:.5f} ms "
              f"by {by} ({nbytes} bytes at {bw / 1e12:g} TB/s; {flops:.4e} "
              f"flop at {fp32_peak / 1e12:g} TFLOP/s fp32), "
              f"{nbytes / ms / 1e6:.1f} GB/s achieved", flush=True)
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=by, bytes=nbytes, flops=flops,
                        max_abs_err=errs[route], shape=list(shape[:4]),
                        route=route, other_route_ms=other_ms)
        del ins
    crossover = {}
    for t in WKV_CROSSOVER_T:
        ins = inputs(8, 40, t, 64, "ref")
        crossover[t] = {route: time_ms(
            lambda: rk.rwkv6_chunk(*ins, route=route), iters=20)
            for route in rk.ROUTES}
        del ins
    print("phase7 timing wkv6 routes at [8, 40, T, 64] (ms, CUDA-graph "
          f"replays; T <= {rk.STEP_MAX_T} takes the step route): " + "; ".join(
              f"T={t}: " + ", ".join(f"{r} {x:.5f}" for r, x in c.items())
              for t, c in crossover.items()), flush=True)
    out["crossover_ms"] = crossover
    out["ptxas"] = ptxas
    torch.cuda.empty_cache()
    return out


def _family(name):
    """A device kernel's family, for the profiles of phases 8 and 9."""
    n = name.lower()
    if "fused_agg" in n:
        return "fused_masked_agg (Triton)"
    if "wkv6_state" in n or "wkv6_output" in n:
        return "wkv6 chunked route (CUDA)"
    if "wkv6_step" in n:
        return "wkv6 step route (CUDA)"
    if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n \
            or "nvjet" in n:
        return "matrix products (cuBLAS)"
    if "index" in n or "gather" in n or "embedding" in n:
        return "gather / index"
    if "memcpy" in n or "memset" in n:
        return "copies / fills"
    return "elementwise / reductions"


def profile_window(torch, label, fn, per, unit):
    """``fn`` once under ``torch.profiler`` (CPU and CUDA activities):
    wall and device kernel time per ``unit`` (``per`` of them in one call),
    the device's idle share (1 - kernel time / wall time; the kernels run
    on one stream), kernels and ``aten`` operator calls per unit, and the
    device time per unit by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_family, device_us, kernels, aten = {}, 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            aten += ev.count if ev.key.startswith("aten::") else 0
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + us
        device_us += us
        kernels += ev.count
    out = {f"wall_ms_per_{unit}": 1e3 * wall / per,
           f"device_ms_per_{unit}": device_us / 1e3 / per,
           "device_idle_share": 1.0 - device_us / 1e6 / wall,
           f"kernels_per_{unit}": kernels / per,
           f"aten_calls_per_{unit}": aten / per,
           f"device_ms_per_{unit}_by_family": {
               k: v / 1e3 / per for k, v in sorted(
                   by_family.items(), key=lambda kv: -kv[1])}}
    print(f"{label} profiled (torch.profiler): " + json.dumps(out),
          flush=True)
    return out


def reset_wkv_counts(rk):
    """The WKV6 wrapper's counts to 0: calls, and calls by route."""
    rk.rwkv6_chunk.launches = 0
    rk.rwkv6_chunk.launches_by_route = dict.fromkeys(rk.ROUTES, 0)


def phase8_serving(torch, rk, card):
    """(a) forward of RWKV6-3B at full width on [4, 4096]; (b) the serving
    launcher; (c) the kernel vs the plain forward at 2 layers."""
    from repro_torch.configs import get_config
    from repro_torch.device import set_fp32_matmul_precision
    from repro_torch.launch import serve
    from repro_torch.models import model

    set_fp32_matmul_precision()
    cfg = get_config("rwkv6-3b")
    dev = torch.device("cuda")
    params = model.init_leaves(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    n_params = sum(p.numel() for p in params.values())
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_T),
                         generator=torch.Generator().manual_seed(1)
                         ).to(dev)
    res = {"params": n_params}
    for run in ("first", "second"):
        reset_wkv_counts(rk)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = model.forward(params, cfg, toks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = rk.rwkv6_chunk.launches
        chunked = rk.rwkv6_chunk.launches_by_route["chunked"]
        finite = bool(torch.isfinite(logits).all())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"phase8a forward rwkv6-3b full width ({n_params} params, "
              f"bf16) on [{PREFILL_B}, {PREFILL_T}], {run} call: "
              f"{seconds:.4f} s = {PREFILL_B * PREFILL_T / seconds:.1f} "
              f"tokens/s; logits {tuple(logits.shape)} {logits.dtype} "
              f"finite {finite}; wkv6 launches {launches}, chunked route "
              f"{chunked} (want {RWKV_LAYERS}); peak memory {peak:.2f} GiB "
              f"on {card}",
              flush=True)
        if not finite or tuple(logits.shape) != (PREFILL_B, PREFILL_T,
                                                 cfg.vocab_size):
            fail("the RWKV6 forward's logits are not finite or misshapen")
        if launches != RWKV_LAYERS or chunked != RWKV_LAYERS:
            fail(f"forward launched the WKV6 kernels {launches} times, "
                 f"{chunked} on the chunked route; expected {RWKV_LAYERS}")
        res["forward_chunked_launches"] = chunked
        res[f"forward_{run}_s"] = seconds
        res["forward_tokens_per_s"] = PREFILL_B * PREFILL_T / seconds
        res["forward_peak_gib"] = peak
        del logits

    def forward():
        with torch.no_grad():
            model.forward(params, cfg, toks)

    steps = PROFILE_P + PROFILE_G
    res["forward_profile"] = profile_window(torch, "phase8a forward",
                                            forward, 1, "call")
    res["serve_profile"] = profile_window(
        torch, f"phase8b serve (batch {SERVE_B}, prompt {PROFILE_P}, gen "
        f"{PROFILE_G})", lambda: serve.main(
            ["--full", "--arch", "rwkv6-3b", "--batch", str(SERVE_B),
             "--prompt-len", str(PROFILE_P), "--gen", str(PROFILE_G)],
            params=params), steps, "step")
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    reset_wkv_counts(rk)
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(["--full", "--arch", "rwkv6-3b", "--batch",
                      str(SERVE_B), "--prompt-len", str(SERVE_P), "--gen",
                      str(SERVE_G)])
    launches = rk.rwkv6_chunk.launches
    steps = rk.rwkv6_chunk.launches_by_route["step"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = RWKV_LAYERS * (SERVE_P + SERVE_G)
    decode_s = out["seconds"] - out["prefill_seconds"]
    print(f"phase8b serve rwkv6-3b --full batch {SERVE_B} prompt "
          f"{SERVE_P} gen {SERVE_G}: {out['seconds']:.4f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s incl. prefill (prefill "
          f"{out['prefill_seconds']:.4f} s, decode "
          f"{SERVE_B * SERVE_G / decode_s:.1f} tokens/s, "
          f"{1e3 * out['seconds'] / (SERVE_P + SERVE_G):.3f} ms per step); "
          f"first ids {out['ids'][0][:12].tolist()}; wkv6 launches "
          f"{launches}, step route {steps} (want {want}); peak memory "
          f"{peak:.2f} GiB", flush=True)
    if launches != want or steps != want:
        fail(f"serving launched the WKV6 kernels {launches} times, {steps} "
             f"on the step route; expected {want}")
    if tuple(out["ids"].shape) != (SERVE_B, SERVE_G) or not (
            (out["ids"] >= 0) & (out["ids"] < cfg.vocab_size)).all():
        fail("the served ids are misshapen or out of the vocabulary")
    res.update(serve_s=out["seconds"], serve_tokens_per_s=out["tokens_per_s"],
               serve_prefill_s=out["prefill_seconds"], serve_peak_gib=peak,
               serve_launches=launches, serve_step_launches=steps,
               first_ids=out["ids"][0][:12].tolist())
    gc.collect()
    torch.cuda.empty_cache()

    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, 512),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    for dtype, tol in RWKV_PATHS_TOL.items():
        short = dataclasses.replace(cfg, num_layers=2, dtype=dtype)
        params = model.init_leaves(
            torch.Generator(device=dev).manual_seed(0), short)
        got = {}
        for path, backend in (("kernel", None), ("plain", "torch")):
            reset_wkv_counts(rk)
            with torch.no_grad():
                got[path], _ = model.forward(params, short, toks,
                                             backend=backend)
            want = 2 if path == "kernel" else 0
            print(f"phase8c {dtype} {path} path: wkv6 launches "
                  f"{rk.rwkv6_chunk.launches} (want {want})", flush=True)
            if rk.rwkv6_chunk.launches != want:
                fail(f"the {path} forward launched the WKV6 kernel "
                     f"{rk.rwkv6_chunk.launches} times, expected {want}")
        diff = (got["kernel"] - got["plain"]).abs().max().item()
        scale = got["plain"].abs().max().item()
        same = (got["kernel"].argmax(-1) == got["plain"].argmax(-1)).float()
        print(f"phase8c kernel vs plain forward, full width, 2 layers, "
              f"{dtype}, [{PREFILL_B}, 512]: max |logit diff| {diff:.3e} / "
              f"max |logit| {scale:.3e} = {diff / scale:.3e} (limit "
              f"{tol:g}); argmax equal at {same.mean().item():.4f} of "
              f"positions", flush=True)
        if not diff / scale <= tol:
            fail(f"the RWKV6 kernel and plain forwards diverge ({dtype})")
        res[f"paths_rel_diff_{dtype}"] = diff / scale
        del params, got
        torch.cuda.empty_cache()
    return res


class _Recorded:
    """Inside ``with``: ``mod.<name>`` wrapped so that each call's arguments,
    result and wall seconds are appended to ``calls``."""

    def __init__(self, mod, name):
        self.mod, self.name, self.calls = mod, name, []

    def __enter__(self):
        self.real = getattr(self.mod, self.name)

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = self.real(*args, **kw)
            self.calls.append((args, out, time.perf_counter() - t0))
            return out

        setattr(self.mod, self.name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def phase9_kernel(torch, masked, ref, fig3_quadratic):
    """The aggregation against its plain version at the shapes the paper's
    suites give it: Fig. 3's ``[1, 50, 50]`` (and its 2-D route), Table 2's
    ``[4, 100, 2762]`` and Fig. 8's ``[6, 100, 2762]``, every op, with half
    the clients active and with none; then Fig. 3's ``run_one`` through the
    kernel and through the plain path on the same seeds, its distance
    trajectories within ``FP32_TOL``; then one ``run_one`` profiled. Made
    before the suites and timed apart from them (``seconds``); the suites
    set the counts to 0 each."""
    t0 = time.perf_counter()
    seconds = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    n_mlp = 32 * 64 + 64 + 64 * 10 + 10
    errs = {}
    cases = [((1, 50, 50), [op]) for op in (0, 1, 2)] + [
        ((4, CLIENTS, n_mlp), [0, 0, 1, 2]),
        ((6, CLIENTS, n_mlp), [0, 1, 2, 0, 1, 2])]
    for (B, m, n), ops in cases:
        for frac in (0.5, 0.0):
            x = torch.randn(B, m, n, generator=gen, device=dev)
            mask = torch.rand(B, m, generator=gen, device=dev) < frac
            p = torch.rand(B, m, generator=gen, device=dev)
            prev = torch.randn(B, n, generator=gen, device=dev)
            op = torch.as_tensor(ops, dtype=torch.int32, device=dev)
            args = (x, mask, op, prev, p)
            runs = [(f"[{B},{m},{n}] ops {ops}", masked.fused_masked_agg(
                *args), ref.fused_masked_agg_ref(*args))]
            if B == 1:
                two = (x[0], mask[0], op[0], prev[0], p[0])
                runs.append((f"[{m},{n}] op {ops[0]} (2-D route)",
                             masked.fused_masked_agg(*two),
                             ref.fused_masked_agg_ref(*two)))
            for label, got, want in runs:
                label += f", {frac:.0%} active"
                err = (got - want).abs().max().item()
                ok = (torch.allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
                      and torch.isfinite(got).all().item())
                if frac == 0.0:
                    # no active client: OP_MEAN returns prev exactly
                    mean_rows = (op.reshape(-1) == 0).nonzero().flatten()
                    ok = ok and torch.equal(got.reshape(-1, n)[mean_rows],
                                            prev[mean_rows])
                errs[label] = err
                print(f"phase9 kernel {label}: max_abs_err {err:.3e} tol "
                      f"{FP32_TOL:g} {'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"kernel disagrees with its plain version at the "
                         f"paper's shape {label}")
    torch.cuda.synchronize()
    seconds["kernel_vs_plain"] = time.perf_counter() - t0
    protocol = dict(m=50, d=50, s=20, eta=5e-4, rounds=FIG3_AGREE_ROUNDS)
    for algo in ("fedpbc", "fedavg"):
        paths = [fig3_quadratic.run_one(algo, 0.9, 0.1, seed=0,
                                        use_kernel=k, **protocol)
                 for k in (False, True)]
        err = max(abs(a[1] - b[1]) for a, b in zip(*paths))
        ok = [a[0] for a in paths[0]] == [b[0] for b in paths[1]] \
            and err <= FP32_TOL
        errs[f"fig3 {algo} (0.9, 0.1)"] = err
        print(f"phase9 fig3 {algo} (0.9, 0.1) seed 0, {FIG3_AGREE_ROUNDS} "
              f"rounds: kernel vs plain path, max |distance diff| {err:.3e} "
              f"over {len(paths[0])} points (final {paths[1][-1][1]:.6f}) "
              f"tol {FP32_TOL:g} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"Fig. 3 {algo}: the kernel path's trajectory leaves the "
                 f"plain path's")
    seconds["fig3_kernel_vs_plain_path"] = \
        time.perf_counter() - t0 - sum(seconds.values())
    prof = profile_window(
        torch, f"phase9 fig3 run_one fedpbc (0.9, 0.1), {FIG3_AGREE_ROUNDS} "
        f"rounds", lambda: fig3_quadratic.run_one(
            "fedpbc", 0.9, 0.1, seed=0, use_kernel=True, **protocol),
        FIG3_AGREE_ROUNDS, "round")
    seconds["fig3_profile"] = time.perf_counter() - t0 - sum(seconds.values())
    print(f"phase9 checks before the suites: {json.dumps(seconds)} s, not in "
          f"the suites' limit", flush=True)
    return {"max_abs_err": errs, "fig3_profile": prof, "seconds": seconds}


def _reference_p_base(spec, point):
    """``grid.point_base_probs`` with the reference's draws of seeds 0-2 at
    the default point (``REFERENCE_P_BASE``)."""
    with open(REFERENCE_P_BASE) as f:
        data = json.load(f)
    keys = ("alpha", "sigma0", "delta")
    if any(point[k] != data["protocol"][k] for k in keys) \
            or spec.num_clients != data["protocol"]["num_clients"]:
        fail(f"no reference p_base for {point}, m = {spec.num_clients}")
    return np.asarray([data["p_base"][str(s)] for s in spec.seeds],
                      np.float32)


def phase9_paper(torch, masked, ref, grid):
    """The paper's suites on the card into a fresh results store."""
    import contextlib
    import io
    import tempfile
    from unittest import mock

    from repro_torch.experiments import ResultsStore
    from repro_torch.experiments.plots import export_curves
    from repro_torch.paper import (
        fig2_bias,
        fig3_quadratic,
        fig8_ablations,
        table1_accuracy,
        table2_rounds_to_target,
    )

    csv = io.StringIO()
    res = {"seconds": {}, "launches": {}, "batches": []}

    def suite(name, fn):
        """Run one suite with its CSV captured, the launch counter set to 0
        just before and read just after, and every family batch timed."""
        masked.fused_masked_agg.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Recorded(grid, "_run_batch") as batches, \
                contextlib.redirect_stdout(csv):
            out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = masked.fused_masked_agg.launches
        res["seconds"][name] = seconds
        res["launches"][name] = launches
        for (spec, algos, scheme), _, sec in batches:
            b = len(algos) * len(spec.hparam_points()) * len(spec.seeds)
            res["batches"].append({
                "suite": name, "scheme": scheme, "algos": list(algos),
                "trajectories": b, "rounds": spec.rounds, "seconds": sec,
                "rounds_per_s": spec.rounds / sec})
            print(f"phase9 {name} {scheme} {'+'.join(algos)}: {spec.rounds} "
                  f"rounds x {b} trajectories in {sec:.3f} s = "
                  f"{spec.rounds / sec:.2f} rounds/s", flush=True)
        print(f"phase9 {name}: {seconds:.3f} s, fused_masked_agg launches "
              f"{launches}", flush=True)
        return out, launches

    def cells_finite(cells, what):
        for c in cells:
            if not (np.isfinite(c.server).all()
                    and np.isfinite(c.test_acc).all()
                    and np.isfinite(c.train_acc).all()):
                fail(f"{what} {c.scheme} {c.algo} {c.hparams}: non-finite "
                     f"parameters or accuracy")

    res["kernel"] = phase9_kernel(torch, masked, ref, fig3_quadratic)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(os.path.join(tmp, "sweeps"))

        # Table 1 at the reference's p_base, as its bars were measured
        with _Recorded(table1_accuracy, "run_sweep") as sweeps, \
                mock.patch.object(grid, "point_base_probs",
                                  _reference_p_base):
            table1, launches = suite("table1", lambda: table1_accuracy.run(
                seeds=SEEDS, store=store, use_kernel=True))
        if launches != 2 * ROUNDS:
            fail(f"Table 1 launched the aggregation {launches} times, "
                 f"expected {2 * ROUNDS} (one a round for each scheme's "
                 f"quartet batch)")
        cells_finite(sweeps[0][1], "Table 1")
        for scheme, means in TABLE1_REFERENCE_MEAN.items():
            for algo, ref_mean in means.items():
                acc = table1[(scheme, algo)][0]
                bar = ref_mean - ACC_MARGIN
                ok = acc >= bar
                print(f"phase9 table1 {scheme} {algo}: final test acc "
                      f"{acc:.4f}, reference {ref_mean:.4f}, bar {bar:.4f} "
                      f"{'ok' if ok else 'BELOW'}", flush=True)
                if not ok:
                    fail(f"Table 1 {scheme} {algo} below its accuracy bar")
        res["table1"] = {f"{s},{a}": v[0] for (s, a), v in table1.items()}

        with _Recorded(table2_rounds_to_target, "run_sweep") as sweeps:
            table2, launches = suite("table2",
                                     lambda: table2_rounds_to_target.run(
                                         store=store, use_kernel=True,
                                         out_path=os.path.join(
                                             tmp, "table2.json")))
        cells_finite(sweeps[0][1], "Table 2")
        bench = [json.loads(ln[6:]) for ln in csv.getvalue().splitlines()
                 if ln.startswith("BENCH ")]
        rtt = table2["rounds_to_target"]
        print(f"phase9 table2: best acc {table2['best_acc']:.4f}, rounds to "
              f"target {rtt}", flush=True)
        if len(bench) != 1 or set(bench[0]) != TABLE2_KEYS \
                or bench[0] != table2:
            fail("Table 2's BENCH JSON lacks the reference's keys")
        if set(rtt) != set(TABLE1_REFERENCE_MEAN["bernoulli_tv"]):
            fail("Table 2 lacks rounds to target for some algorithm")
        if not any(r[3] > 0 for r in rtt.values()):
            fail("no algorithm reached Table 2's 1.0 target")
        if launches != 300:
            fail(f"Table 2 launched the aggregation {launches} times, "
                 f"expected 300")
        res["table2"] = table2

        with _Recorded(fig8_ablations, "run_sweep") as sweeps:
            fig8, launches = suite("fig8", lambda: fig8_ablations.run(
                store=store, use_kernel=True))
        for _, cells, _ in sweeps:
            cells_finite(cells, "Fig. 8")
        if len(fig8) != 20 or not all(np.isfinite(v) for v in fig8.values()):
            fail(f"Fig. 8 has {len(fig8)} rows (expected 20) or a "
                 f"non-finite one")
        if launches != 4 * 200:
            fail(f"Fig. 8 launched the aggregation {launches} times, "
                 f"expected {4 * 200}")
        res["fig8"] = {f"{p},{v},{a}": acc for (p, v, a), acc in fig8.items()}

        with _Recorded(fig3_quadratic, "run_one") as runs:
            fig3, launches = suite("fig3", lambda: fig3_quadratic.run(
                rounds=FIG3_ROUNDS, use_kernel=True))
        for key, ref in FIG3_REFERENCE.items():
            port = [out[-1][1] for args, out, _ in runs if args[:3] == key]
            tol = FIG3_TOL_STDS * np.sqrt(np.var(ref, ddof=1) / len(ref)
                                          + np.var(port, ddof=1) / len(port))
            diff = abs(np.mean(port) - np.mean(ref))
            ok = len(port) == len(ref) and diff <= tol
            print(f"phase9 fig3 {key}: final distance {fig3[key]:.6f} (per "
                  f"seed {[round(v, 6) for v in port]}), reference "
                  f"{np.mean(ref):.6f}, |diff| {diff:.6f} tol {tol:.6f} "
                  f"{'ok' if ok else 'OUTSIDE'}", flush=True)
            if not ok:
                fail(f"Fig. 3 {key} outside its tolerance of the reference")
        if not fig3[("fedpbc", 0.9, 0.1)] < fig3[("fedavg", 0.9, 0.1)]:
            fail("Fig. 3: FedPBC's final distance at (0.9, 0.1) is not "
                 "below FedAvg's")
        if launches != 18 * FIG3_ROUNDS:
            fail(f"Fig. 3 launched the aggregation {launches} times, "
                 f"expected {18 * FIG3_ROUNDS}")
        res["batches"].append({
            "suite": "fig3", "scheme": "bernoulli_ti (p0, p1)",
            "algos": ["fedpbc", "fedavg"], "trajectories": 1,
            "runs": 18, "rounds": FIG3_ROUNDS,
            "seconds": res["seconds"]["fig3"],
            "rounds_per_s": 18 * FIG3_ROUNDS / res["seconds"]["fig3"]})
        res["fig3"] = {",".join(map(str, k)): v for k, v in fig3.items()}

        rows, _ = suite("fig2", fig2_bias.run)
        if len(rows) != 20:
            fail("Fig. 2 did not produce its 20 rows")

        counts = {s: len(store.records(suite=s)) for s in
                  ("table1", "table2", "fig8_alpha", "fig8_gamma",
                   "fig8_delta", "fig8_sigma0")}
        n = len(store.records())
        merged = ResultsStore.merge(os.path.join(tmp, "merged"), store)
        written = export_curves(merged, os.path.join(tmp, "curves"))
        n_acc = sum(p.endswith("_acc.csv") for p in written)
        n_loss = sum(p.endswith("_loss.csv") for p in written)
        print(f"phase9 store: {n} records {counts}; merged {len(merged.records())}"
              f"; export_curves wrote {n_acc} _acc.csv and {n_loss} _loss.csv",
              flush=True)
        if n != 41 or counts["table1"] != 14 or counts["table2"] != 7 \
                or len(merged.records()) != 41 or not n_acc == n_loss == 41:
            fail("the results store, its merge or its curve export is "
                 "incomplete")
    res["total_s"] = time.perf_counter() - t_phase
    print(f"phase9 suites total {res['total_s']:.1f} s (limit "
          f"{PHASE9_LIMIT_S:g} s)", flush=True)
    out_dir = os.path.join(ROOT, "build", "paper")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "smoke.csv"), "w") as f:
        f.write(csv.getvalue())
    if res["total_s"] > PHASE9_LIMIT_S:
        fail(f"phase 9's suites took {res['total_s']:.1f} s, over their "
             f"{PHASE9_LIMIT_S:g} s")
    return res


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
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.experiments import grid
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_agg as masked
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_chunk as rk
    from repro_torch.launch import train

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)
    bw, fp32_peak, bf16_peak = peak_rates(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    # both CUDA sources build (one nvcc each) while phase 1 builds the
    # Triton kernel
    with ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(build.compile_all, [fa.SOURCE, rk.SOURCE])
        k = phase1_kernel(torch, masked, ref)
        logs = nvcc.result()
    print(f"nvcc builds of {fa.SOURCE.name} and {rk.SOURCE.name} (in "
          f"parallel, beside phase 1) done at {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    spec, launches, rounds_per_s = phase2_main_path(torch, masked, grid)
    phase3_paths_agree(torch, grid, spec)
    f = phase4_flash(torch, fa, ref, bw, bf16_peak, logs[fa.SOURCE.name])
    lm = phase5_slice(torch, train, fa, masked, card)
    paths_err = phase6_paths_agree(torch, train, fa)
    wkv = phase7_wkv(torch, rk, ref, bw, fp32_peak, logs[rk.SOURCE.name])
    rwkv = phase8_serving(torch, rk, card)
    paper = phase9_paper(torch, masked, ref, grid)
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
              "bytes": k["bytes"], "main_path_rounds_per_s": rounds_per_s,
              "lm_path_launches": lm["launches"][3],
              "paper_launches": paper["launches"],
              "lm_shape": k["lm"]}
    kernels = [kernel]
    source = "src/repro_torch/kernels/csrc/flash_attention.cu"
    replaces = "src/repro/kernels/flash_attention.py:76 (flash_attention -> _kernel"
    for i, (key, name, what) in enumerate((
            ("fwd", "flash_attention_fwd", ")"),
            ("dq", "flash_attention_bwd_dq",
             "; its VJP, which the TPU kernel lacks: delta and dQ)"),
            ("dkdv", "flash_attention_bwd_dkdv",
             "; its VJP, which the TPU kernel lacks: dK and dV)"))):
        r = f[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces + what, "launches": lm["launches"][i],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "flops": r["flops"], "bytes": r["bytes"],
            "shape": list(FLASH_MAIN)})
        # the design and registers and spills, at the LM's head dim first
        kernels[-1].update(
            design=FLASH_DESIGN["bfloat16"]["fwd" if key == "fwd" else "bwd"],
            **r["ptxas"].get("D=64", {}), ptxas_by_head_dim=r["ptxas"])
    kernels[1]["lm_slice"] = {k2: v for k2, v in lm.items()
                              if k2 != "launches"}
    kernels[1]["lm_paths_relative_update_distance"] = paths_err
    source = "src/repro_torch/kernels/csrc/rwkv6_chunk.cu"
    replaces = "src/repro/kernels/rwkv6_chunk.py:73 (rwkv6_chunk -> _kernel"
    for key, name, what, launches in (
            ("prefill", "rwkv6_chunk_fwd", "; the chunked route, two CUDA "
             "launches a call: wkv6_state, wkv6_output)",
             rwkv["forward_chunked_launches"]),
            ("decode", "rwkv6_step_fwd", "; the step route, one CUDA launch "
             "a call: wkv6_step)", rwkv["serve_step_launches"])):
        r = wkv[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces + what, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "flops": r["flops"], "bytes": r["bytes"], "shape": r["shape"],
            "other_route_ms": r["other_route_ms"],
            "ptxas_by_head_dim": {
                k2: v2 for k2, v2 in wkv["ptxas"].items()
                if (k2 == "wkv6_step") == (key == "decode")}})
    kernels[-2]["rwkv_slice"] = rwkv
    kernels[-1]["crossover_ms"] = wkv["crossover_ms"]
    print(json.dumps({"paper": paper}), flush=True)
    print(f"# total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
