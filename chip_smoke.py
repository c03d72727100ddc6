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
by head dim, of both designs; the build's head dims must be the
wrapper's ``HEAD_DIMS``), and holds forward and dq/dk/dv against the plain
version and its autograd at the reference's kernel-test shapes, at bf16
shapes of the tensor-core backward (D = 128, a ragged T at D = 32, not
causal), at D = 144 and 256 in both dtypes (gemma2-9b's window and
softcap, and its layer's prefill ``[16, 8192, 256]``), at D = 40
(zero-padded to 64 by the wrapper) and at the LM path's shape
``[144, 2048, 64]`` bf16 causal
(``FLASH_TOL``: fp32 atol and rtol 2e-3, the reference's; bf16 atol 1e-2
with the reference's rtol 3e-2, set from the measured errors), naming the
kernels each shape took (``FLASH_DESIGN``: bf16 takes the tensor-core
forward and backward, fp32 the CUDA-core ones) and the atol each output
needs; it times the three kernels and the forward of
``scaled_dot_product_attention`` (the yardstick; the port never calls it)
with CUDA-graph replays, the plain version and the yardstick's backward
(which allocate) with CUDA events around eager calls, prints the backward
total (dq + dkdv) against SDPA's backward, and computes each kernel's
bound from its flops at the card's bf16 dense peak; then the same at the
new head dims (``FLASH_HEAD_DIM_TIMED``): gemma2-9b's prefill ``[16,
8192, 256]`` bf16 with its window 4096 and softcap 50 (SDPA timed causal
only, as it has neither: not the same function, so no library time) and
``[256, 256, 144]`` fp32 (the LM sweep at 576) and ``[144, 2048, 40]``
bf16 (zero-padded to 64), each bound at its dtype's peak for the pairs
its masks allow and its true head dim. Phase 5
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
op, with half the clients active and with none) within ``FP32_TOL``; the
kernel at Fig. 3's shape (2-D route, OP_MEAN, half active) timed as phase 1
times the main path's, beside its bound, its plain version and
``torch.bmm``; and Fig. 3's ``run_one`` through the kernel and through
the plain path on the same seeds (FedPBC and FedAvg at (0.9, 0.1),
``FIG3_AGREE_ROUNDS`` rounds), the distance trajectories within
``FP32_TOL``; one such run is profiled
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

Phase 10 runs cross-device scale (``repro_torch.scale``) on the card:
``benchmarks/scale.py``'s protocol through ``run_cell_batch`` with
``use_kernel=True`` (fedpbc over bernoulli_ti, m = 1,000, 10,000 and
50,000, a C = 256 cohort, the arms ``sync_cohort`` and ``buffered``
(buffer 128, deadline 4) as one batch of 6 trajectories over seeds 0-2, 30
rounds, one eval at the end). Each arm's seed-mean final test accuracy must
lie within ``FIG3_TOL_STDS`` standard deviations of the difference of two
3-seed means of the JAX reference's (``SCALE_REFERENCE``), the buffered
arm's gap below sync at least half the reference's, each buffered seed's
commits within the reference's range and its mean commit staleness within
the deadline. It prints cold and warm seconds, warm rounds/s of the
two-arm batch and of each arm alone, and at m = 50,000 the peak device
memory after a ``reset_peak_memory_stats``, which must stay under one
dense ``[B, m, n]`` fp32 client tensor; then one m = 50,000 round under
``torch.profiler``. A stateful cohort cell (fedau, mifa, f3ast at m =
10,000, seed 0) checks on round ``SPARSE_CHECK_ROUND`` that the per-client
rows outside the cohort are bitwise unchanged, and that every parameter is
finite. The aggregation kernel must launch 0 times in phase 10 (a scale
round aggregates by the buffer fold or the sparse branches, as the
reference's does), and the phase is held to ``PHASE10_LIMIT_S``.

Phase 11 runs adaptive search (``repro_torch.experiments.search``) on the
card, every batch through the fused aggregation. First the aggregation
against its plain version at the shapes this path gives it, asha's
``[8, 16, 2762]`` and the refill search's ``[24, 100, 2762]`` (every op,
half and no clients active, ``FP32_TOL``, ``prev`` exact when none is
active), before the counts are set to 0. (a) At the asha
protocol's batch (fedpbc over bernoulli_tv, m = 16, seeds 0-1, the first
``ASHA_W`` lrs): two chained 8-round segments of the segment runner equal
one uninterrupted 16-round run (evals, losses, every final-state tensor),
a re-packed survivor subset with a duplicate continues as unsliced, and a
batch of level-1 and level-0 slots (a ``[B]`` round) continues each row as
its own unmixed run: max |d| 0 each. (b) ``paper.asha.run()`` at the
reference suite's defaults (64 rounds, m = 16, seeds 0-1, 8 lrs, rung 8,
eta 2, 4 points a batch) at the reference's Eq.-9 ``p_base``
(``ASHA_REFERENCE``): the suite's own bars (ASHA's device rounds below the
grid's, its best within 0.02 of the grid's and at or above Table 2's q75
target, resume 0.0, one segment runner, ``agg_kernel`` at most 1); the
aggregation launches by arm (the Table-2 baseline's rounds, the grid's
rounds, each search batch's 8, the resume probe's 32); the grid at
seeds 0-9, each lr's mean final accuracy within ``FIG3_TOL_STDS``
standard deviations of the difference of two 10-seed means of the
reference's; the lr each arm picks at the top of the reference's 10
seeds (its per-seed deficit to the best lr within ``FIG3_TOL_STDS``
standard errors), the reference's best lr at the top of the port's, and
each arm's best accuracy within ``FIG3_TOL_STDS`` 2-seed standard
deviations of the port's 10-seed mean at its lr. (c) A refill search
at the main path's width (the Table-1 protocol, m = 100, seeds 0-2, a
250-round cap in rungs of 25, lr log-uniform in [0.01, 0.5], 16
candidates, 8 points a batch, refill to 24)
into a temporary store: at least one batch mixing budget levels, the best
finished candidate at or above phase 2's fedpbc bar, one launch a round
per batch, fewer device rounds than the grid of its candidates, one row
per candidate with distinct cell keys and two curves each; it prints
batch rounds/s per wave and profiles one wave of a level-0 batch (an int
round) and one of a batch mixing levels 1 and 0 (a ``[B]`` round). Phase
11 is held to ``PHASE11_LIMIT_S``.

Phase 12 runs the LM sweep task (``SweepSpec(task="lm")``) on the card,
the arms of ``benchmarks/lm_sweep.py``'s full mode. (a) The aggregation
against its plain version at the sweep's shapes, lm-family's ``[8, 4,
106816]`` and lm-wide's ``[4, 8, 9.70M]`` (every op, half and no clients
active, ``FP32_TOL``, ``prev`` exact when none is active), and the fp32
CUDA-core flash kernels forward and backward at the LM's ``[G*b*H, T,
D]``, ``[256, 32, 16]`` and ``[256, 256, 128]`` (``FLASH_TOL``), each
timed beside its plain version, its library call and its bound (fp32
peak). (b) lm-family (``LM_SWEEP``: the quartet over bernoulli_ti, lrs
0.05 and 0.1, m = 4, reduced(smollm-135m) at d_model 64 and 2 layers,
sequences of 32, 10 rounds): cold and warm through ``make_runner``, the
warm run counted and timed (trajectory rounds/s, training tokens/s,
peak memory); the same cell through the plain attention and the branch
aggregation from the same generators (no launch; the largest |server
difference| of a trajectory within ``LM_PATHS_TOL``); then seeds 0-2
through ``run_sweep``, each member's 3-seed mean final test accuracy
within ``FIG3_TOL_STDS`` standard deviations of the difference of two
3-seed means of the reference's (``LM_SWEEP_REFERENCE``), the last-round
losses printed beside. (c) lm-cohort (``LM_COHORT``: fedpbc and fedavg, m
= 10,000, C = 256, 5 rounds): rounds/s, peak memory, 0 aggregation
launches. (d) lm-wide (``LM_WIDE``: d_model 512, 4 layers, T = 256, m = 8,
the quartet at lr 0.1, 5 rounds): rounds/s, tokens/s, peak memory, and one
round under ``torch.profiler``. (e) lm-576 (``LM_576``: lm-family's cell
at d_model 576, 4 heads of 144, 3 rounds) through the fp32 flash kernels
and against the plain path from the same generators (largest |server
difference| within ``LM_PATHS_TOL``). Every cell's launches are counted
on its timed run against ``_want_launches`` (flash forward per layer per local
step and per eval forward, dq and dkdv per layer per local step, the
aggregation once a round), every loss and parameter must be finite, and
the phase is held to ``PHASE12_LIMIT_S``.

Phase 13 serves SmolLM-135M at its published widths (30 layers, d_model
576, 9 heads of 64, 3 KV heads, 134,515,008 parameters, bf16): the
forward's flash kernel at ``[9, 256, 64]`` bf16 against its plain
version; (a) ``repro_torch.launch.serve --full --arch smollm-135m
--batch 8 --prompt-len 128 --gen 64`` (ids ``[8, 64]`` inside the
vocabulary, tokens/s incl. prefill, decode tokens/s, ms a step, peak
memory, 0 flash launches: ``decode_step`` attends its KV cache with the
plain ``decode_attention``, as the reference calls no kernel there), and
a short serve run (8 + 8 steps) under ``torch.profiler``; (b) teacher
forcing at full width: ``forward`` on ``[1, TF_T]`` through the flash
kernel and through the plain attention against ``TF_T`` ``decode_step``
calls, max |logit difference| / max |logit| within ``TF_CASES``' limits
at 2 layers (bf16 and fp32), measured at the full 30 layers in bf16. The phase is held to ``PHASE13_LIMIT_S``.

Phase 14 runs gemma2-9b at its published widths and depth (42 layers,
d_model 3584, 16 heads of 256, 8 KV heads, local/global alternation with
a 4096 window, softcaps 50 and 30, tied embeddings, 9,241,404,928
parameters, bf16, seeded): (a) ``repro_torch.launch.serve --full --arch
gemma2-9b`` at ``GEMMA_SERVE`` (batch 8, prompt 64, gen 32; ids inside
the vocabulary, 0 flash launches, tokens/s, ms a step, peak memory) and
a short run profiled (the idle share); (b) ``forward`` on ``[1, 8192]``
(past the window: the window and softcap masks live in ``flash_fwd_tc``
at D = 256), 42 launches, finite logits under the final softcap,
tokens/s, peak memory, and the same tokens at 2 layers through the
kernel against the plain attention within ``GEMMA_PATHS_TOL``; (c)
teacher forcing on ``[1, 128]`` as phase 13's (``GEMMA_TF_CASES``: bf16
and fp32 at 2 layers held, bf16 at 42 measured). Phase 15 runs the MoE
family at published widths and reduced depth (``MOE_CASES``,
``dataclasses.replace(cfg, num_layers=...)``, the cut printed as
``reduced``): mixtral-8x22b at 4 of 56 layers, then (freed first)
llama4-maverick at 2 of 48 (one dense + MoE period; its chunked layers
take the plain attention, as the reference's dispatch does): a prefill
``forward`` on ``[4, 2048]`` (tokens/s, the aux loss finite and positive,
the share of slots dropped at the config's capacity factor by layer,
flash launches, peak memory), 32 greedy ``decode_step``s at batch 4
(tokens/s, ms a step, a profiled window's idle share, 0 flash launches),
and teacher forcing on ``[1, 64]`` at that depth with the capacity factor
at E / k (dropless), measured. Phases 14 and 15 together are held to
``PHASE14_15_LIMIT_S``.

Both CUDA sources are built at the start, one ``nvcc`` each, started
together while phase 1 builds and checks the Triton kernel.

Output: per-phase lines, a ``{"paper": {...}}`` JSON line (phase 9's
seconds, launches, family batches and results), a ``{"scale": {...}}``
line (phase 10's), a ``{"search": {...}}`` line (phase 11's), a
``{"lm_sweep": {...}}`` line (phase 12's cells), a ``{"serve": {...}}``
line (phase 13's), a ``{"zoo": {...}}`` line (phases 14 and 15), then a
``{"kernels": [...]}`` JSON line (the aggregation with phase 9's launches
by suite as ``paper_launches``, phase 10's as ``scale_launches``, phase
11's as ``search_launches``, phase 12's by cell as ``lm_sweep_launches``
and its timings at the sweep's shapes as ``lm_sweep_shapes``, its Fig. 3
shape timing as ``fig3_shape``; each flash kernel with its design and its
registers and spills at D = 64 and by head dim (both designs), its
errors by checked shape, its timings at the new head dims as
``head_dim_shapes``, its phase-12 launches by cell and timings at D = 16
and 128 (fp32), its launches in phase 13's serve run as
``serve_launches`` and in phases 14-15 as ``zoo_launches``; the WKV6 wrapper once per
route, ``rwkv6_chunk_fwd`` and ``rwkv6_step_fwd``, with their kernels'
ptxas by head dim), the card's name and power limit from nvidia-smi, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result line. Without CUDA, or without the repository beside it, it exits
non-zero at once.
"""
import dataclasses
import gc
import json
import math
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
# Phase 10, cross-device scale: benchmarks/scale.py's protocol (fedpbc over
# bernoulli_ti, a C = 256 cohort, the arms sync_cohort and buffered, 30
# rounds with one eval at the end) at seeds 0-2. The JAX reference's final
# test accuracy of each seed by m and arm, and its buffered commits per
# seed, run on the CPU:
#   PYTHONPATH=src python scripts/scale_reference_bars.py
# The port draws other p_base, cohorts and batches, so its 3-seed mean is
# held to the reference's as Fig. 3's are (FIG3_TOL_STDS standard
# deviations of the difference of two 3-seed means).
SCALE_MS, SCALE_C, SCALE_ROUNDS, SCALE_SCHEME = \
    (1_000, 10_000, 50_000), 256, 30, "bernoulli_ti"
SCALE_BUFFER, SCALE_DEADLINE = 128, 4
SCALE_REFERENCE = {
    1_000: {"sync_cohort": (0.7224999666213989, 0.7224999666213989,
                            0.762499988079071),
            "buffered": (0.2549999952316284, 0.2549999952316284,
                         0.4074999988079071),
            "commits": (7, 7, 7)},
    10_000: {"sync_cohort": (0.7199999690055847, 0.7224999666213989,
                             0.7599999904632568),
             "buffered": (0.26749998331069946, 0.2549999952316284,
                          0.3774999976158142),
             "commits": (7, 7, 7)},
    50_000: {"sync_cohort": (0.7249999642372131, 0.699999988079071,
                             0.7799999713897705),
             "buffered": (0.2574999928474426, 0.24249999225139618,
                          0.3999999761581421),
             "commits": (7, 7, 7)}}
# the stateful cohort cell (sparse per-client state on the card) and the
# round whose untouched rows are checked
SCALE_STATEFUL, SCALE_STATEFUL_M, SPARSE_CHECK_ROUND = \
    ("fedau", "mifa", "f3ast"), 10_000, 10
PHASE10_LIMIT_S = 120.0
# Phase 11, adaptive search: benchmarks/asha.py's protocol at its own
# defaults (fedpbc over bernoulli_tv, 64 rounds, m = 16, seeds 0-1, the 8
# lrs, rung 8, eta 2, 4 points a batch). The JAX reference's results at its
# Eq.-9 p_base of seeds 0 and 1 (which phase 11 runs at): each grid lr's
# per-seed final accuracy (mean of its last 3 evals), ASHA's best, device
# rounds and statuses, the q75 target, run on the CPU:
#   PYTHONPATH=src python scripts/asha_reference_bars.py
ASHA_SEEDS, ASHA_M, ASHA_ROUNDS, ASHA_RUNG, ASHA_W = (0, 1), 16, 64, 8, 4
ASHA_LRS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5)
ASHA_REFERENCE = {
    "grid_best": 0.40783336758613586, "asha_best": 0.4300000071525574,
    "grid_device_rounds": 1024, "asha_device_rounds": 576,
    "target_q75": 0.28725001215934753, "asha_best_lr": 0.5,
    "asha_statuses": {"pruned": 7, "finished": 1, "stopped": 0},
    "grid_per_seed": {
        0.005: (0.16566668450832367, 0.18533332645893097),
        0.01: (0.21066667139530182, 0.20666666328907013),
        0.02: (0.2343333512544632, 0.23966668546199799),
        0.05: (0.2756666839122772, 0.29233333468437195),
        0.1: (0.3240000009536743, 0.320000022649765),
        0.2: (0.3763333559036255, 0.3583333492279053),
        0.3: (0.39800000190734863, 0.3800000250339508),
        0.5: (0.4203333556652069, 0.3953333795070648)},
    "asha_best_per_seed": (0.3840000033378601, 0.47600001096725464),
    "p_base": {
        0: (0.6649820804595947, 0.029178211465477943, 0.8133296370506287,
            0.019999999552965164, 0.019999999552965164,
            0.019999999552965164, 0.019999999552965164, 0.10501556843519211,
            0.019999999552965164, 0.6620943546295166, 0.05078743398189545,
            0.019999999552965164, 0.4429805278778076, 0.26526084542274475,
            0.06704121828079224, 0.019999999552965164),
        1: (0.10359897464513779, 0.639293909072876, 0.019999999552965164,
            0.019999999552965164, 0.019999999552965164,
            0.019999999552965164, 0.075253926217556, 0.1179795041680336,
            0.019999999552965164, 0.019999999552965164,
            0.019999999552965164, 0.0648050308227539, 0.27938205003738403,
            0.019999999552965164, 0.019999999552965164,
            0.019999999552965164)}}
# Two seeds cannot show this protocol's seed spread (their accuracies move
# together over the 8 lrs, which share each seed's draws), so phase 11
# also runs the grid at seeds 0-9, as the reference did (the lrs' per-seed
# final accuracies, their stds, and the reference's p_base of seeds 0-9):
#   PYTHONPATH=src python scripts/asha_reference_bars.py --spread \
#       > scripts/asha_reference_spread.json
# The port draws other links, batches and initial models, so its results
# are other samples of the same quantities: each lr's 10-seed mean may
# differ from the reference's by FIG3_TOL_STDS standard deviations of the
# difference of two 10-seed means, sqrt(s_ref^2 / 10 + s_port^2 / 10).
# The lrs of one seed share its draws, so which lr is best is read from
# the per-seed differences to the best lr, whose spread is far below the
# seeds' own: an lr is at the top where its mean deficit is within
# FIG3_TOL_STDS standard errors of those differences (the reference's 10
# seeds put only lr 0.5 there). Each arm's pick must be at the top of the
# reference's, and its best accuracy (2 seeds) within FIG3_TOL_STDS * s /
# sqrt(2) of the port's 10-seed mean at its lr, s the port's 10-seed std
# there: of the 3-eval final for the grid, of the last eval for ASHA (what
# it ranks on)
ASHA_SPREAD = os.path.join(ROOT, "scripts", "asha_reference_spread.json")
# the refill search at the main path's width: the Table-1 protocol (m =
# 100, the MLP 32 / 64 / 10, fedpbc over bernoulli_tv, seeds 0-2) with a
# 250-round cap in rungs of 25, lr log-uniform in [0.01, 0.5], 16
# candidates, 8 points a batch ([24, 100, 2762] batches), refill up to 24
REFILL_ROUNDS, REFILL_RUNG, REFILL_W = 250, 25, 8
REFILL_CANDIDATES, REFILL_MAX, REFILL_SPACE = \
    16, 24, (("lr", ("log", 0.01, 0.5)),)
PHASE11_LIMIT_S = 120.0
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
                (2, 2, 200, 64, 0, 0.0, "bfloat16", False),
                # head dims 144 (the LM sweep at lm_d_model 576) and 256
                # (gemma2-9b: its window and softcap live at T = 1024, then
                # one gemma2 layer's prefill), and 40, zero-padded to 64
                (1, 2, 256, 144, 0, 0.0, "float32", True),
                (1, 2, 256, 144, 0, 0.0, "bfloat16", True),
                (1, 2, 200, 144, 0, 0.0, "bfloat16", False),
                (1, 2, 512, 256, 128, 50.0, "float32", True),
                (2, 2, 1024, 256, 256, 50.0, "bfloat16", True),
                (1, 2, 256, 256, 0, 0.0, "bfloat16", False),
                (1, 16, 8192, 256, 4096, 50.0, "bfloat16", True),
                (2, 2, 256, 40, 0, 0.0, "float32", True),
                (2, 2, 256, 40, 0, 0.0, "bfloat16", True)]
FLASH_MAIN = (1, LM_CLIENTS * LM_BATCH * 9, LM_SEQ, 64, 0, 0.0, "bfloat16")
# timed at the new head dims, (bh, t, d, window, softcap, dtype), causal:
# one gemma2-9b layer's prefill ([1 * 16, 8192, 256], its local layers'
# window and its attention softcap) and the LM sweep at lm_d_model 576
# ([G * b * 4, 32, 144] at lm-family's G = 32, b = 2 is [256, 32, 144]; a
# 256-token sequence makes it [256, 256, 144]); and a head dim the wrapper
# zero-pads (40 -> 64) at the LM path's [144, 2048, D], beside its D = 64
FLASH_HEAD_DIM_TIMED = [(16, 8192, 256, 4096, 50.0, "bfloat16"),
                        (256, 256, 144, 0, 0.0, "float32"),
                        (144, 2048, 40, 0, 0.0, "bfloat16")]
# the kernels by input dtype and pass (the C interface's BY_D switches)
FLASH_DESIGN = {
    "bfloat16": {"fwd": "tensor-core bf16 (flash_fwd_tc)",
                 "bwd": "tensor-core bf16 (flash_bwd_dq_tc, "
                        "flash_bwd_dkdv_tc)"},
    "float32": {"fwd": "CUDA-core fp32 (flash_fwd)",
                "bwd": "CUDA-core fp32 (flash_bwd_dq, flash_bwd_dkdv)"}}
# the tensor-core kernel of each pass, whose ptxas report phase 4 prints
# by head dim, and the CUDA-core one
FLASH_TC = {"fwd": "flash_fwd_tc", "dq": "flash_bwd_dq_tc",
            "dkdv": "flash_bwd_dkdv_tc"}
FLASH_F32 = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
             "dkdv": "flash_bwd_dkdv"}
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
# Phase 12, the LM sweep task (SweepSpec(task="lm")): the arms of
# benchmarks/lm_sweep.py's full mode on one device. lm-family: the quartet
# over bernoulli_ti, lrs 0.05 and 0.1, m = 4, 2 local steps of batch 2, 16
# sequences a client, reduced(smollm-135m) at d_model 64 (head dim 16) and 2
# layers, sequences of 32, 4 styles, 256 / 64 sequences, 10 rounds, evals
# every 5, seed 0 (the timed cell) and seeds 0-2 (the accuracy bars)
LM_SWEEP = dict(algorithms=FAMILY, schemes=("bernoulli_ti",), seeds=(0,),
                rounds=10, eval_every=5, num_clients=4, local_steps=2,
                batch_size=2, per_client=16, lrs=(0.05, 0.1), task="lm",
                lm_d_model=64, lm_layers=2, lm_seq=32, classes=4,
                lm_n_seqs=256, lm_n_test=64, use_kernel=True)
# lm-cohort: the benchmark's cohort arm (fedpbc and fedavg, m = 10,000, a
# C = 256 cohort, 4 sequences a client, 1 local step, 512 sequences, 5
# rounds); lm-wide: the widest model reduced() gives at a head dim the flash
# kernel takes (d_model 512: 4 heads of 128; 4 layers, sequences of 256),
# m = 8, the quartet at lr 0.1, 5 rounds
LM_COHORT = dict(algorithms=FAMILY[:2], rounds=5, eval_every=5,
                 num_clients=10_000, cohort_size=256, per_client=4,
                 local_steps=1, lm_n_seqs=512)
LM_WIDE = dict(lm_d_model=512, lm_layers=4, lm_seq=256, num_clients=8,
               lrs=(0.1,), rounds=5, eval_every=5)
# lm-576: lm-family's cell at SmolLM-135M's width, d_model 576 (4 heads of
# 144, a head dim the flash kernels instantiate beyond 128), 3 rounds
LM_576 = dict(lm_d_model=576, rounds=3, eval_every=3)
# lm-family's final test accuracy (CellResult.final_test) of seeds 0, 1, 2
# on the JAX reference by member and lr, and each seed's mean training loss
# in the last round, run on the CPU:
#   PYTHONPATH=src python scripts/lm_sweep_reference_bars.py
# The port draws other initial models, links and batches, so each member's
# 3-seed mean (each seed's accuracy averaged over the two lrs) may differ
# from the reference's by FIG3_TOL_STDS standard deviations of the
# difference of two 3-seed means, sqrt(s_ref^2 / 3 + s_port^2 / 3). At 10
# rounds both lie near chance (1/512): the losses are printed beside them.
LM_SWEEP_REFERENCE = {
    "fedpbc": {
        0.05: ([0.003173828125, 0.00244140625, 0.00244140625],
               [5.993766, 6.017055, 6.064603]),
        0.1: ([0.002197265625, 0.001708984375, 0.001953125],
              [5.929684, 5.965669, 6.009222]),
    },
    "fedavg": {
        0.05: ([0.002197265625, 0.001953125, 0.002197265625],
               [6.178049, 6.23173, 6.150668]),
        0.1: ([0.003173828125, 0.001953125, 0.00244140625],
              [6.184205, 6.223831, 6.112601]),
    },
    "fedavg_all": {
        0.05: ([0.000732421875, 0.00244140625, 0.00341796875],
               [6.203969, 6.23094, 6.195037]),
        0.1: ([0.001220703125, 0.00244140625, 0.003662109375],
              [6.184601, 6.224051, 6.161757]),
    },
    "fedavg_known_p": {
        0.05: ([0.001708984375, 0.001953125, 0.002197265625],
               [6.199668, 6.234973, 6.161659]),
        0.1: ([0.002197265625, 0.001708984375, 0.001953125],
              [6.199608, 6.228038, 6.1285]),
    },
}
# the lm-family cell through the kernels (fp32 flash, fused aggregation)
# against the plain attention and the branch aggregation from the same
# generators: the largest |server difference| of any trajectory after 10
# rounds (fp32: the flash kernels' online softmax in tiles, ~1e-6 a step,
# carried through 20 local steps of SGD)
LM_PATHS_TOL = 1e-3
PHASE12_LIMIT_S = 120.0
# Phase 13, dense serving: SmolLM-135M at its published widths (bf16)
# through the serve launcher at phase 8b's traffic; teacher forcing at full
# width, forward on [1, TF_T] against TF_T decode_step calls, max |logit
# diff| / max |logit|, as (dtype, layers, limit): at depth 2 as phase 8c,
# bf16 a few bf16 steps (phase 8c's bar), fp32 products in another order;
# at the full 30 layers in bf16 measured with no limit: there two forwards
# (flash kernel, plain attention) already differ by ~2e-2 on an H100, the
# bf16 rounding of 30 layers of random weights (PERF.md)
SMOLLM_LAYERS, TF_T = 30, 256
SERVE_PROFILE_P = SERVE_PROFILE_G = 8   # the profiled serve window's steps
TF_CASES = (("bfloat16", 2, 2e-2), ("float32", 2, 1e-4),
            ("bfloat16", SMOLLM_LAYERS, None))
PHASE13_LIMIT_S = 120.0
# Phase 14, gemma2-9b at its published widths and depth (42 layers,
# d_model 3584, 16 heads of 256 on 8 KV heads, local/global alternation
# with a 4096 window, attention softcap 50, final softcap 30, tied
# embeddings; bf16): the serve launcher at (batch, prompt, gen); one
# forward on [1, GEMMA_T], T past the window, so the window and softcap
# masks are live in flash_fwd_tc at D = 256, and the same at 2 layers
# through the kernel against the plain attention (bf16, phase 8c's bar);
# teacher forcing on [1, GEMMA_TF_T] as phase 13's (dtype, layers, limit)
GEMMA_LAYERS, GEMMA_T, GEMMA_TF_T = 42, 8192, 128
GEMMA_SERVE = (8, 64, 32)
GEMMA_PATHS_TOL = 2e-2
GEMMA_TF_CASES = (("bfloat16", 2, 2e-2), ("float32", 2, 1e-4),
                  ("bfloat16", GEMMA_LAYERS, None))
# Phase 15, MoE at published widths and reduced depth (bf16): (arch,
# layers), the depth cut so that the weights fit one card (mixtral-8x22b:
# 4 of 56 layers, ~20.9 GB; llama4-maverick: one dense + MoE period, 2 of
# 48 layers, ~37 GB); a prefill forward on MOE_PREFILL tokens at the
# config's capacity factor, then MOE_DECODE steps of greedy decode at
# batch MOE_PREFILL[0]; teacher forcing on [1, MOE_TF_T] at that depth
# with the capacity factor at E / k, so no token is dropped in either path
# (as tests/test_decode_consistency.py makes its reduced MoE dropless),
# measured: in bf16 a token whose hidden state rounds differently in the
# two paths may pick another expert
MOE_CASES = (("mixtral-8x22b", 4), ("llama4-maverick-400b-a17b", 2))
MOE_PREFILL, MOE_DECODE, MOE_TF_T = (4, 2048), 32, 64
PHASE14_15_LIMIT_S = 150.0


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


def time_agg(torch, masked, ref, args, bw, flops, iters=100):
    """The aggregation at ``args`` (x, mask, op, prev, p), device time per
    call: the kernel, the plain version and the yardstick, one
    ``torch.bmm`` over per-branch weights made outside (the port never
    calls it), each as CUDA-graph replays (the plain version with CUDA
    events around eager calls where ``x`` exceeds 256 MiB); the bound from
    the bytes and flops these inputs need (``agg_work``)."""
    x, mask, op, prev, p = args
    kernel_ms = time_ms(lambda: masked.fused_masked_agg(*args), iters=iters)

    def plain():
        return ref.fused_masked_agg_ref(*args)

    plain_ms = (time_ms_events(plain, iters=3)
                if x.numel() * x.element_size() > 2 ** 28
                else time_ms(plain, iters=iters))
    m = x.shape[1]
    mk = mask.float()
    w = torch.where((op == 2)[:, None], mk / p.clamp_min(1e-3) / m,
                    torch.where((op == 1)[:, None], mk / m, mk)).to(x.dtype)
    library_ms = time_ms(lambda: torch.bmm(w[:, None, :], x), iters=iters)
    nbytes, nops = agg_work(x, mask, op)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(nbytes / bw, nops / flops) * 1e3, bytes=nbytes)


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
    name = torch.cuda.get_device_name(0)
    bw, flops, _ = peak_rates(name)
    t = time_agg(torch, masked, ref, main, bw, flops)

    def kernel():
        return masked.fused_masked_agg(*main)

    kernel_cold_ms = time_ms_cold(kernel)
    kernel_host_ms = time_ms_host(kernel)
    print(f"phase1 timing [12,100,2762] fp32 (device time per call, CUDA "
          f"graph replay): kernel {t['ms']:.5f} ms (L2 cold "
          f"{kernel_cold_ms:.5f} ms; eager from Python {kernel_host_ms:.5f} "
          f"ms wall), plain {t['plain_ms']:.5f} ms, "
          f"torch.bmm {t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
          f"({t['bytes']} bytes at {bw / 1e12:g} TB/s)", flush=True)
    lm = phase1_lm_shape(torch, masked, ref, inputs, compare, bw, flops)
    return dict(t, max_abs_err=main_err, ms_l2_cold=kernel_cold_ms,
                host_ms=kernel_host_ms, lm=lm)


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


def check_flash_shape(torch, fa, ref, gen, shape, tag):
    """Forward and dq/dk/dv of the kernels against the plain version and
    its autograd at ``shape`` (b, h, t, d, window, softcap, dtype, causal)
    within ``FLASH_TOL``; fails on a mismatch, returns the max |err| of
    each output."""
    b, h, t, d, win, cap, dtype, causal = shape
    dt = getattr(torch, dtype)
    dev = gen.device
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
    print(f"{tag} flash {list(shape)}: max_abs_err " + " ".join(
        f"{n} {x:.3e}" for n, x in e.items())
        + " | atol needed at rtol " + f"{rtol:g}: " + " ".join(
            f"{n} {x[0]:.3e}" for n, x in need.items())
        + " | max|ref| " + " ".join(
            f"{n} {x[1]:.3e}" for n, x in need.items())
        + f" | atol {atol:g} rtol {rtol:g} {'ok' if ok else 'MISMATCH'}"
        + f" | forward: {FLASH_DESIGN[dtype]['fwd']}; backward: "
        + FLASH_DESIGN[dtype]["bwd"], flush=True)
    if not ok:
        fail(f"flash attention disagrees with its plain version at {shape}")
    return e


def flash_timing(torch, fa, ref, gen, bh, t, d, dtype, bw, peak, tag,
                 window=0, cap=0.0):
    """The three kernels at ``[bh, t, d]`` causal, with ``window`` and
    softcap ``cap`` (CUDA-graph replays), the plain version and its
    autograd (CUDA events around eager calls) and one
    ``scaled_dot_product_attention`` call forward and backward (the
    yardstick; the port never calls it); each pass's bound from its bytes
    at ``bw`` and its flops at ``peak`` (the dtype's rate) for the pairs
    the causal mask and the window allow. SDPA has neither a window nor a
    softcap: with either, its time is of plain causal attention (more
    pairs, no tanh), kept as ``sdpa_ms`` and not as ``library_ms``."""
    import torch.nn.functional as F

    dev = gen.device
    dt = getattr(torch, dtype)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    q, k, v, do = (torch.randn(bh, t, d, generator=gen, device=dev).to(dt)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    ms = {"fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                         iters=20),
          "dq": time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, do,
                                                          lse, **kw),
                        iters=20),
          "dkdv": time_ms(lambda: fa.flash_attention_bwd_dkdv(
              q, k, v, do, lse, delta, **kw), iters=20)}
    # the plain version: forward, and its autograd for dq alone and for
    # dk, dv alone (each less the forward it reruns)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))

    def plain_fwd():
        return ref.flash_attention_ref(qr, kr, vr, window=window,
                                       logit_softcap=cap)

    plain_f = time_ms_events(plain_fwd, iters=5)
    plain = {"fwd": plain_f,
             "dq": time_ms_events(lambda: torch.autograd.grad(
                 plain_fwd(), [qr], do), iters=5) - plain_f,
             "dkdv": time_ms_events(lambda: torch.autograd.grad(
                 plain_fwd(), [kr, vr], do), iters=5) - plain_f}
    del qr, kr, vr
    torch.cuda.empty_cache()
    # the yardstick: one scaled_dot_product_attention call, forward and
    # backward (its backward computes dq, dk and dv together)
    q4, k4, v4 = (x.view(1, bh, t, d).clone().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    same = not window and not cap
    sdpa_err = (sdpa().float() - o.view(1, bh, t, d).float()).abs().max() \
        if same else None
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(
        q4.detach(), k4.detach(), v4.detach(), is_causal=True), iters=20)
    lib_b = time_ms_events(lambda: torch.autograd.grad(
        sdpa(), [q4, k4, v4], do.view(1, bh, t, d)), iters=10) \
        - time_ms_events(sdpa, iters=10)
    sdpa_ms = {"fwd": lib_f, "dq": lib_b, "dkdv": lib_b}
    note = "" if same else (" (causal only: SDPA has no window and no "
                            "softcap, so not the same function)")
    pairs = bh * _attention_pairs(t, window)
    flops = {"fwd": 4 * pairs * d, "dq": 6 * pairs * d,
             "dkdv": 8 * pairs * d}
    row, mat = bh * t * 4, bh * t * d * q.element_size()
    nbytes = {"fwd": 3 * mat + mat + row,                # q,k,v -> o, lse
              "dq": 5 * mat + row + mat + row,           # +o,do,lse -> dq,delta
              "dkdv": 4 * mat + 2 * row + 2 * mat}       # -> dk, dv
    bound = {kk: max(nbytes[kk] / bw, flops[kk] / peak) * 1e3 for kk in ms}
    by = {kk: "operations" if flops[kk] / peak > nbytes[kk] / bw
          else "bytes" for kk in ms}
    short = "bf16" if dtype == "bfloat16" else "fp32"
    masks = "causal" + (f", window {window}" if window else "") + (
        f", softcap {cap:g}" if cap else "")
    for kk in ms:
        print(f"{tag} timing flash_attention_"
              f"{'fwd' if kk == 'fwd' else 'bwd_' + kk} "
              f"[{bh},{t},{d}] {short} {masks}: kernel {ms[kk]:.5f} ms, "
              f"plain {plain[kk]:.5f} ms, scaled_dot_product_attention "
              f"{'fwd' if kk == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{sdpa_ms[kk]:.5f} ms{note}, bound {bound[kk]:.5f} ms "
              f"({flops[kk]:.4e} flop at {peak / 1e12:g} TFLOP/s {short}; "
              f"{nbytes[kk]} bytes), {flops[kk] / ms[kk] / 1e9:.2f} "
              f"TFLOP/s achieved", flush=True)
    bwd = ms["dq"] + ms["dkdv"]
    print(f"{tag} backward total (dq + dkdv) vs SDPA backward{note}, "
          f"[{bh},{t},{d}] {short} {masks}: {ms['dq']:.5f} + "
          f"{ms['dkdv']:.5f} = {bwd:.5f} ms vs {lib_b:.5f} ms, "
          f"{bwd / lib_b:.2f}x; "
          f"{(flops['dq'] + flops['dkdv']) / bwd / 1e9:.2f} TFLOP/s",
          flush=True)
    if same:
        print(f"{tag} scaled_dot_product_attention vs kernel forward: max "
              f"|diff| {sdpa_err.item():.3e}", flush=True)
    del q, k, v, do, o, lse, dq, delta, q4, k4, v4
    torch.cuda.empty_cache()
    return {kk: dict(ms=ms[kk], plain_ms=plain[kk],
                     library_ms=sdpa_ms[kk] if same else None,
                     sdpa_ms=sdpa_ms[kk], bound_ms=bound[kk],
                     bound_by=by[kk], flops=flops[kk], bytes=nbytes[kk],
                     shape=[bh, t, d], dtype=dtype, window=window,
                     softcap=cap)
            for kk in ms}


def phase4_flash(torch, fa, ref, bw, bf16_peak, fp32_peak, build_log):
    print_ptxas("phase4", build_log)
    ptxas = ptxas_table(build_log)
    for name in list(FLASH_TC.values()) + list(FLASH_F32.values()):
        got = {kk[1]: vv for kk, vv in ptxas.items() if kk[0] == name}
        print(f"phase4 ptxas {name} by head dim: " + "; ".join(
            f"D={dd}: {vv.get('registers')} registers, spill stores "
            f"{vv.get('spill_stores')} B, loads {vv.get('spill_loads')} B"
            for dd, vv in sorted(got.items())), flush=True)
    if sorted({kk[1] for kk in ptxas}) != list(fa.HEAD_DIMS):
        fail(f"the build's head dims {sorted({kk[1] for kk in ptxas})} are "
             f"not the wrapper's {fa.HEAD_DIMS}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs, by_shape = {}, {}
    for shape in FLASH_SHAPES + [FLASH_MAIN + (True,)]:
        errs = check_flash_shape(torch, fa, ref, gen, shape, "phase4")
        by_shape[str(list(shape))] = errs
    torch.cuda.empty_cache()

    # timing at the LM path's shape, [B*m*b*H, T, D] bf16 causal
    b, h, t, d, win, cap, dtype = FLASH_MAIN
    timed = flash_timing(torch, fa, ref, gen, b * h, t, d, dtype, bw,
                         bf16_peak, "phase4")
    # and at the new head dims: gemma2-9b's prefill, the LM sweep at 576
    at_d = {}
    for bh, t2, d2, win2, cap2, dt2 in FLASH_HEAD_DIM_TIMED:
        peak = bf16_peak if dt2 == "bfloat16" else fp32_peak
        at_d[f"[{bh},{t2},{d2}] {dt2}"] = flash_timing(
            torch, fa, ref, gen, bh, t2, d2, dt2, bw, peak, "phase4",
            window=win2, cap=cap2)
    # registers and spills by head dim, of both designs
    design = {kk: {f"D={key[1]}": vv for key, vv in sorted(ptxas.items())
                   if key[0] == FLASH_TC[kk]} for kk in timed}
    cores = {kk: {f"D={key[1]}": vv for key, vv in sorted(ptxas.items())
                  if key[0] == FLASH_F32[kk]} for kk in timed}
    for kk, r in timed.items():
        del r["shape"], r["dtype"], r["window"], r["softcap"]
        pick = (lambda e: e["o"]) if kk == "fwd" else (
            lambda e: e["dq"]) if kk == "dq" else (
            lambda e: max(e["dk"], e["dv"]))
        r.update(ptxas=design[kk], ptxas_fp32=cores[kk],
                 max_abs_err=pick(errs),
                 max_abs_err_by_shape={sh: pick(e)
                                       for sh, e in by_shape.items()},
                 head_dim_shapes={sh: v[kk] for sh, v in at_d.items()})
    return timed


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
    if "flash_" in n:
        return "flash attention (CUDA)"
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


def check_agg_shapes(torch, masked, ref, gen, cases, tag, whose):
    """The aggregation against its plain version at each ``((B, m, n),
    ops)`` of ``cases`` (a 2-D route call too where B = 1), with half the
    clients active and with none, within ``FP32_TOL``; with none active,
    OP_MEAN's rows must be ``prev`` exactly. Fails on a mismatch; returns
    the max |err| by case. The inputs lie on ``gen``'s device."""
    dev = gen.device
    errs = {}
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
                print(f"{tag} kernel {label}: max_abs_err {err:.3e} tol "
                      f"{FP32_TOL:g} {'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"kernel disagrees with its plain version at "
                         f"{whose} shape {label}")
    return errs


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
    cases = [((1, 50, 50), [op]) for op in (0, 1, 2)] + [
        ((4, CLIENTS, n_mlp), [0, 0, 1, 2]),
        ((6, CLIENTS, n_mlp), [0, 1, 2, 0, 1, 2])]
    errs = check_agg_shapes(torch, masked, ref, gen, cases, "phase9",
                            "the paper's")
    torch.cuda.synchronize()
    seconds["kernel_vs_plain"] = time.perf_counter() - t0
    fig3_timing = fig3_shape_timing(torch, masked, ref, gen)
    seconds["fig3_shape_timing"] = \
        time.perf_counter() - t0 - sum(seconds.values())
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
    return {"max_abs_err": errs, "fig3_profile": prof,
            "fig3_timing": fig3_timing, "seconds": seconds}


def fig3_shape_timing(torch, masked, ref, gen):
    """The aggregation at Fig. 3's ``[1, 50, 50]`` fp32, the 2-D route
    (``_fused_call_2d``'s counterpart), OP_MEAN with half the clients
    active, timed as phase 1 times the main path's shape: the kernel, the
    plain version and the ``torch.bmm`` yardstick as CUDA-graph replays, the
    bound from the bytes these inputs need at the card's memory rate."""
    dev = torch.device("cuda")
    m, n = 50, 50
    x = torch.randn(1, m, n, generator=gen, device=dev)
    mask = torch.rand(1, m, generator=gen, device=dev) < 0.5
    p = torch.rand(1, m, generator=gen, device=dev)
    prev = torch.randn(1, n, generator=gen, device=dev)
    op = torch.zeros(1, dtype=torch.int32, device=dev)
    two = (x[0], mask[0], op[0], prev[0], p[0])
    kernel_ms = time_ms(lambda: masked.fused_masked_agg(*two))
    plain_ms = time_ms(lambda: ref.fused_masked_agg_ref(*two))
    w = mask.float()[:, None, :]
    library_ms = time_ms(lambda: torch.bmm(w, x))
    bw, flops, _ = peak_rates(torch.cuda.get_device_name(0))
    nbytes, nops = agg_work(x, mask, op)
    bound_ms = max(nbytes / bw, nops / flops) * 1e3
    out = dict(shape=[m, n], ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bytes=nbytes,
               bound_by="bytes" if nbytes / bw >= nops / flops
               else "operations")
    print(f"phase9 timing Fig. 3 shape [1,{m},{n}] fp32, 2-D route, OP_MEAN, "
          f"{int(mask.sum())} of {m} active (device time per call, CUDA "
          f"graph replay): kernel {kernel_ms:.5f} ms, plain {plain_ms:.5f} "
          f"ms, torch.bmm {library_ms:.5f} ms, bound {bound_ms:.7f} ms "
          f"({nbytes} bytes at {bw / 1e12:g} TB/s)", flush=True)
    return out


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

    from repro_torch.experiments import ResultsStore, sweep
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


def _scale_spec(grid, m, strategies, **kw):
    """``benchmarks/scale.py``'s ``_spec`` on the port, seeds 0-2."""
    base = dict(algorithms=("fedpbc",), schemes=(SCALE_SCHEME,),
                seeds=SEEDS, rounds=SCALE_ROUNDS, eval_every=SCALE_ROUNDS,
                num_clients=m, cohort_size=SCALE_C, strategies=strategies,
                local_steps=2, batch_size=16, dim=32, hidden=32,
                n_per_class=200, n_train=1600, per_client=32,
                use_kernel=True)
    base.update(kw)
    return grid.SweepSpec(**base)


def phase10_scale(torch, masked, grid):
    """Cross-device scale on the card: the m ladder, one stateful cohort
    cell, the O(C) memory check and one profiled m = 50,000 round."""
    from unittest import mock

    from repro_torch.core.algorithms import AlgorithmSpec
    from repro_torch.experiments import sweep
    from repro_torch.scale import BUFFER_METRIC_KEYS, SYNC, Strategy

    keys = ("loss", "num_active") + BUFFER_METRIC_KEYS
    arms = (Strategy("sync_cohort"),
            Strategy("buffered", buffer_size=SCALE_BUFFER,
                     deadline_rounds=SCALE_DEADLINE))
    n = 32 * 32 + 32 + 32 * 10 + 10
    dense_bytes = 2 * len(SEEDS) * SCALE_MS[-1] * n * 4
    res = {"ladder": {}, "stateful": {}}
    masked.fused_masked_agg.launches = 0
    t_phase = time.perf_counter()

    def run(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cells = grid.run_cell_batch(spec, "fedpbc", SCALE_SCHEME,
                                    metric_keys=keys)
        torch.cuda.synchronize()
        return cells, time.perf_counter() - t0

    for m in SCALE_MS:
        spec = _scale_spec(grid, m, arms)
        _, cold_s = run(spec)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        captured = {}
        real_loop = sweep.run_rounds_loop

        def capture(st, ds, draws, num_rounds, **kw):
            out = real_loop(st, ds, draws, num_rounds, **kw)
            captured.update(st=out[0], ds=out[1], draws=draws,
                            step=kw["step"])
            return out

        with mock.patch.object(sweep, "run_rounds_loop", capture):
            cells, warm_s = run(spec)
        peak = torch.cuda.max_memory_allocated()
        row = {"cold_s": cold_s, "warm_s": warm_s,
               "rounds_per_s": SCALE_ROUNDS / warm_s,
               "peak_bytes": peak, "bytes_at_reset": base_bytes}
        for arm in arms:
            _, arm_s = run(_scale_spec(grid, m, (arm,)))
            row[f"rounds_per_s_{arm.name}_alone"] = SCALE_ROUNDS / arm_s
        ref = SCALE_REFERENCE[m]
        accs = {}
        for cell in cells:
            acc = cell.test_acc[:, -1].astype(np.float64)
            accs[cell.strategy] = acc
            r = np.asarray(ref[cell.strategy], np.float64)
            tol = FIG3_TOL_STDS * np.sqrt(np.var(r, ddof=1) / len(r)
                                          + np.var(acc, ddof=1) / len(acc))
            diff = abs(acc.mean() - r.mean())
            ok = (diff <= tol and np.isfinite(cell.server).all()
                  and np.isfinite(cell.test_acc).all())
            row[cell.strategy] = {"per_seed": acc.tolist(),
                                  "mean": acc.mean(), "reference": r.mean(),
                                  "tol": tol}
            print(f"phase10 m={m} {cell.strategy}: final test acc "
                  f"{acc.mean():.4f} (per seed {acc.round(4).tolist()}), "
                  f"reference {r.mean():.4f}, |diff| {diff:.4f} tol "
                  f"{tol:.4f} {'ok' if ok else 'OUTSIDE'}", flush=True)
            if not ok:
                fail(f"scale m={m} {cell.strategy}: accuracy outside the "
                     f"reference's bar, or non-finite parameters")
        gap = accs["sync_cohort"].mean() - accs["buffered"].mean()
        ref_gap = np.mean(ref["sync_cohort"]) - np.mean(ref["buffered"])
        buf = cells[1]
        commits = buf.commit.sum(axis=1)
        stale = (buf.commit_staleness * buf.commit).sum(axis=1) \
            / np.maximum(commits, 1.0)
        row.update(gap=gap, reference_gap=ref_gap,
                   commits=commits.tolist(), commit_staleness=stale.tolist())
        print(f"phase10 m={m}: buffered gap {gap:.4f} (reference "
              f"{ref_gap:.4f}); commits per seed {commits.tolist()} "
              f"(reference {list(ref['commits'])}), mean commit staleness "
              f"{stale.round(4).tolist()} (deadline {SCALE_DEADLINE}); "
              f"cold {cold_s:.3f} s, warm {warm_s:.3f} s = "
              f"{row['rounds_per_s']:.2f} rounds/s for both arms "
              f"({2 * len(SEEDS)} trajectories), alone: sync_cohort "
              f"{row['rounds_per_s_sync_cohort_alone']:.2f}, buffered "
              f"{row['rounds_per_s_buffered_alone']:.2f}; peak "
              f"{peak} bytes ({base_bytes} at the reset)", flush=True)
        if gap < 0.5 * ref_gap:
            fail(f"scale m={m}: the buffered arm's gap {gap:.4f} is under "
                 f"half the reference's {ref_gap:.4f}")
        if not (min(ref["commits"]) <= commits.min()
                and commits.max() <= max(ref["commits"])) \
                or stale.max() > SCALE_DEADLINE:
            fail(f"scale m={m}: commits {commits.tolist()} outside the "
                 f"reference's range or staleness over the deadline")
        res["ladder"][m] = row
    if res["ladder"][SCALE_MS[-1]]["peak_bytes"] >= dense_bytes:
        fail(f"the m = {SCALE_MS[-1]} cohort rounds peaked at "
             f"{res['ladder'][SCALE_MS[-1]]['peak_bytes']} bytes, not under "
             f"one dense [B, m, n] fp32 client tensor ({dense_bytes})")
    # one round of the m = 50,000 cell under the profiler, from the state the
    # warm run ended in
    st, ds, draws, step = (captured[k] for k in ("st", "ds", "draws",
                                                  "step"))

    def one_round():
        with torch.no_grad():
            step(st, ds, draws(st.round))

    res["profile"] = profile_window(
        torch, f"phase10 one round at m={SCALE_MS[-1]}, C={SCALE_C}, B="
        f"{2 * len(SEEDS)} (both arms)", one_round, 1, "round")
    del captured, st, ds, draws, step

    # sparse per-client state on the card: rows outside the cohort of one
    # round are bitwise unchanged by it
    real_agg = AlgorithmSpec.aggregate_cohort
    sparse = {}

    def checked(self, algo_id, algo_state, server, x_star, cohort, c_active,
                c_p, t):
        if t != SPARSE_CHECK_ROUND:
            return real_agg(self, algo_id, algo_state, server, x_star,
                            cohort, c_active, c_p, t)
        fields = ("gap", "sum_gaps", "n_gaps", "lam", "mem")
        before = {f: getattr(algo_state, f).clone() for f in fields
                  if getattr(algo_state, f).shape[1]}
        out = real_agg(self, algo_id, algo_state, server, x_star, cohort,
                       c_active, c_p, t)
        outside = torch.ones(before[next(iter(before))].shape[:2],
                             dtype=torch.bool, device=cohort.device)
        outside.scatter_(1, cohort, False)
        sparse[self.names[0]] = {
            f: {"outside_unchanged": torch.equal(
                getattr(out[0], f)[outside], old[outside]),
                "cohort_rows_changed": int(
                    (getattr(out[0], f) != old).reshape(
                        *old.shape[:2], -1).any(-1).sum())}
            for f, old in before.items()}
        return out

    spec = _scale_spec(grid, SCALE_STATEFUL_M, (SYNC,),
                       algorithms=SCALE_STATEFUL, seeds=(0,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(AlgorithmSpec, "aggregate_cohort", checked), \
            _Recorded(grid, "_run_batch") as batches:
        cells = grid.run_sweep(spec, metric_keys=keys)
    torch.cuda.synchronize()
    for cell, (_, _, sec) in zip(cells, batches):
        check = sparse.get(cell.algo, {})
        ok = (bool(check) and all(c["outside_unchanged"]
                                  for c in check.values())
              and np.isfinite(cell.server).all()
              and np.isfinite(cell.test_acc).all())
        res["stateful"][cell.algo] = {
            "test_acc": float(cell.test_acc[0, -1]),
            "rounds_per_s": SCALE_ROUNDS / sec, "sparse_check": check}
        print(f"phase10 stateful {cell.algo} m={SCALE_STATEFUL_M} "
              f"C={SCALE_C}: final test acc {cell.test_acc[0, -1]:.4f}, "
              f"{SCALE_ROUNDS / sec:.2f} rounds/s; round "
              f"{SPARSE_CHECK_ROUND}: {json.dumps(check)} "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"stateful cohort {cell.algo}: a row outside the cohort "
                 f"changed, or non-finite parameters")
    res["stateful_s"] = time.perf_counter() - t0
    res["launches"] = masked.fused_masked_agg.launches
    res["total_s"] = time.perf_counter() - t_phase
    print(f"phase10 fused_masked_agg launches {res['launches']} (expected "
          f"0); total {res['total_s']:.1f} s (limit {PHASE10_LIMIT_S:g} s)",
          flush=True)
    if res["launches"] != 0:
        fail("a scale round launched the aggregation kernel")
    if res["total_s"] > PHASE10_LIMIT_S:
        fail(f"phase 10 took {res['total_s']:.1f} s, over its "
             f"{PHASE10_LIMIT_S:g} s")
    return res


def _max_diff(torch, sweep, a, b):
    """max |a - b| over every leaf of two carry parts of one structure
    (``sweep.map_carry``'s walk); unequal ints, integer or bool tensors,
    shapes or types count as inf."""
    diffs = [0.0]

    def leaf(x, y):
        if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
            diffs.append(0.0 if type(x) is type(y) and x == y
                         else float("inf"))
        elif x.shape != y.shape or x.dtype != y.dtype:
            diffs.append(float("inf"))
        elif not x.is_floating_point():
            diffs.append(0.0 if torch.equal(x, y) else float("inf"))
        elif x.numel():
            diffs.append(float((x - y).abs().max()))
        return x
    sweep.map_carry(leaf, a, b)
    return max(diffs)


def _rows_batch(batch, rows):
    """The batch's columns at ``rows`` (a re-packed batch)."""
    return dataclasses.replace(
        batch, gen_index=[batch.gen_index[i] for i in rows],
        p_base=batch.p_base[rows],
        hparams={k: v[rows] for k, v in batch.hparams.items()},
        data={k: v[rows] for k, v in batch.data.items()},
        algo_id=batch.algo_id[rows])


def phase11_resume(torch, grid, sweep):
    """(a) The segment runner on the card at the asha protocol's batch
    (the first ``ASHA_W`` lrs x seeds 0-1, m = 16, the fused aggregation):
    two chained 8-round segments against one 16-round run; a re-packed
    survivor subset with duplicates against the unsliced continuation; a
    batch of level-1 and level-0 slots (a ``[B]`` round) against each
    row's unmixed run. Returns the max |d| of each (all must be 0)."""
    spec = grid.SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                          seeds=ASHA_SEEDS, rounds=2 * ASHA_RUNG,
                          eval_every=ASHA_RUNG, num_clients=ASHA_M,
                          lrs=ASHA_LRS[:ASHA_W], use_kernel=True)
    task = grid.get_traced_task(spec)
    fed = spec.cell_config("fedpbc", "bernoulli_tv")
    batch = grid.make_cell_batch(spec, fed, task)
    rseg = grid.segment_runner_for(spec, "fedpbc", "bernoulli_tv",
                                   segment_rounds=ASHA_RUNG)
    S = len(ASHA_SEEDS)
    carry, outs = rseg.init(batch), []
    for _ in range(2):
        carry, out = rseg.step(carry, batch)
        outs.append(out)
    st_full, out_full = grid.make_runner(spec, fed, task)(batch)
    chained = {"evals": torch.cat([o["evals"] for o in outs], 1),
               "metrics": {k: torch.cat([o["metrics"][k] for o in outs], 1)
                           for k in out_full["metrics"]}}
    d = {"resume": max(_max_diff(torch, sweep, chained, out_full),
                       _max_diff(torch, sweep, carry[0], st_full))}

    level1, _ = rseg.step(rseg.init(batch), batch)
    order = [2, 1, 2, 2]                    # survivors, one duplicated
    rows = [p * S + i for p in order for i in range(S)]
    (st_r, _, _), out_r = rseg.step(sweep.gather_carry(level1, rows),
                                    _rows_batch(batch, rows))
    (st_u, _, _), out_u = rseg.step(level1, batch)
    d["repack"] = max(
        _max_diff(torch, sweep, out_r["evals"], out_u["evals"][rows]),
        _max_diff(torch, sweep, out_r["metrics"], {k: v[rows] for k, v in
                                            out_u["metrics"].items()}),
        _max_diff(torch, sweep, st_r.server, st_u.server[rows]),
        _max_diff(torch, sweep, st_r.clients, st_u.clients[rows]),
        _max_diff(torch, sweep, st_r.last_active, st_u.last_active[rows]))

    fresh = rseg.init(batch)
    keep = [j < ASHA_W // 2 for j in range(ASHA_W) for _ in range(S)]
    mixed = sweep.select_carry(keep, level1, fresh)
    if not isinstance(mixed[0].round, torch.Tensor):
        fail("a batch of level-1 and level-0 slots has an int round")
    (st_m, _, _), out_m = rseg.step(mixed, batch)
    (st_0, _, _), out_0 = rseg.step(fresh, batch)
    own = torch.tensor(keep, device=st_m.server.device)
    d["mixed"] = 0.0
    for name, a, b0, b1 in (
            ("evals", out_m["evals"], out_0["evals"], out_u["evals"]),
            ("server", st_m.server, st_0.server, st_u.server),
            ("clients", st_m.clients, st_0.clients, st_u.clients),
            ("last_active", st_m.last_active, st_0.last_active,
             st_u.last_active),
            *((k, out_m["metrics"][k], out_0["metrics"][k],
               out_u["metrics"][k]) for k in out_m["metrics"])):
        sel = own.reshape((-1,) + (1,) * (a.dim() - 1))
        d["mixed"] = max(d["mixed"],
                         _max_diff(torch, sweep, a, torch.where(sel, b1, b0)))
    print(f"phase11a resume: two chained {ASHA_RUNG}-round segments vs one "
          f"{2 * ASHA_RUNG}-round run max |d| {d['resume']}; re-packed "
          f"points {order} vs unsliced {d['repack']}; mixed levels "
          f"(rounds {sorted(set(mixed[0].round.tolist()))}) vs each row's "
          f"unmixed run {d['mixed']}", flush=True)
    if any(v != 0.0 for v in d.values()):
        fail(f"resumable segments are not bitwise on the card: {d}")
    return d


def _paired_top(per_seed):
    """The lrs whose per-seed accuracies (``{lr: [n]}``, seeds in one
    order) lie below the best lr's by no more than ``FIG3_TOL_STDS``
    standard errors of their per-seed differences."""
    best = max(per_seed, key=lambda lr: per_seed[lr].mean())
    n = len(per_seed[best])
    out = set()
    for lr, acc in per_seed.items():
        d = np.asarray(per_seed[best], np.float64) - acc
        if d.mean() <= FIG3_TOL_STDS * d.std(ddof=1) / np.sqrt(n):
            out.add(lr)
    return out


def phase11_asha(torch, masked, grid, search):
    """(b) ``paper.asha.run()`` at the reference suite's defaults, with the
    fused aggregation and at the reference's p_base: the suite's own bars
    and the launch identity by arm; then the grid at seeds 0-9 against the
    reference's, each arm's lr against the reference's 10-seed ranking and
    its best accuracy against the port's 10-seed band at that lr."""
    import contextlib
    import io
    from unittest import mock

    from repro_torch.paper import asha

    with open(ASHA_SPREAD) as f:
        spread = json.load(f)
    p_ref = {int(k): v for k, v in spread["p_base"].items()}
    p_ref.update(ASHA_REFERENCE["p_base"])

    def p_base(spec, point):
        if spec.num_clients != ASHA_M or any(
                point[k] != spread["protocol"][k]
                for k in ("alpha", "sigma0", "delta")):
            fail(f"no reference p_base for {point}, m = {spec.num_clients}")
        return np.asarray([p_ref[s] for s in spec.seeds], np.float32)

    arms = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            before = masked.fused_masked_agg.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            arms[name] = {"launches": masked.fused_masked_agg.launches
                          - before, "seconds": time.perf_counter() - t0,
                          "out": out}
            return out
        return wrapper

    csv = io.StringIO()
    before = masked.fused_masked_agg.launches
    t0 = time.perf_counter()
    with mock.patch.object(grid, "point_base_probs", p_base), \
            mock.patch.object(search, "point_base_probs", p_base), \
            mock.patch.object(asha.table2_rounds_to_target, "run", counted(
                "baseline", asha.table2_rounds_to_target.run)), \
            mock.patch.object(asha, "run_cell_batch", counted(
                "grid", asha.run_cell_batch)), \
            mock.patch.object(asha, "run_search", counted(
                "search", asha.run_search)), \
            mock.patch.object(asha, "_resume_probe", counted(
                "probe", asha._resume_probe)), \
            contextlib.redirect_stdout(csv):
        try:
            result = asha.run(use_kernel=True)
        except RuntimeError as e:
            fail(f"paper.asha's bars: {e}")
    seconds = time.perf_counter() - t0
    launches = masked.fused_masked_agg.launches - before
    outcome = arms["search"]["out"]
    n_batches = sum(len(w) for w in outcome.wave_batches)
    expect = {"baseline": ASHA_ROUNDS, "grid": ASHA_ROUNDS,
              "search": n_batches * ASHA_RUNG, "probe": 4 * ASHA_RUNG}
    got = {k: arms[k]["launches"] for k in expect}
    res = {"seconds": seconds, "launches": got, "launches_total": launches,
           "batches": n_batches, "waves": outcome.waves,
           "arm_seconds": {k: v["seconds"] for k, v in arms.items()},
           "compile_entries": result["compile_entries"],
           "grid": result["grid"], "asha": {
               k: v for k, v in result["asha"].items() if k != "wave_log"},
           "target_q75": result["baseline"]["target_q75"],
           "resume_max_abs_diff": result["resume_max_abs_diff"]}
    print(f"phase11b paper.asha.run(): {seconds:.3f} s; aggregation "
          f"launches {json.dumps(got)} = {launches} (expected "
          f"{json.dumps(expect)}: table-2 baseline rounds, grid rounds, "
          f"{n_batches} search batches x {ASHA_RUNG} rounds, the resume "
          f"probe's 2 segments + one {2 * ASHA_RUNG}-round run); "
          f"compile entries {json.dumps(result['compile_entries'])}",
          flush=True)
    if got != expect or launches != sum(expect.values()):
        fail(f"asha's aggregation launches {got} ({launches}), expected "
             f"{expect}")
    # the suite's enforced bars, read back from its result
    if not (result["asha"]["device_rounds"] < result["grid"]["device_rounds"]
            and result["asha"]["best_acc"] >= result["grid"]["best_acc"]
            - 0.02
            and result["asha"]["best_acc"] >= res["target_q75"] - 1e-9
            and result["resume_max_abs_diff"] == 0.0):
        fail(f"asha's bars: {json.dumps(res)}")

    # the protocol's seed spread: the grid at seeds 0-9 beside the
    # reference's
    seeds10 = tuple(spread["protocol"]["seeds"])
    spec10 = grid.SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                            seeds=seeds10, rounds=ASHA_ROUNDS,
                            eval_every=ASHA_RUNG, num_clients=ASHA_M,
                            lrs=ASHA_LRS, use_kernel=True)
    before = masked.fused_masked_agg.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(grid, "point_base_probs", p_base):
        cells10 = grid.run_cell_batch(spec10, "fedpbc", "bernoulli_tv")
    torch.cuda.synchronize()
    res["spread"] = {"seconds": time.perf_counter() - t0,
                     "launches": masked.fused_masked_agg.launches - before,
                     "lrs": {}}
    n10 = len(seeds10)
    port10 = {}
    for c in cells10:
        lr = c.hparams["lr"]
        acc = c.test_acc[:, -3:].mean(axis=1).astype(np.float64)
        last = c.test_acc[:, -1].astype(np.float64)
        ref = spread["final_test_acc"][str(lr)]
        port10[lr] = {"mean": acc.mean(), "std": acc.std(ddof=1),
                      "last_mean": last.mean(),
                      "last_eval_std": last.std(ddof=1), "per_seed": acc}
        tol = FIG3_TOL_STDS * np.sqrt(ref["std"] ** 2 / n10
                                      + port10[lr]["std"] ** 2 / n10)
        diff = abs(acc.mean() - ref["mean"])
        ok = diff <= tol and np.isfinite(c.server).all()
        res["spread"]["lrs"][lr] = dict(
            {k: v for k, v in port10[lr].items() if k != "per_seed"},
            reference=ref["mean"], reference_std=ref["std"], tol=tol)
        print(f"phase11b seeds 0-{n10 - 1} lr {lr:g}: final test acc "
              f"{acc.mean():.4f} (std {acc.std(ddof=1):.4f}), reference "
              f"{ref['mean']:.4f} (std {ref['std']:.4f}), |diff| "
              f"{diff:.4f} tol {tol:.4f} {'ok' if ok else 'OUTSIDE'}",
              flush=True)
        if not ok:
            fail(f"asha grid at seeds 0-{n10 - 1}, lr {lr}: outside the "
                 f"reference's bar")
    if res["spread"]["launches"] != ASHA_ROUNDS:
        fail(f"the seeds 0-{n10 - 1} grid launched the aggregation "
             f"{res['spread']['launches']} times")

    # the lr each arm picks: one the reference's 10 seeds rank at the top.
    # The lrs of a seed share its draws, so the ranking is read from the
    # per-seed differences to the top lr (their spread is far below the
    # seeds' spread); then each arm's best accuracy (2 seeds) against the
    # port's 10-seed band at its lr
    S = len(ASHA_SEEDS)
    grid_cells = arms["grid"]["out"]
    port_best_lr = {
        "grid": max(grid_cells, key=lambda c: c.test_acc[:, -3:].mean(
            axis=1).mean()).hparams["lr"],
        "asha": outcome.best.point["lr"]}
    ref10 = {float(lr): np.asarray(v["per_seed"], np.float64)
             for lr, v in spread["final_test_acc"].items()}
    tops = {"reference": _paired_top(ref10),
            "port": _paired_top({lr: v["per_seed"]
                                 for lr, v in port10.items()})}
    ref_top = max(ref10, key=lambda lr: ref10[lr].mean())
    res["top_lrs"] = {k: sorted(v) for k, v in tops.items()}
    print(f"phase11b lrs at the top of 10 seeds (per-seed differences to "
          f"the best lr within {FIG3_TOL_STDS:g} standard errors): "
          f"reference {sorted(tops['reference'])}, port "
          f"{sorted(tops['port'])}", flush=True)
    if ref_top not in tops["port"]:
        fail(f"the reference's best lr {ref_top} is not at the top of the "
             f"port's 10 seeds {sorted(tops['port'])}")
    for arm, key, col in (("grid", "mean", "std"),
                          ("asha", "last_mean", "last_eval_std")):
        lr = port_best_lr[arm]
        got_acc = result[arm]["best_acc"]
        band = FIG3_TOL_STDS * port10[lr][col] / np.sqrt(S)
        diff = abs(got_acc - port10[lr][key])
        ok = (lr in tops["reference"] and diff <= band
              and np.isfinite(got_acc))
        res[arm].update(best_lr=lr, reference_best_acc=ASHA_REFERENCE[
            f"{arm}_best"], band_center=port10[lr][key], band=band)
        print(f"phase11b {arm}: best acc {got_acc:.4f} at lr {lr:g} "
              f"({'at' if lr in tops['reference'] else 'NOT at'} the "
              f"reference's top); the port's 10 seeds there {key} "
              f"{port10[lr][key]:.4f}, |diff| {diff:.4f} band {band:.4f} "
              f"({FIG3_TOL_STDS:g} x {col} {port10[lr][col]:.4f} / "
              f"sqrt({S})); reference best {ASHA_REFERENCE[arm + '_best']:.4f}"
              f"; device rounds {result[arm]['device_rounds']} (reference "
              f"{ASHA_REFERENCE[arm + '_device_rounds']}) "
              f"{'ok' if ok else 'OUTSIDE'}", flush=True)
        if not ok:
            fail(f"asha {arm}: best lr {lr} or its accuracy {got_acc:.4f} "
                 f"outside the 10-seed bars")
    print(f"phase11b statuses {json.dumps(result['asha']['statuses'])} "
          f"(reference {json.dumps(ASHA_REFERENCE['asha_statuses'])}), "
          f"{outcome.waves} waves, {n_batches} batches, target q75 "
          f"{res['target_q75']:.4f} (reference "
          f"{ASHA_REFERENCE['target_q75']:.4f}), ASHA reached it at "
          f"{result['asha']['device_rounds_to_target']} device rounds",
          flush=True)
    return res


def phase11_refill(torch, masked, grid, search):
    """(c) A refill search at the main path's width into a temporary
    store: waves timed, mixed-level batches counted, the best finished
    candidate against phase 2's bar, store rows and curves; then one wave
    of one batch under ``torch.profiler``."""
    import tempfile

    from repro_torch.experiments import ResultsStore, sweep
    from repro_torch.experiments.plots import export_curves
    from repro_torch.experiments.results import cell_key

    base = grid.SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                          seeds=SEEDS, rounds=REFILL_ROUNDS,
                          eval_every=REFILL_RUNG, num_clients=CLIENTS,
                          use_kernel=True)
    spec = search.SearchSpec(base=base, rung_rounds=REFILL_RUNG, eta=2,
                             num_candidates=REFILL_CANDIDATES,
                             batch_points=REFILL_W, space=REFILL_SPACE,
                             refill=True, max_candidates=REFILL_MAX,
                             search_seed=0)
    runner = grid.segment_runner_for(base, "fedpbc", "bernoulli_tv",
                                     segment_rounds=REFILL_RUNG)
    stamps, real_step = [], runner.step

    def timed_step(carry, batch):
        stamps.append(time.perf_counter())
        return real_step(carry, batch)

    before = masked.fused_masked_agg.launches
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultsStore(os.path.join(tmp, "search"))
        runner.step = timed_step
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = search.run_search(spec, store=store, suite="refill")
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            runner.step = real_step
        launches = masked.fused_masked_agg.launches - before
        rows = store.records(suite="refill")
        keys = {cell_key(r) for r in rows}
        curves = export_curves(store, os.path.join(tmp, "curves"),
                               suite="refill")
    n_batches = [len(w) for w in out.wave_batches]
    starts = np.cumsum([0] + n_batches[:-1])
    waves = []
    for i, (first, n) in enumerate(zip(starts, n_batches)):
        end = stamps[starts[i + 1]] if i + 1 < len(n_batches) else t_end
        sec = end - stamps[first]
        waves.append({"batches": n, "seconds": sec,
                      "rounds_per_s": n * REFILL_RUNG / sec,
                      "levels": [list(b) for b in out.wave_batches[i]]})
    finished = [c for c in out.candidates if c.status == "finished"]
    best = max(finished, key=lambda c: c.last_eval)
    grid_rounds = len(out.candidates) * len(SEEDS) * REFILL_ROUNDS
    res.update(
        seconds=t_end - t0, launches=launches, waves=waves,
        mixed_batches=out.mixed_batches, candidates=len(out.candidates),
        statuses={s: sum(c.status == s for c in out.candidates)
                  for s in ("pruned", "finished", "stopped")},
        total_device_rounds=out.total_device_rounds,
        grid_device_rounds=grid_rounds,
        best={"cid": best.cid, "lr": best.point["lr"],
              "last_eval": best.last_eval, "level": best.level},
        compile_entries=out.compile_entries, store_rows=len(rows),
        distinct_cell_keys=len(keys), curves=len(curves))
    rates = [w["rounds_per_s"] for w in waves]
    print(f"phase11c refill search [{REFILL_W * len(SEEDS)}, {CLIENTS}, "
          f"2762]: {res['seconds']:.3f} s, {out.waves} waves, "
          f"{sum(n_batches)} batches ({out.mixed_batches} mixing budget "
          f"levels), {len(out.candidates)} candidates "
          f"{json.dumps(res['statuses'])}; device rounds "
          f"{out.total_device_rounds} vs the grid's {grid_rounds}; batch "
          f"rounds/s per wave {min(rates):.2f}-{max(rates):.2f} (median "
          f"{float(np.median(rates)):.2f}); best finished cid {best.cid} lr "
          f"{best.point['lr']:.4f} eval {best.last_eval:.4f} (bar "
          f"{BARS['fedpbc']:.4f}); aggregation launches {launches} (expected "
          f"{sum(n_batches) * REFILL_RUNG}); store {len(rows)} rows, "
          f"{len(keys)} cell keys, {len(curves)} curves; compile entries "
          f"{json.dumps(out.compile_entries)}", flush=True)
    if out.mixed_batches < 1:
        fail("the refill search dispatched no batch mixing budget levels")
    if best.last_eval < BARS["fedpbc"] or not np.isfinite(best.last_eval):
        fail(f"the refill search's best finished candidate {best.last_eval}"
             f" is under phase 2's bar {BARS['fedpbc']:.4f}")
    if launches != sum(n_batches) * REFILL_RUNG:
        fail(f"refill search launched the aggregation {launches} times")
    if not (len(rows) == len(keys) == len(out.candidates)
            and len(curves) == 2 * len(out.candidates)):
        fail("the refill search's store rows, cell keys or curves are off")
    if out.total_device_rounds >= grid_rounds:
        fail("the refill search spent no fewer device rounds than its grid")
    # one wave of one full-width batch under the profiler
    pts = dataclasses.replace(base, lrs=tuple(
        c.point["lr"] for c in out.candidates[:REFILL_W]))
    task = grid.get_traced_task(pts)
    fed = pts.cell_config("fedpbc", "bernoulli_tv")
    batch = grid.make_cell_batch(pts, fed, task)
    carry = runner.init(batch)
    shape = f"[{REFILL_W * len(SEEDS)}, {CLIENTS}, 2762]"
    res["profile"] = profile_window(
        torch, f"phase11c one wave ({REFILL_RUNG} rounds of one level-0 "
        f"{shape} batch, an int round)",
        lambda: runner.step(carry, batch), REFILL_RUNG, "round")
    # and a batch mixing levels as refill packs it: the first half of the
    # points survivors at level 1, the rest fresh, a [B] round
    level1, _ = runner.step(carry, batch)
    keep = [j < REFILL_W // 2 for j in range(REFILL_W) for _ in SEEDS]
    mixed = sweep.select_carry(keep, level1, carry)
    res["profile_mixed"] = profile_window(
        torch, f"phase11c one wave ({REFILL_RUNG} rounds of one {shape} "
        f"batch mixing levels 1 and 0, a [B] round)",
        lambda: runner.step(mixed, batch), REFILL_RUNG, "round")
    return res


def phase11_search(torch, masked, ref, grid):
    """Adaptive search on the card: the aggregation against its plain
    version at the search's shapes; (a) resume, re-pack and a mixed batch
    bitwise; (b) the ASHA-vs-grid suite; (c) a refill search at the main
    path's width. Held to ``PHASE11_LIMIT_S``."""
    from repro_torch.experiments import search, sweep

    # the aggregation against its plain version at this path's shapes,
    # before the counts are reset: asha's [8, 16, 2762] (m = 16) and the
    # refill search's [24, 100, 2762]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    t_phase = time.perf_counter()
    n_mlp = 32 * 64 + 64 + 64 * 10 + 10
    errs = check_agg_shapes(
        torch, masked, ref, gen,
        [((ASHA_W * len(ASHA_SEEDS), ASHA_M, n_mlp), [0, 1, 2] * 2 + [0, 1]),
         ((REFILL_W * len(SEEDS), CLIENTS, n_mlp), [0, 1, 2] * 8)],
        "phase11", "the search's")
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t_phase
    masked.fused_masked_agg.launches = 0
    res = {"kernel_max_abs_err": errs, "kernel_check_s": check_s,
           "resume": phase11_resume(torch, grid, sweep)}
    res["resume_launches"] = masked.fused_masked_agg.launches
    res["asha"] = phase11_asha(torch, masked, grid, search)
    res["refill"] = phase11_refill(torch, masked, grid, search)
    res["total_s"] = time.perf_counter() - t_phase
    print(f"phase11 total {res['total_s']:.1f} s (limit "
          f"{PHASE11_LIMIT_S:g} s)", flush=True)
    if res["total_s"] > PHASE11_LIMIT_S:
        fail(f"phase 11 took {res['total_s']:.1f} s, over its "
             f"{PHASE11_LIMIT_S:g} s")
    return res


def _counted(torch, counters, fn):
    """``fn()`` with the counts set to 0 just before it and read just
    after: ``(result, wall seconds, launches, peak device bytes)``."""
    for c in counters:
        c.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, [c.launches for c in counters],
            torch.cuda.max_memory_allocated())


def _lm_cell(torch, grid, spec, counters, label, task=None):
    """One LM-sweep family batch through ``make_runner``: a cold run, then
    a warm one counted and timed (the runner alone, as
    ``benchmarks/lm_sweep.py`` times it). Fails on a non-finite loss or
    parameter; returns ``(states, out, row)``."""
    fed = spec.cell_config(spec.algorithms[0], spec.schemes[0])
    task = task or grid.get_traced_task(spec)
    batch = grid.make_cell_batch(spec, fed, task, algos=spec.algorithms)
    runner = grid.make_runner(spec, fed, task)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(batch)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    (st, out), sec, launches, peak = _counted(torch, counters,
                                              lambda: runner(batch))
    B = batch.batch_size
    m = spec.cohort_size or spec.num_clients
    tokens = B * m * spec.local_steps * spec.batch_size * spec.lm_seq
    loss = out["metrics"]["loss"]
    row = dict(B=B, n_params=task.layout.size, cold_s=cold, warm_s=sec,
               trajectory_rounds_per_s=B * spec.rounds / sec,
               batch_rounds_per_s=spec.rounds / sec,
               tokens_per_round=tokens,
               tokens_per_s=tokens * spec.rounds / sec,
               peak_gib=peak / 2 ** 30, launches=launches,
               final_loss=loss[:, -1].tolist())
    print(f"{label}: B={B}, n={task.layout.size}, {spec.rounds} rounds: "
          f"cold {cold:.3f} s, warm {sec:.3f} s = "
          f"{row['trajectory_rounds_per_s']:.2f} trajectory rounds/s "
          f"({row['batch_rounds_per_s']:.2f} batch rounds/s), "
          f"{row['tokens_per_s']:.1f} training tokens/s ({tokens} a round); "
          f"peak {row['peak_gib']:.3f} GiB; launches flash fwd "
          f"{launches[0]}, bwd_dq {launches[1]}, bwd_dkdv {launches[2]}, "
          f"fused_masked_agg {launches[3]}", flush=True)
    if not (torch.isfinite(loss).all() and torch.isfinite(st.server).all()):
        fail(f"{label}: a non-finite loss or parameter")
    return st, out, row


def _want_launches(spec, evals):
    """(flash fwd, dq, dkdv, aggregation) launches of one LM-sweep batch
    run: a forward per layer per local step and per eval forward, dq and
    dkdv per layer per local step, the aggregation once a round (none in
    cohort mode: the scale round aggregates by the buffer fold)."""
    L, steps = spec.lm_layers, spec.local_steps * spec.rounds
    return [L * (steps + evals), L * steps, L * steps,
            0 if spec.cohort_size else spec.rounds]


def phase12_lm_sweep(torch, fa, masked, ref, grid, bw, fp32_peak):
    """The LM sweep task on the card: the kernels at its shapes against
    their plain versions, then the lm-family, lm-cohort and lm-wide
    cells."""
    from unittest import mock

    from repro_torch.experiments import sweep, tasks
    from repro_torch.kernels.dispatch import FUSED_OPS

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    family = grid.SweepSpec(**LM_SWEEP)
    wide = dataclasses.replace(family, **LM_WIDE)
    cohort = dataclasses.replace(family, **LM_COHORT)
    at_576 = dataclasses.replace(family, **LM_576)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv, masked.fused_masked_agg)
    res = {"kernels": {}}

    # (a) the kernels at the sweep's shapes
    n_family = grid.get_traced_task(family).layout.size
    n_wide = grid.get_traced_task(wide).layout.size
    agg_cases = []
    for spec, n in ((family, n_family), (wide, n_wide)):
        ops = [FUSED_OPS[a] for a in spec.algorithms for _ in spec.lrs]
        agg_cases.append(((len(ops), spec.num_clients, n), ops))
    res["kernels"]["fused_masked_agg_max_abs_err"] = check_agg_shapes(
        torch, masked, ref, gen, agg_cases, "phase12a", "the LM sweep's")
    res["kernels"]["fused_masked_agg"] = {}
    for (B, m, n), ops in agg_cases:
        args = (torch.randn(B, m, n, generator=gen, device=dev),
                torch.rand(B, m, generator=gen, device=dev) < 0.5,
                torch.as_tensor(ops, dtype=torch.int32, device=dev),
                torch.randn(B, n, generator=gen, device=dev),
                torch.rand(B, m, generator=gen, device=dev))
        t = time_agg(torch, masked, ref, args, bw, fp32_peak, iters=20)
        print(f"phase12a timing fused_masked_agg [{B},{m},{n}] fp32 ops "
              f"{ops}: kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} "
              f"ms, torch.bmm {t['library_ms']:.5f} ms, bound "
              f"{t['bound_ms']:.5f} ms ({t['bytes']} bytes at "
              f"{bw / 1e12:g} TB/s)", flush=True)
        res["kernels"]["fused_masked_agg"][f"[{B},{m},{n}]"] = t
        del args
    torch.cuda.empty_cache()
    res["kernels"]["flash"] = {}
    for spec in (family, wide):
        # the LM's [G * b * H, T, D]: G = B * m models, b sequences, 4 heads
        d = spec.lm_d_model // 4
        G = len(spec.algorithms) * len(spec.lrs) * spec.num_clients
        bh = G * spec.batch_size * 4
        errs = check_flash_shape(
            torch, fa, ref, gen,
            (G * spec.batch_size, 4, spec.lm_seq, d, 0, 0.0, "float32",
             True), "phase12a")
        timed = flash_timing(torch, fa, ref, gen, bh, spec.lm_seq, d,
                             "float32", bw, fp32_peak, "phase12a")
        for kk, r in timed.items():
            r["max_abs_err"] = (errs["o"] if kk == "fwd" else errs["dq"]
                                if kk == "dq" else max(errs["dk"],
                                                       errs["dv"]))
        res["kernels"]["flash"][f"D={d}"] = timed
    print(f"phase12a kernel checks done at "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # (b) lm-family: the timed cell (seed 0), then the kernel path against
    # the plain one, then seeds 0-2 against the reference's bars
    E = len(sweep.eval_rounds(family.rounds, family.eval_every))
    st_k, out_k, row = _lm_cell(torch, grid, family, counters,
                                "phase12b lm-family (kernels)")
    if row["launches"] != _want_launches(family, E):
        fail(f"lm-family launches {row['launches']}, expected "
             f"{_want_launches(family, E)}")
    plain_spec = dataclasses.replace(family, use_kernel=False)
    meta = grid.get_traced_task(family).meta
    plain_task = tasks.make_traced_lm_task(
        data_seed=family.data_seed, num_clients=family.num_clients,
        arch=family.lm_arch, d_model=family.lm_d_model,
        layers=family.lm_layers, seq_len=family.lm_seq,
        classes=family.classes, n_seqs=family.lm_n_seqs,
        n_test=family.lm_n_test, per_client=family.per_client,
        local_steps=family.local_steps, batch_size=family.batch_size,
        device=dev, backend="torch")
    assert plain_task.meta == meta
    st_p, out_p, row_p = _lm_cell(torch, grid, plain_spec, counters,
                                  "phase12b lm-family (plain path)",
                                  task=plain_task)
    rows = (st_k.server - st_p.server).abs().amax(-1)
    loss_d = (out_k["metrics"]["loss"] - out_p["metrics"]["loss"]).abs()
    print(f"phase12b kernel vs plain path, 10 rounds: largest |server diff| "
          f"of a trajectory {rows.max().item():.3e} (by row "
          f"{[float(f'{x:.3e}') for x in rows.tolist()]}), loss "
          f"{loss_d.max().item():.3e}; tol {LM_PATHS_TOL:g}; plain path "
          f"launches {row_p['launches']}", flush=True)
    if row_p["launches"] != [0, 0, 0, 0] or not rows.max() <= LM_PATHS_TOL:
        fail("the LM sweep's kernel and plain paths diverge, or the plain "
             "path launched a kernel")
    res["family"] = dict(row, plain=row_p,
                         paths_max_row_diff=rows.max().item(),
                         paths_loss_diff=loss_d.max().item())
    cells = grid.run_sweep(dataclasses.replace(family, seeds=(0, 1, 2)))
    by = {}
    for cell in cells:
        if not (np.isfinite(cell.loss).all() and np.isfinite(cell.server).all()
                and np.isfinite(cell.test_acc).all()):
            fail(f"lm-family seeds 0-2 {cell.algo}: non-finite results")
        by.setdefault(cell.algo, {})[cell.hparams["lr"]] = cell
    res["family"]["bars"] = {}
    for algo, lrs in by.items():
        acc = np.mean([c.final_test() for c in lrs.values()],
                      axis=0).astype(np.float64)
        ref_acc = np.mean([LM_SWEEP_REFERENCE[algo][lr][0]
                           for lr in lrs], axis=0)
        tol = FIG3_TOL_STDS * np.sqrt(np.var(ref_acc, ddof=1) / 3
                                      + np.var(acc, ddof=1) / 3)
        diff = abs(acc.mean() - ref_acc.mean())
        losses = {lr: c.loss[:, -1].astype(np.float64).round(4).tolist()
                  for lr, c in lrs.items()}
        ref_losses = {lr: LM_SWEEP_REFERENCE[algo][lr][1] for lr in lrs}
        ok = diff <= tol
        print(f"phase12b lm-family {algo}: final test acc (mean over lrs "
              f"{sorted(lrs)}) {acc.mean():.6f} (per seed "
              f"{acc.round(6).tolist()}), reference {ref_acc.mean():.6f}, "
              f"|diff| {diff:.6f} tol {tol:.6f} {'ok' if ok else 'OUTSIDE'};"
              f" last-round loss by lr {losses}, reference {ref_losses}",
              flush=True)
        res["family"]["bars"][algo] = dict(
            per_seed=acc.tolist(), mean=acc.mean(),
            reference=ref_acc.mean(), tol=tol, losses=losses)
        if not ok:
            fail(f"lm-family {algo}: accuracy outside the reference's bar")
    del cells, by, st_k, st_p, out_k, out_p, plain_task

    # (c) lm-cohort
    E = len(sweep.eval_rounds(cohort.rounds, cohort.eval_every))
    st, _, row = _lm_cell(torch, grid, cohort, counters,
                          "phase12c lm-cohort (m=10,000, C=256)")
    if row["launches"] != _want_launches(cohort, E):
        fail(f"lm-cohort launches {row['launches']}, expected "
             f"{_want_launches(cohort, E)}")
    res["cohort"] = row
    del st

    # (d) lm-wide, and one of its rounds under the profiler
    E = len(sweep.eval_rounds(wide.rounds, wide.eval_every))
    captured = {}
    real_loop = sweep.run_rounds_loop

    def capture(st, ds, draws, num_rounds, **kw):
        out = real_loop(st, ds, draws, num_rounds, **kw)
        captured.update(st=out[0], ds=out[1], draws=draws, step=kw["step"])
        return out

    with mock.patch.object(sweep, "run_rounds_loop", capture):
        _, _, row = _lm_cell(torch, grid, wide, counters,
                             "phase12d lm-wide (d_model 512, 4 layers, "
                             "T=256, m=8)")
    if row["launches"] != _want_launches(wide, E):
        fail(f"lm-wide launches {row['launches']}, expected "
             f"{_want_launches(wide, E)}")
    st, ds, draws, step = (captured[k] for k in ("st", "ds", "draws",
                                                  "step"))

    def one_round():
        with torch.no_grad():
            step(st, ds, draws(st.round))

    row["profile"] = profile_window(
        torch, f"phase12d one lm-wide round (B={row['B']})", one_round, 1,
        "round")
    res["wide"] = row
    del captured, st, ds, draws, step
    gc.collect()
    torch.cuda.empty_cache()

    # (e) lm-576: head dim 144 through the fp32 flash kernels, against the
    # plain attention and the branch aggregation from the same generators
    E = len(sweep.eval_rounds(at_576.rounds, at_576.eval_every))
    st_k, out_k, row = _lm_cell(torch, grid, at_576, counters,
                                "phase12e lm-576 (d_model 576, head dim "
                                "144; kernels)")
    if row["launches"] != _want_launches(at_576, E):
        fail(f"lm-576 launches {row['launches']}, expected "
             f"{_want_launches(at_576, E)}")
    plain_task = tasks.make_traced_lm_task(
        data_seed=at_576.data_seed, num_clients=at_576.num_clients,
        arch=at_576.lm_arch, d_model=at_576.lm_d_model,
        layers=at_576.lm_layers, seq_len=at_576.lm_seq,
        classes=at_576.classes, n_seqs=at_576.lm_n_seqs,
        n_test=at_576.lm_n_test, per_client=at_576.per_client,
        local_steps=at_576.local_steps, batch_size=at_576.batch_size,
        device=dev, backend="torch")
    st_p, out_p, row_p = _lm_cell(
        torch, grid, dataclasses.replace(at_576, use_kernel=False), counters,
        "phase12e lm-576 (plain path)", task=plain_task)
    rows = (st_k.server - st_p.server).abs().amax(-1)
    print(f"phase12e lm-576 kernel vs plain path, {at_576.rounds} rounds: "
          f"largest |server diff| of a trajectory {rows.max().item():.3e}; "
          f"tol {LM_PATHS_TOL:g}; flash launches fwd / dq / dkdv "
          f"{row['launches'][:3]} (plain path {row_p['launches']})",
          flush=True)
    if row_p["launches"] != [0, 0, 0, 0] or not rows.max() <= LM_PATHS_TOL:
        fail("lm-576: the kernel and plain paths diverge, or the plain "
             "path launched a kernel")
    res["d_model_576"] = dict(row, plain=row_p,
                              paths_max_row_diff=rows.max().item())
    del st_k, st_p, out_k, out_p, plain_task
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase12 done in {res['seconds']:.1f} s (limit "
          f"{PHASE12_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE12_LIMIT_S:
        fail(f"phase 12 took {res['seconds']:.1f} s, over its "
             f"{PHASE12_LIMIT_S:g} s")
    return res


def phase13_dense_serving(torch, fa, ref, card):
    """SmolLM-135M at full width through the serve launcher, and teacher
    forcing: forward through the flash kernel and the plain attention
    against TF_T decode_step calls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    cfg = get_config("smollm-135m")
    a = cfg.attention
    res = {}
    # the forward's flash kernel at the teacher-forcing shape [9, 256, 64]
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    res["flash_tc_max_abs_err"] = check_flash_shape(
        torch, fa, ref, gen, (1, a.num_heads, TF_T, cfg.head_dim, 0, 0.0,
                              "bfloat16", True), "phase13")
    args = ["--arch", "smollm-135m", "--full", "--batch", str(SERVE_B)]
    params = model.init_leaves(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    res["profile"] = profile_window(
        torch, f"phase13a serve smollm-135m (batch {SERVE_B}, prompt "
        f"{SERVE_PROFILE_P}, gen {SERVE_PROFILE_G})", lambda: serve.main(
            args + ["--prompt-len", str(SERVE_PROFILE_P), "--gen",
                    str(SERVE_PROFILE_G)], params=params),
        SERVE_PROFILE_P + SERVE_PROFILE_G, "step")
    del params
    print(f"phase13a profiled run done at {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    out, _, launches, peak = _counted(torch, counters, lambda: serve.main(
        args + ["--prompt-len", str(SERVE_P), "--gen", str(SERVE_G)]))
    decode_s = out["seconds"] - out["prefill_seconds"]
    steps = SERVE_P + SERVE_G
    print(f"phase13a serve smollm-135m --full batch {SERVE_B} prompt "
          f"{SERVE_P} gen {SERVE_G} on {card}: {out['seconds']:.4f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s incl. prefill (prefill "
          f"{out['prefill_seconds']:.4f} s, decode "
          f"{SERVE_B * SERVE_G / decode_s:.1f} tokens/s, "
          f"{1e3 * out['seconds'] / steps:.3f} ms per step); first ids "
          f"{out['ids'][0][:12].tolist()}; flash launches {launches} (want "
          f"0: decode_step calls no kernel); peak memory "
          f"{peak / 2 ** 30:.3f} GiB; done at "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if tuple(out["ids"].shape) != (SERVE_B, SERVE_G) or not (
            (out["ids"] >= 0) & (out["ids"] < cfg.vocab_size)).all():
        fail("the served ids are misshapen or out of the vocabulary")
    if launches != [0, 0, 0]:
        fail(f"decode_step launched flash kernels {launches}")
    res.update(serve_s=out["seconds"], tokens_per_s=out["tokens_per_s"],
               prefill_s=out["prefill_seconds"],
               decode_tokens_per_s=SERVE_B * SERVE_G / decode_s,
               ms_per_step=1e3 * out["seconds"] / steps,
               peak_gib=peak / 2 ** 30, serve_flash_launches=launches,
               first_ids=out["ids"][0][:12].tolist())
    del out
    toks = torch.randint(0, cfg.vocab_size, (1, TF_T),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    res["teacher_forcing"] = {}
    for dtype, layers, tol in TF_CASES:
        c = dataclasses.replace(cfg, dtype=dtype, num_layers=layers)
        params = model.init_leaves(
            torch.Generator(device=dev).manual_seed(0), c)
        res["teacher_forcing"][f"{dtype}_{layers}_layers"] = dict(
            _teacher_forcing(torch, fa, model, params, c, toks, "phase13b",
                             tol), done_at_s=time.perf_counter() - t_phase)
        del params
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase13 done in {res['seconds']:.1f} s (limit "
          f"{PHASE13_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE13_LIMIT_S:
        fail(f"phase 13 took {res['seconds']:.1f} s, over its "
             f"{PHASE13_LIMIT_S:g} s")
    return res


def _picks(moe_mod, fn):
    """``fn()`` with every MoE layer's top-k expert picks recorded, in call
    order: ``(fn(), [idx [B, T, k], ...])``."""
    from unittest import mock

    picks, real = [], moe_mod._router

    def record(p, x, c):
        out = real(p, x, c)
        picks.append(out[0])
        return out

    with mock.patch.object(moe_mod, "_router", record):
        return fn(), picks


def _teacher_forcing(torch, fa, model, params, cfg, toks, label, tol):
    """``forward`` on ``toks [1, T]`` through the flash kernel and through
    the plain attention against T ``decode_step`` calls: max |decode -
    forward| / max |forward| of each, and kernel vs plain; fails past
    ``tol`` (None: measured). For an MoE model also the (layer, token)
    pairs whose top-k experts differ between the paths: in bf16 a hidden
    state that rounds otherwise may tip a near tie of the router."""
    from repro_torch.models import moe as moe_mod

    dev = toks.device
    T = toks.shape[1]
    # the flash kernel takes the full and swa layers (``dispatch.attention``)
    layers = sum(model.attn_kind(cfg, i) in ("full", "swa")
                 for i in range(cfg.num_layers))
    picks = {}
    with torch.no_grad():
        fwd = {}
        for path, backend in (("kernel", None), ("plain", "torch")):
            fa.flash_attention_fwd.launches = 0
            (fwd[path], _), picks[path] = _picks(moe_mod, lambda: (
                model.forward(params, cfg, toks, backend=backend)))
            want = layers if path == "kernel" else 0
            if fa.flash_attention_fwd.launches != want:
                fail(f"{label}: the {path} forward launched the flash "
                     f"kernel {fa.flash_attention_fwd.launches} times, "
                     f"expected {want}")

        def decode():
            cache = model.make_cache(cfg, 1, T, device=dev)
            outs = []
            for t in range(T):
                lg, cache = model.decode_step(params, cfg, toks[:, t:t + 1],
                                              cache, t)
                outs.append(lg[:, 0])
            return torch.stack(outs, 1)

        fa.flash_attention_fwd.launches = 0
        dec, picks["decode"] = _picks(moe_mod, decode)
    if fa.flash_attention_fwd.launches != 0:
        fail("decode_step launched the flash kernel")
    rel = {path: ((dec - f).abs().max() / f.abs().max()).item()
           for path, f in fwd.items()}
    rel["kernel_vs_plain"] = ((fwd["kernel"] - fwd["plain"]).abs().max()
                              / fwd["plain"].abs().max()).item()
    flips = ""
    if cfg.moe:
        L = len(picks["plain"])

        def by_layer(ps):      # [L, T, k], each row's experts sorted
            if len(ps) == L * T:                  # decode: step-major
                ps = [torch.cat(ps[layer::L], 1) for layer in range(L)]
            return torch.stack(ps)[:, 0].sort(-1).values

        want = by_layer(picks["plain"])
        rel["routing_flips"] = {
            path: int((by_layer(picks[path]) != want).any(-1).sum())
            for path in ("kernel", "decode")}
        flips = (f"; (layer, token) pairs routed otherwise than the plain "
                 f"forward: kernel forward {rel['routing_flips']['kernel']}"
                 f", decode {rel['routing_flips']['decode']} of {L * T}")
    ok = torch.isfinite(dec).all().item() and (
        tol is None or (rel["kernel"] <= tol and rel["plain"] <= tol))
    print(f"{label} teacher forcing {cfg.dtype}, {cfg.num_layers} layers, "
          f"[1, {T}]: max |decode - forward| / max |forward|: through the "
          f"flash kernel {rel['kernel']:.3e}, plain attention "
          f"{rel['plain']:.3e} (limit "
          f"{'none, measured' if tol is None else f'{tol:g}'}); kernel vs "
          f"plain forward {rel['kernel_vs_plain']:.3e}{flips} "
          f"{'ok' if ok else 'OUTSIDE'}", flush=True)
    if not ok:
        fail(f"{label}: teacher forcing ({cfg.dtype}, {cfg.num_layers} "
             f"layers): decode and forward disagree")
    return dict(rel, limit=tol)


def _first_periods(params, n):
    """The leaves of a model's first ``n`` periods (views)."""
    return {k: v[:n] if k.startswith("blocks.") else v
            for k, v in params.items()}


def phase14_gemma2(torch, fa, card):
    """gemma2-9b at full width and depth: the serve launcher, a forward
    past the window through flash_fwd_tc at D = 256, the same at 2 layers
    against the plain attention, and teacher forcing."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    cfg = get_config("gemma2-9b")
    if cfg.num_layers != GEMMA_LAYERS or cfg.head_dim != 256:
        fail("gemma2-9b's config is not the published one")
    res = {"n_params": cfg.param_count()}
    params, res["init_s"], _, _ = _counted(torch, counters, lambda: (
        model.init_leaves(torch.Generator(device=dev).manual_seed(0), cfg)))
    print(f"phase14 gemma2-9b: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.attention.num_heads} heads of "
          f"{cfg.head_dim} on {cfg.attention.num_kv_heads} KV heads, "
          f"{res['n_params']} parameters bf16, seeded in "
          f"{res['init_s']:.2f} s", flush=True)
    b, p_len, g_len = GEMMA_SERVE
    args = ["--arch", "gemma2-9b", "--full", "--batch", str(b)]
    res["profile"] = profile_window(
        torch, f"phase14a serve gemma2-9b (batch {b}, prompt 4, gen 4)",
        lambda: serve.main(args + ["--prompt-len", "4", "--gen", "4"],
                           params=params), 8, "step")
    out, _, launches, peak = _counted(torch, counters, lambda: serve.main(
        args + ["--prompt-len", str(p_len), "--gen", str(g_len)],
        params=params))
    decode_s = out["seconds"] - out["prefill_seconds"]
    steps = p_len + g_len
    print(f"phase14a serve gemma2-9b --full batch {b} prompt {p_len} gen "
          f"{g_len} on {card}: {out['seconds']:.4f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s incl. prefill (decode "
          f"{b * g_len / decode_s:.1f} tokens/s, "
          f"{1e3 * out['seconds'] / steps:.3f} ms per step); idle share "
          f"{res['profile']['device_idle_share']:.3f} (profiled window); "
          f"first ids {out['ids'][0][:12].tolist()}; flash launches "
          f"{launches} (want 0); peak memory {peak / 2 ** 30:.3f} GiB; done "
          f"at {time.perf_counter() - t_phase:.1f} s", flush=True)
    if tuple(out["ids"].shape) != (b, g_len) or not (
            (out["ids"] >= 0) & (out["ids"] < cfg.vocab_size)).all():
        fail("gemma2-9b: the served ids are misshapen or out of the "
             "vocabulary")
    if launches != [0, 0, 0]:
        fail(f"gemma2-9b: decode_step launched flash kernels {launches}")
    res["serve"] = dict(seconds=out["seconds"],
                        tokens_per_s=out["tokens_per_s"],
                        decode_tokens_per_s=b * g_len / decode_s,
                        ms_per_step=1e3 * out["seconds"] / steps,
                        peak_gib=peak / 2 ** 30, flash_launches=launches)
    del out

    # (b) one forward on [1, GEMMA_T] through the kernels, all 42 layers
    toks = torch.randint(0, cfg.vocab_size, (1, GEMMA_T),
                         generator=torch.Generator().manual_seed(14)).to(dev)

    def forward(p, c, backend=None):
        with torch.no_grad():
            return model.forward(p, c, toks, backend=backend)[0]

    logits, sec, launches, peak = _counted(torch, counters,
                                           lambda: forward(params, cfg))
    ok = (tuple(logits.shape) == (1, GEMMA_T, cfg.vocab_size)
          and torch.isfinite(logits).all().item()
          and logits.abs().max().item() <= cfg.final_softcap)
    print(f"phase14b forward gemma2-9b [1, {GEMMA_T}] (window "
          f"{cfg.attention.window}, softcaps {cfg.attention.logit_softcap:g}"
          f" / {cfg.final_softcap:g}): {sec:.4f} s = {GEMMA_T / sec:.1f} "
          f"tokens/s; logits {list(logits.shape)} finite, |max| "
          f"{logits.abs().max().item():.3f} <= the final softcap: "
          f"{'ok' if ok else 'NO'}; flash launches {launches} (want "
          f"[{cfg.num_layers}, 0, 0]); peak memory {peak / 2 ** 30:.3f} GiB",
          flush=True)
    if not ok or launches != [cfg.num_layers, 0, 0]:
        fail("gemma2-9b: the long forward is misshapen, non-finite or did "
             "not run through the flash kernel once a layer")
    res["forward"] = dict(seconds=sec, tokens_per_s=GEMMA_T / sec,
                          peak_gib=peak / 2 ** 30, flash_launches=launches)
    del logits
    c2 = dataclasses.replace(cfg, num_layers=2)
    p2 = _first_periods(params, 1)
    kern = forward(p2, c2)
    plain = forward(p2, c2, "torch")
    rel = ((kern - plain).abs().max() / plain.abs().max()).item()
    print(f"phase14b forward [1, {GEMMA_T}] at 2 layers, kernel vs plain "
          f"attention: max |logit diff| / max |logit| {rel:.3e} (limit "
          f"{GEMMA_PATHS_TOL:g}) {'ok' if rel <= GEMMA_PATHS_TOL else 'OUTSIDE'}"
          f"; done at {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not rel <= GEMMA_PATHS_TOL:
        fail("gemma2-9b: the long forward through the kernel disagrees with "
             "the plain attention")
    res["forward"]["kernel_vs_plain_2_layers"] = rel
    del kern, plain
    torch.cuda.empty_cache()

    # (c) teacher forcing
    toks = toks[:, :GEMMA_TF_T]
    res["teacher_forcing"] = {}
    for dtype, layers, tol in GEMMA_TF_CASES:
        c = dataclasses.replace(cfg, dtype=dtype, num_layers=layers)
        p = _first_periods(params, layers // model.period_length(cfg))
        if dtype == "float32":
            p = {k: v.float() for k, v in p.items()}
        res["teacher_forcing"][f"{dtype}_{layers}_layers"] = \
            _teacher_forcing(torch, fa, model, p, c, toks, "phase14c", tol)
        del p
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase14 done in {res['seconds']:.1f} s", flush=True)
    return res


def phase15_moe(torch, fa, card):
    """mixtral-8x22b and llama4-maverick at their published widths and
    reduced depth: a prefill forward (the share of tokens dropped at
    capacity, the aux loss), greedy decode steps, teacher forcing."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.models import moe as moe_mod

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    res = {}
    real_moe = moe_mod.moe_apply
    for arch, layers in MOE_CASES:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        m = cfg.moe
        row = {"reduced": {"num_layers": [full.num_layers, layers]},
               "n_params": cfg.param_count(),
               "active_params": cfg.active_param_count()}
        params, row["init_s"], _, _ = _counted(torch, counters, lambda: (
            model.init_leaves(torch.Generator(device=dev).manual_seed(0),
                              cfg)))
        print(f"phase15 {arch}: reduced num_layers {full.num_layers} -> "
              f"{layers} (published widths: d_model {cfg.d_model}, d_ff "
              f"{cfg.d_ff}, {m.num_experts} experts top-{m.top_k} every "
              f"{cfg.moe_every} layer(s), attention {cfg.attention.pattern}"
              f" window {cfg.attention.window}); {row['n_params']} "
              f"parameters ({row['active_params']} active a token) bf16, "
              f"seeded in {row['init_s']:.2f} s", flush=True)
        B, T = MOE_PREFILL
        toks = torch.randint(0, cfg.vocab_size, (B, T),
                             generator=torch.Generator().manual_seed(15)
                             ).to(dev)
        dropped = []

        def counted_moe(p, x, c):
            # the share of (token, choice) slots over capacity, read
            # beside the layer's own routing (one more router product)
            idx, _, _ = moe_mod._router(p, x, c)
            dropped.append(1.0 - moe_mod.slots(idx, c, x.shape[1])[1]
                           .float().mean())
            return real_moe(p, x, c)

        def prefill():
            with torch.no_grad():
                return model.forward(params, cfg, toks)

        with mock.patch.object(moe_mod, "moe_apply", counted_moe):
            (logits, aux), sec, launches, peak = _counted(torch, counters,
                                                          prefill)
        drop = [d.item() for d in dropped]
        want = [layers if cfg.attention.pattern in ("full", "swa") else 0,
                0, 0]
        ok = (tuple(logits.shape) == (B, T, cfg.vocab_size)
              and torch.isfinite(logits).all().item()
              and math.isfinite(aux.item()) and aux.item() > 0
              and launches == want)
        print(f"phase15a {arch} prefill forward [{B}, {T}] on {card}: "
              f"{sec:.4f} s = {B * T / sec:.1f} tokens/s; aux (balance "
              f"loss, summed over {len(drop)} MoE layers) {aux.item():.4f}; "
              f"dropped at capacity factor {m.capacity_factor:g} by layer "
              f"{[round(d, 4) for d in drop]}; flash launches {launches} "
              f"(want {want}: chunked layers take the plain attention); "
              f"peak memory {peak / 2 ** 30:.3f} GiB "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"{arch}: the prefill forward is misshapen or non-finite, "
                 f"its aux is not positive, or its flash launches are "
                 f"{launches}, not {want}")
        row["prefill"] = dict(seconds=sec, tokens_per_s=B * T / sec,
                              aux=aux.item(), dropped_share_by_layer=drop,
                              peak_gib=peak / 2 ** 30,
                              flash_launches=launches)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits

        def decode(n, tok=tok):
            cache = model.make_cache(cfg, B, n, device=dev)
            ids = []
            with torch.no_grad():
                for t in range(n):
                    lg, cache = model.decode_step(params, cfg, tok, cache, t)
                    tok = lg[:, -1].argmax(-1)[:, None]
                    ids.append(tok)
            return torch.cat(ids, 1)

        prof = profile_window(torch, f"phase15b {arch} decode (batch {B}, "
                              f"4 steps)", lambda: decode(4), 4, "step")
        ids, sec, launches, peak = _counted(torch, counters,
                                            lambda: decode(MOE_DECODE))
        ok = (tuple(ids.shape) == (B, MOE_DECODE) and launches == [0, 0, 0]
              and ((ids >= 0) & (ids < cfg.vocab_size)).all().item())
        print(f"phase15b {arch} greedy decode batch {B}, {MOE_DECODE} steps:"
              f" {sec:.4f} s = {B * MOE_DECODE / sec:.1f} tokens/s, "
              f"{1e3 * sec / MOE_DECODE:.3f} ms per step; idle share "
              f"{prof['device_idle_share']:.3f} (profiled window); first "
              f"ids {ids[0][:8].tolist()}; flash launches {launches} (want "
              f"0); peak memory {peak / 2 ** 30:.3f} GiB "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"{arch}: decode ids misshapen or a flash launch")
        row["decode"] = dict(seconds=sec, tokens_per_s=B * MOE_DECODE / sec,
                             ms_per_step=1e3 * sec / MOE_DECODE,
                             peak_gib=peak / 2 ** 30, profile=prof,
                             flash_launches=launches)
        dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
        row["teacher_forcing"] = _teacher_forcing(
            torch, fa, model, params, dropless, toks[:1, :MOE_TF_T],
            f"phase15c {arch}", None)
        row["seconds"] = time.perf_counter() - t_phase
        res[arch] = row
        del params, toks
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase15 done in {res['seconds']:.1f} s", flush=True)
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
          f" s; " + "; ".join(log.splitlines()[0] for log in logs.values()),
          flush=True)
    spec, launches, rounds_per_s = phase2_main_path(torch, masked, grid)
    phase3_paths_agree(torch, grid, spec)
    f = phase4_flash(torch, fa, ref, bw, bf16_peak, fp32_peak,
                     logs[fa.SOURCE.name])
    lm = phase5_slice(torch, train, fa, masked, card)
    paths_err = phase6_paths_agree(torch, train, fa)
    wkv = phase7_wkv(torch, rk, ref, bw, fp32_peak, logs[rk.SOURCE.name])
    rwkv = phase8_serving(torch, rk, card)
    paper = phase9_paper(torch, masked, ref, grid)
    scale = phase10_scale(torch, masked, grid)
    found = phase11_search(torch, masked, ref, grid)
    lm_sweep = phase12_lm_sweep(torch, fa, masked, ref, grid, bw, fp32_peak)
    dense = phase13_dense_serving(torch, fa, ref, card)
    gemma = phase14_gemma2(torch, fa, card)
    moe = phase15_moe(torch, fa, card)
    zoo_s = gemma["seconds"] + moe["seconds"]
    print(f"phases 14-15 took {zoo_s:.1f} s (limit {PHASE14_15_LIMIT_S:g} "
          f"s)", flush=True)
    if zoo_s > PHASE14_15_LIMIT_S:
        fail(f"phases 14-15 took {zoo_s:.1f} s, over their "
             f"{PHASE14_15_LIMIT_S:g} s")
    # each flash kernel's launches by LM-sweep cell, counted on that cell's
    # timed run (index 0-2: fwd, dq, dkdv; 3: the aggregation)
    cell_launches = {c: lm_sweep[c]["launches"]
                     for c in ("family", "cohort", "wide", "d_model_576")}
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
              "scale_launches": scale["launches"],
              "search_launches": {
                  "resume_checks": found["resume_launches"],
                  "asha": found["asha"]["launches"],
                  "asha_seeds_0_9": found["asha"]["spread"]["launches"],
                  "refill": found["refill"]["launches"]},
              "lm_shape": k["lm"],
              "fig3_shape": paper["kernel"]["fig3_timing"],
              "lm_sweep_launches": {c: v[3] for c, v in
                                    cell_launches.items()},
              "lm_sweep_shapes": lm_sweep["kernels"]["fused_masked_agg"]}
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
            **r["ptxas"].get("D=64", {}), ptxas_by_head_dim=r["ptxas"],
            lm_sweep_launches={c: v[i] for c, v in cell_launches.items()},
            lm_sweep_shapes={dd: v[key] for dd, v in
                             lm_sweep["kernels"]["flash"].items()},
            serve_launches=dense["serve_flash_launches"][i],
            zoo_launches={
                "gemma2_9b_serve": gemma["serve"]["flash_launches"][i],
                "gemma2_9b_forward": gemma["forward"]["flash_launches"][i],
                **{f"{a}_prefill": moe[a]["prefill"]["flash_launches"][i]
                   for a, _ in MOE_CASES}})
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
    print(json.dumps({"scale": scale}), flush=True)
    print(json.dumps({"search": found}), flush=True)
    print(json.dumps({"lm_sweep": {k2: v for k2, v in lm_sweep.items()
                                   if k2 != "kernels"}}), flush=True)
    print(json.dumps({"serve": dense}), flush=True)
    print(json.dumps({"zoo": {"gemma2-9b": gemma, "moe": moe}}), flush=True)
    print(f"# total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
