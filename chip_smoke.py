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
``-Xptxas -v`` report (and by head dim, of the bf16 kernels of
``FLASH_TC`` and the fp32 ones of ``FLASH_F32``; the build's head dims must
be the wrapper's ``HEAD_DIMS``; a spill in any of the three fp32 kernels,
or a head dim missing from one, fails the phase), and holds forward and dq/dk/dv against the plain
version and its autograd at the reference's kernel-test shapes, at bf16
shapes of the tensor-core backward (D = 128, a ragged T at D = 32, not
causal), at D = 144 and 256 in both dtypes (gemma2-9b's window and
softcap, and its layer's prefill ``[16, 8192, 256]``), at D = 40
(zero-padded to 64 by the wrapper) and at the LM path's shape
``[144, 2048, 64]`` bf16 causal
(``FLASH_TOL``: fp32 atol and rtol 2e-3, the reference's; bf16 atol 1e-2
with the reference's rtol 3e-2, set from the measured errors), naming the
kernels each shape took (``FLASH_DESIGN``: bf16 takes the tensor-core
forward and backward, fp32 the 3xTF32 tensor-core forward and backward)
and the atol each output
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
its masks allow and its true head dim. Every fp32 timing (here and in
phases 12a, 16 and 17d) also prints the tensor-core bound, the larger of
the bytes at the memory rate and three times the flops at the card's dense
TF32 rate (``tf32_peak``: half the bf16 one): what a 3xTF32 design could
reach. Phase 5
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
2-D route, its batches' ``[9, 50, 50]``, Table 2's ``[4, 100, 2762]``, Fig. 8's ``[6, 100, 2762]``; every
op, with half the clients active and with none) within ``FP32_TOL``; the
kernel at Fig. 3's shape (2-D route, OP_MEAN, half active) timed as phase 1
times the main path's, beside its bound, its plain version and
``torch.bmm``; and Fig. 3's ``run_one`` through the kernel and through
the plain path on the same seeds (FedPBC and FedAvg at (0.9, 0.1),
``FIG3_AGREE_ROUNDS`` rounds), the distance trajectories within
``FP32_TOL``; a shorter such run (``FIG3_PROFILE_ROUNDS`` rounds) is
profiled (kernels, device time and idle share a round). Then the port's
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
reference's (``FIG3_REFERENCE``); its 18 trajectories run as one batch
of 9 (3 points x 3 seeds) for each algorithm (``run_batch``), so 2 x 400
launches at ``[9, 50, 50]``. Fig. 2: its own
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
flash kernels (the 3xTF32 tensor-core forward and backward)
at the LM's ``[G*b*H, T, D]``, ``[256, 32, 16]`` and ``[256, 256, 128]`` (``FLASH_TOL``), each
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

Phase 16 runs the hybrid, vlm and audio families at published widths
(bf16, seeded). First the flash forward at the shapes the phase gives it
(``ZOO_FLASH``: seamless's fp32 encoder ``[128, 1024, 64]``, its decoder
``[64, 2048, 64]`` bf16, vision's and jamba's ``[256, 2048, 128]`` bf16)
against its plain version within ``FLASH_TOL``, timed beside the plain
version, SDPA's causal forward and its bound. (a) seamless-m4t-medium,
not cut (12 encoder and 12 decoder layers, d_model 1024, 16 heads of 64,
vocab 256,206): ``repro_torch.launch.serve --full --arch
seamless-m4t-medium`` at ``SEAMLESS_SERVE`` (batch 8, prompt 64, gen 32;
the launcher's 0.1 fp32 frames, so the encoder runs in fp32 through the
fp32 flash forward at every step: 12 launches a step, 1,152 a run), ids
in the vocabulary, ms a step, a short run profiled (idle share), peak
memory; a ``forward`` on ``[4, 2048]`` with seeded ``0.1 * N(0, 1)``
frames ``[4, 1024, 1024]`` fp32 (24 launches, finite logits, tokens/s);
the same at 2 + 2 layers through the kernel against the plain attention
within ``ZOO_PATHS_TOL``; teacher forcing on ``[1, 128]`` as phase 13's
(``SEAMLESS_TF_CASES``: bf16 and fp32 at 2 + 2 layers held, 12 + 12
measured; ``decode_step`` launches 12 a step there too, and the plain
path none). (b) llama-3.2-vision-90b at 10 of 100 layers and
jamba-1.5-large-398b at 8 of 72 with its experts cut from 16 to 8
(``MEMORY_CASES``; the cuts printed as ``reduced``), the vlm's
``cross_gate`` set to 1.0 after init (at its init 0 a cross layer adds
nothing): a prefill ``forward`` on ``[4, 2048]`` (the vlm with 1,024
seeded image tokens; one launch per self-attention layer, 10 and 1;
tokens/s, peak memory; jamba's aux finite and positive, its share of
slots dropped by MoE layer, and the Mamba layers' share of the prefill's
device time under ``torch.profiler``; a peak over ``ZOO_PEAK_GIB`` reruns
it at half the batch), 32 greedy ``decode_step``s at batch 4 (ms a step,
a profiled window's idle share, 0 launches), the vlm's one period
through the kernel against the plain attention within ``ZOO_PATHS_TOL``,
and teacher forcing on ``[1, 64]`` (the vlm at one period, jamba with the
capacity factor at E / k), measured. Phase 16 is held to
``PHASE16_LIMIT_S``.

Phase 17 trains the MoE, hybrid, vlm and audio families, bf16 models whose
fp32 leaves (routers, Mamba leaves, cross gates) make a second parameter
group. (d) first: the flash kernels, forward and backward, at the training
path's shapes (``TRAIN_FLASH``: seamless's fp32 encoder ``[128, 1024,
64]``, its bf16 decoder ``[128, 512, 64]``) against the plain version
within ``FLASH_TOL``, timed beside SDPA's forward and backward and their
bounds; the aggregation at both groups' shapes (``[1, 4, 878,143,488]``
bf16, more than 2^31 elements, and ``[1, 4, 12]`` fp32) against its plain
version, timed beside ``torch.bmm``. (a) seamless-m4t-medium at full width
and depth through ``repro_torch.launch.train --full`` (``SEAMLESS_TRAIN``:
4 clients, 2 local steps, batch 2, 512 tokens, 5 timed rounds and one
profiled), the fused aggregation on: every loss finite; each flash kernel
launched (rounds) x (local steps) x 12 times at the bf16 decoder shape and
as often at the fp32 encoder shape; the aggregation twice a round, once
per group; the cross gates fp32 in server and clients and moved in every
client; tokens/s (``rounds · m · s · b · T`` over the loop's wall), peak
memory, the profiled round (kernels, device ms, idle share). (b) the same
at 2 + 2 layers down the kernel path and the plain path (``backend=
"torch"``, branch aggregation): the clients' updates within ``PATHS_TOL``
relative over all parameters, each attention projection and the fp32
group. (c) ``TRAIN_ZOO_ARCHS`` at ``reduced()`` in bf16 (``TRAIN_ZOO``),
kernel path against plain path: finite losses, every fp32 leaf fp32 and
moved, the MoE archs' aux finite and positive, the clients' updates within
``PATHS_TOL``. Phase 17 is held to ``PHASE17_LIMIT_S``.

Phase 18, launch and checkpointing. (a) SmolLM-135M at full width and
depth in bf16 through ``launch/train.py --full`` (``CKPT_LM``: 8 clients, 2
local steps, batch 2, T = 512), the fused aggregation on: A, 4 rounds
uninterrupted; B, 2 rounds saved with ``--ckpt-dir``; C, ``--rounds 4``
from B's directory, which restores round 2. C's final server, clients,
optimizer state and losses of rounds 3-4 must equal A's bit for bit (if
they do not, A runs again: if two uninterrupted runs also differ, C is
held to A within their distance and the card is named nondeterministic;
otherwise the checkpoint is at fault), and C launches each flash kernel
2 · 2 · 30 times and the aggregation twice; the checkpoint's bytes and
each save's and restore's seconds are printed. The checkpoints go to a
temporary directory under ``build/``, deleted after. (b) The same A/B/C
on jamba-1.5-large at ``reduced()`` in bf16 (two parameter groups, as
phase 17c): bitwise, every fp32 leaf fp32 after the restore. (c) The ops
wrappers (``kernels/ops.py``) against their plain versions on the card:
``masked_agg_pytree`` on a SmolLM-shaped dict of fp32 leaves of 8 clients,
3 active with ``prev`` and without (the reference's ``masked_agg``
``:109`` and ``:96``) within fp32 1e-5, none active returning ``prev``
exactly, one launch a leaf; ``gqa_flash_attention`` at SmolLM's ``[2,
2048, 9, 64]`` on 3 KV heads in bf16 within ``FLASH_TOL``. (d) The
roofline's share of the whole step: phase 5's steady rounds/s times
``launch.roofline.model_flops_for`` of its round (6 · N · m · s · b · T)
over the card's bf16 peak, printed beside the card's name and power
limit. (e) A dry-run row on the meta device (``launch/dryrun.py``) for
smollm-135m × train_4k, printed with its ``useful_fraction``, and the
counted FLOPs of phase 5's round at its own shape held within 2 % of the
analytic count (three forwards outside attention a client and local
step, the head once more, and attention as the flash kernels' work on the
causal pairs: 4 flops a pair and head dim forward, 14 backward). Phase 18
is held
to ``PHASE18_LIMIT_S``.

Phase 19, RWKV6 training. (a) The WKV6 backward (``csrc/rwkv6_chunk_bwd.cu``:
``wkv6_bwd_state`` then ``wkv6_bwd_chunk``, from the chunked forward's
chunk-start states) through ``rwkv6_chunk_autograd``: its ptxas report
(registers, spills: a spill fails the phase), all six gradients (dr, dk,
dv, dw, du, ds0) for the output's and the final state's gradients against
the autograd of the plain chunked version (and of the step scan up to T =
128) at ``WKV_BWD_SHAPES`` (the prefill shape, strong decay over 4096
steps, ragged T, D = 128) and two models of 40 heads folded into the head
axis with a bonus each, within ``WKV_BWD_TOL`` (each gradient scaled by its
largest magnitude, dlog w as it is) and finite; its time at ``[4, 40, 4096,
64]`` (CUDA-graph replays) beside the chunked forward's, the plain
version's autograd backward (CUDA events) and its bounds
(``roofline.wkv6_work``: the function's bytes, or its step recurrence's
flops at the fp32 peak; and the tensor-core bound, three times those flops
at ``tf32_peak``). (b) ``reduced()`` rwkv6 through
``launch/train.py`` (``RWKV_TRAIN_REDUCED``), the kernel path (the WKV6
kernels, the fused aggregation) against the plain path from the same
generators: fp32 client updates within ``RWKV_TRAIN_FP32_TOL`` relative
(over all, the fp32 leaves, each time-mix projection), bf16 in two groups
within ``PATHS_TOL``, the WKV6 forward and backward once per layer and
local step, the aggregation once per group a round. (c) rwkv6-3b at full
width and depth (3,073,313,280 parameters, 245,760 of them fp32 in the
second group) through ``launch/train.py --full`` (``RWKV_TRAIN``,
``REPRO_USE_KERNEL=1``), the clients halved while the run runs out of
memory: every loss finite, each WKV6 direction ``rounds · s · 32`` times,
the aggregation once per group a round, the fp32 leaves fp32 and moved,
peak ≤ 80 GB; tokens/s (all rounds and after the first) and one round
profiled (device ms by family and the eight longest kernels, idle share).
Phase 19 is held to ``PHASE19_LIMIT_S``.

Phase 20 runs the sweep's multi-device split (``repro_torch.experiments.
shard``: one worker process per mesh rank, ``repro_torch.sharding.pool``)
on the one card: (a) phase 2's Table-1 cell for fedpbc (seeds 0-2,
``use_kernel=True``) through ``run_cell_batch(devices=[cuda:0])``, one
worker under NCCL, against ``mesh=None`` in this process, every
``CellResult`` field bitwise and the worker's aggregation launched once a
round; (b) the same cell on two ranks sharing the card (gloo, B = 3 padded
to 4), bitwise or within ``SHARD_TOL`` with the op named (the round's
batched ops on 2 rows against 3 are probed and printed), no padding row in
the result; (c) lm-family (phase 12's widths, 10 rounds) on
``make_2d_mesh(1, 2)`` over the card twice, each rank training 2 of the 4
clients of every trajectory and all-gathering the updates, against one
device within ``LM_PATHS_TOL``: each rank's flash and aggregation launches
as one device's, the bytes and ops of its all-gathers equal to
``roofline.collective_stats`` and their wall seconds printed. Each
sub-phase prints the backend and each rank's device and wall seconds. The
three pools start together in background threads when the phase begins
(each worker takes seconds to import torch and reach the card), while this
process runs the plain counterparts; each sub-phase waits for its own pool
first and prints that wait apart from its run. The phase is held to
``PHASE20_LIMIT_S``.

Phase 21 runs the last seven suites of ``benchmarks/run.py`` on the card,
each through its ``repro_torch.paper`` module's ``run(...)`` with
``use_kernel=True``, its JSON in a temporary directory under ``build/``,
its seconds and each kernel's launches counted around it (the counts set
to 0 just before, read just after). (a) ``kernels`` at the reference's
shapes, in full: the aggregation at ``[B, m, 1024]`` for (B, m) in {8, 64}
x {32, 256} with mixed opcodes, ``masked_agg`` at ``[64, 65536]``, the fp32
flash forward at ``[1, 4, 512, 64]`` causal and WKV6 at ``[1, 4, 256, 64]``
(the chunked route); ``kernel_backend`` must be ``"kernel"`` and the
launches 29 / 1 / 1; afterwards, outside the count, each kernel is held
against its plain version on the suite's own inputs (the aggregation and
``masked_agg`` within ``FP32_TOL``, flash within ``FLASH_TOL``, WKV6 within
``WKV_TOL`` of the step scan) and timed beside its plain version, its
library call (``torch.bmm``; SDPA's forward; none for WKV6) and its bound.
(b) ``throughput`` (m = 32, 200 rounds): the two paths' final losses
equal, the aggregation once a round (3 · 200 + 2). (c) ``extensions`` at
its default protocol (250 rounds, m = 100): each (scheme, algorithm)
mean over seeds 0-2, run at the reference's Eq.-9 ``p_base`` of each seed
(``REFERENCE_P_BASE``, as Table 1 in phase 9), at or above the JAX
reference's mean over seeds 0-2 less 0.05 (``EXTENSIONS_REFERENCE_MEAN``),
the aggregation once a round of FedPBC (1,500) and never for FedPBC-M.
That floor only bounds seed noise (fedpbc_m's seed std on markov_nonhom is
~0.095, and a FedPBC-M without momentum would score as FedPBC does, above
its bar), so the momentum is held exactly besides: two rounds of each
through ``run_training`` at one seed, on the same draws, must leave
FedPBC-M's server ahead of FedPBC's by ``FEDPBC_M_BETA`` times round 1's
step (``_momentum_check``).
(d) ``sweep``, cut in rounds and seeds (``SWEEP_CUT``: 40 rounds, 4
seeds, its ablations 2 seeds and 10 rounds; m = 32 and every width as the
suite's): the suite's own agreement checks
(sequential vs batched, per-value vs traced, per-algorithm vs family; one
card, so its device axis records the single-device note), the aggregation
once a round of every batch run on its ``[B, m, n]`` route. (e) ``scale``
at its ``--smoke`` configuration (m = 10,000, C = 256, 6 rounds): commits
≥ 1 a seed, mean staleness ≤ the deadline (4), no aggregation launch. (f)
``lm_sweep`` at ``smoke=True`` (the reference's own smoke configuration):
every loss finite, flash and aggregation launches as phase 12 counts them
(``_want_launches``) for its two arms, each run twice. (g) ``roofline``
over a dry-run JSON the phase writes from phase 18e's smollm-135m ×
train_4k row: one ``ok`` row. Phase 21 is held to ``PHASE21_LIMIT_S``.

Phase 22 runs the analysis gate's runtime half (``repro_torch.analysis``).
(a) Phase 2's cell at ``PHASE22_ROUNDS`` rounds under
``HostSyncSanitizer`` (``torch.cuda.set_sync_debug_mode("warn")``, each
sync warning mapped to the innermost frame of the port and whether a step
context of ``lint.STEP_CONTEXTS`` was on the stack): syncs a round inside
rounds and outside them, every in-round site, the aggregation once a
round. (b) SmolLM-135M served at full width through ``serve.main``
(``PHASE22_SERVE``), without and with ``keep_logits``: syncs a
``decode_step``; with ``keep_logits`` the ``.cpu()`` of its step closure
must show once a token (the known positive). In both, every in-step site
must be a finding of the static gate (``lint.host_sync_sites``: new,
grandfathered or suppressed), so the card holds the static rule to what it
sees. (c) Runner pins: ``segment_runner_for`` for two specs that differ
only in lr and gamma builds exactly one runner, and a second
``run_sweep`` at other hyperparameters compiles no Triton specialisation
(``masked_agg.compiled_specializations()``, which must not be None).
Phase 22 is held to ``PHASE22_LIMIT_S``.

Phase 23 runs the dry run on the reference's production meshes
(``launch/dryrun.py``'s meshed rows: DTensor programs on a simulated
process group of 256 or 512 ranks, ``sharding/spmd.py``) and the four
examples. (a) On the card's host, in parallel worker processes (no card):
the ``16x16`` rows of smollm-135m × train_4k, prefill_32k and decode_32k
at full size and the ``2x16x16`` train_4k row (``PHASE23_ROWS``): each
``ok``, the train rows with ``t_collective_s`` > 0, and on ``2x16x16``
two clients, the client dim over ``"pod"`` and collective bytes on the pod
axis of at least one model's shard (the aggregation across the pods);
each row's ``count_s``, per-device ``param_bytes`` and
``argument_bytes`` and collectives by kind, by axis and by the op behind
them are printed. (b)
Rank 0 of the ``16x16`` prefill_32k row, run on ``cuda:0``
(``dryrun.run_rank0``: the same placements, rank 0's shards on the card
under the simulated group, the flash forward through the hand-written
kernel on rank 0's local tensors): its launches and shapes must equal the
count's for that row, and its kernel counter must agree. Its peak memory
is printed beside the row's ``argument_bytes`` and its device ms
(``torch.profiler``) beside ``max(t_compute_s, t_memory_s)``. The step's
values are not compared: a simulated group's collectives deliver no other
rank's data (the q, k and v that reach attention passed its all-gather,
whose output no rank fills). The kernel is: at rank 0's local shape and
keywords (``[18, 32768, 64]`` bf16 causal, which no other phase checks),
through ``dispatch.attention`` on unit normals, against the plain version
(``attention_ref`` in fp32, chunked over keys) within ``FLASH_TOL``.
(c) The four examples (``examples/torch_port/``) on the card, in parallel
worker processes, at the reference's sizes (the LM trainer for
``PHASE23_TRAIN_ARGS``): each exits 0, and the quickstart's assertion that
FedPBC beats FedAvg holds. (a) and (c) run beside (b); phase 23 is held
to ``PHASE23_LIMIT_S``.

Phase 24 runs the sharded LM sweep with each sequence split over the
``"model"`` ranks (``run_sharded_2d(..., activation_spec=P(None, "model",
None))``, ``sharding.pool.SequenceAxis``; ROADMAP item 6c): two gloo ranks
sharing the card on ``make_2d_mesh(1, 2)``, each holding every client and
its half of every sequence, all-gathering K and V in each attention block
and all-reducing the gradients and the losses. (c), while the pool
starts: the flash kernels' causal-offset route alone at rank 1's local
shapes of (a) and (b) in fp32 and at ``[144, 1024 | 2048, 64]`` bf16
(``SEQ_OFFSET_SHAPES``), each against ``attention_ref(..., q_offset=...)``
and its autograd within ``FLASH_TOL``, timed (CUDA-graph replays) beside
its plain version, its bound (the pairs the offset allows) and SDPA with
an explicit bottom-right boolean mask, and the aligned twins
(``SEQ_ALIGNED_TWINS``) re-timed in the same call. (a) lm-family
(``LM_SWEEP``, 10 rounds) and (b) lm-wide (``LM_WIDE`` cut to
``SEQ_WIDE_ROUNDS`` round), each against its single-device run: the
largest |server diff| of a trajectory within ``LM_PATHS_TOL`` with the
losses printed, both ranks' servers and outputs bitwise equal, each
rank's launches as one device's with rank 1's training launches at
``q_offset = T / 2`` (and rank 0's not), no plain attention on either
rank, the collectives' bytes and counts equal to
``roofline.collective_stats(..., sequence=...)``; (b) also runs the same
runner with the clients split, for its peak memory a rank beside the
sequence split's. Phase 24 is held to ``PHASE24_LIMIT_S``.

Phase 25 splits the sequences of the MoE, RWKV6 and hybrid families
(ROADMAP item 6d) on phase 24's mesh: each rank takes what the earlier
rank carries into its chunk (the token shifts' and the Mamba conv's last
rows, the WKV6 and Mamba states, the MoE rows' expert counts and
whole-row sums; ``sharding.pool.SequenceAxis``). (a), while the pool
starts: the WKV6 kernels' zero-padded head-dim route alone at head dims
16 and 32 (``WKV_PAD_SHAPES``), forward and backward from a non-zero
``s0`` with a non-zero ``dS_T`` against the plain version within
``WKV_TOL`` / ``WKV_BWD_TOL``, timed beside it and its bound; then
``LM_SWEEP`` at rwkv6-3b (4 heads of 16) on one device through the pad
route, its WKV6 launches as counted, no plain WKV6 call, against the
plain path within ``LM_PATHS_TOL``. (b) ``LM_SWEEP`` at each of
``SEQ_FAMILY_ARCHS`` with ``activation_spec=P(None, "model", None)``
against one device: the largest |server diff| of a trajectory within
``LM_PATHS_TOL``, both ranks' digests equal, each rank's flash and
aggregation launches as one device's (rank 1's training at the offset),
its WKV6 forward one more a layer and local step and its backward twice
(the chunk's state from zero, then its outputs from the carried state),
no plain attention or WKV6, the collectives as
``roofline.collective_stats(..., exchanges=sequence_exchanges(...))``
counts them. (c) lm-wide (one round) at ``SEQ_FAMILY_WIDE_ARCHS`` the
same (rwkv6 alone, for the smoke's time), with each rank's peak memory
and collective seconds; then WKV6 at rank 1's local shape there (D = 128)
from a carried state, checked and timed. Phase 25 is held to
``PHASE25_LIMIT_S``.

Phase 26 runs the LM sweep at every width the reference runs: with
``reduced()``'s 4 heads, ``lm_d_model`` / 4 passes the WKV6 kernels' 128
above 512 and the flash kernels' 256 above 1024. (a) The WKV6 block route
(``rwkv6_chunk.fold_blocks``: the head dim's key and value blocks of
``BLOCK_DIM`` folded into the head axis, one call of the kernels) at
``WIDE_WKV_SHAPES`` (26b's launch shape first) from a non-zero ``s0``
with a non-zero ``dS_T``, forward and backward against the plain version
within ``WKV_TOL`` / ``WKV_BWD_TOL``, timed beside its plain version and
bounds at the true head dim; the flash kernels'
wide-head route (``csrc/flash_attention_wide.cu``) at
``WIDE_FLASH_SHAPES`` through ``flash_attention``'s routing (one wide
launch a pass, none aligned) within ``FLASH_TOL`` fp32, timed beside the
plain version, its bounds at the true head dim and SDPA on the first of
its backends that runs there, named. (b) ``LM_SWEEP`` at each of
``LM_WIDE_HEADS`` (cut to ``LM_WIDE_HEADS_CUT``) on one device through
the kernels, its launches as counted (the wide flash kernels or the WKV6
block route, no aligned flash, no plain attention or WKV6), against the
plain path within ``LM_PATHS_TOL``, peak memory under
``WIDE_HEADS_PEAK_GIB``. Phase 26 is held to ``PHASE26_LIMIT_S``.

The five CUDA sources (the flash kernels' three routes: self-attention,
causal offset and wide heads; WKV6's forward and backward) are built at
the start, one ``nvcc`` each, started together while phase 1 builds and
checks the Triton kernel.

Output: per-phase lines, a ``{"paper": {...}}`` JSON line (phase 9's
seconds, launches, family batches and results), a ``{"scale": {...}}``
line (phase 10's), a ``{"search": {...}}`` line (phase 11's), a
``{"lm_sweep": {...}}`` line (phase 12's cells), a ``{"serve": {...}}``
line (phase 13's), a ``{"launch": {...}}`` line (phase 18's), a
``{"rwkv_train": {...}}`` line (phase 19's), a ``{"sharded": {...}}``
line (phase 20's), a ``{"suites": {...}}`` line (each phase-21 suite's
``BENCH`` dict) and a ``{"phase21": {...}}`` line (its seconds, launches,
kernel checks and momentum check), a ``{"zoo": {...}}`` line (phases 14 to 17), an
``{"analysis": {...}}`` line (phase 22's census and pins), a
``{"meshes": {...}}`` line (phase 23's rows, rank-0 run and examples),
a ``{"seq_parallel": {...}}`` line (phase 24's cells), a
``{"seq_families": {...}}`` line (phase 25's), a ``{"wide_heads":
{...}}`` line (phase 26's), then a
``{"kernels": [...]}`` JSON line (the aggregation with phase 9's launches
by suite as ``paper_launches``, phase 24's by rank as
``seq_parallel_launches``, phase 10's as ``scale_launches``, phase
11's as ``search_launches``, phase 12's by cell as ``lm_sweep_launches``
and its timings at the sweep's shapes as ``lm_sweep_shapes``, its Fig. 3
shape timing as ``fig3_shape``; each flash kernel with its design and its
registers and spills at D = 64 and by head dim (both designs), its
errors by checked shape, its timings at the new head dims as
``head_dim_shapes``, its phase-12 launches by cell and timings at D = 16
and 128 (fp32), its launches in phase 13's serve run as
``serve_launches`` and in phases 14-16 as ``zoo_launches``, the forward's
timings at phase 16's shapes as ``zoo_shapes``, each flash kernel's and
the aggregation's phase-17 launches by shape as ``train_zoo_launches`` and
timings at its shapes as ``train_zoo_shapes``, phase 18's launches in
the resumed runs as ``ckpt_resume_launches``, the aggregation's through
``masked_agg_pytree`` and the flash forward's through
``gqa_flash_attention``; each flash kernel's phase-24 launches by rank
(all, and at an offset) as ``seq_parallel_launches`` and the offset
route's timings with their aligned twins as ``seq_parallel_shapes``; the
WKV6 wrapper once per
route, ``rwkv6_chunk_fwd`` and ``rwkv6_step_fwd``, with their kernels'
ptxas by head dim and the chunked route's phase-19 launches as
``train_launches``; the WKV6 backward, ``rwkv6_chunk_bwd``, with its
launches in phase 19c; both WKV6 directions' phase-25 launches by cell
and rank as ``seq_family_launches`` and their timing at 25c's rank-local
shape as ``seq_wide_shape``; the zero-padded route,
``rwkv6_chunk_padded``, with its launches in 25a's rwkv6 run, its
timings by head dim and its launches by cell and rank; each flash
kernel's and the aggregation's phase-25 launches by cell and rank as
``seq_family_launches``; the aggregation's and each flash kernel's launches
by rank in phase 20 as ``sharded_launches``; every kernel's phase-21
launches by suite as ``suite_launches``, and the aggregation's, the flash
forward's and the chunked WKV6 route's timings at the ``kernels`` suite's
shapes as ``kernels_suite_shapes``; phase 22's launches as
``analysis_launches``: the aggregation's in 22a and 22c, each flash
kernel's in 22b's two serve runs; the flash forward's in 23b as
``mesh_rank0_launches``, with the local shape it launched at; the three
wide-head flash kernels with their 26b launches, their timings at 26b's
launch shape and by head dim, and the SDPA backend timed beside them;
the WKV6 block route, ``rwkv6_chunk_blocked``, with its launches in 26b's
rwkv6 run and both directions' timings at 26b's launch shape and by
shape), the card's
name and power
limit from nvidia-smi, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
result line. Without CUDA, or without the repository beside it, it exits
non-zero at once.
"""
import dataclasses
import functools
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
# the rounds of Fig. 3's profiled run (phase 9; the profiler's own cost
# grows with the events it records)
FIG3_PROFILE_ROUNDS = 25
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
    "float32": {"fwd": "tensor-core 3xTF32 fp32 (flash_fwd)",
                "bwd": "tensor-core 3xTF32 fp32 (flash_bwd_dq, "
                       "flash_bwd_dkdv)"}}
# the bf16 kernel of each pass, whose ptxas report phase 4 prints by head
# dim, and the fp32 one
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
# rounds); lm-wide: a wider cell than the benchmark's arms, d_model 512
# (4 heads of 128: the flash kernels' own tiles and the WKV6 kernels'
# widest head; wider heads take their wide-head and block routes, phase
# 26; 4 layers, sequences of 256), m = 8, the quartet at lr 0.1, 5 rounds
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
# Phase 16, the hybrid, vlm and audio families at published widths (bf16,
# seeded). seamless-m4t-medium is not cut: the serve launcher at
# SEAMLESS_SERVE (batch, prompt, gen; its own memory, 0.1 * ones fp32, so
# the encoder runs in fp32 and launches the fp32 flash forward once a layer
# at every step), a forward on ZOO_PREFILL tokens with ZOO_MEMORY-seeded
# 0.1 * N(0, 1) fp32 frames, the same at 2 + 2 layers through the kernel
# against the plain attention (phase 14's bar), teacher forcing on [1,
# SEAMLESS_TF_T] as phase 13's (dtype, layers, limit; layers of decoder and
# encoder each). llama-3.2-vision-90b and jamba-1.5-large-398b at reduced
# depth, (arch, layers, experts or None): vision two periods of 4 self + 1
# cross, 10 of 100 layers (~20.4 GiB); jamba one period, 8 of 72 layers (7
# Mamba + 1 attention, MoE on every second), its experts cut from 16 to 8
# so that the period fits one card (16 experts: 84.3 GiB of weights; 8:
# 48.3 GiB); a prefill on ZOO_PREFILL tokens (the vlm with 1,024 seeded
# image tokens), ZOO_DECODE greedy decode steps at its batch, and teacher
# forcing on [1, ZOO_TF_T] (jamba with the capacity factor at E / k),
# measured; the vlm also at one period (5 layers) through the kernel
# against the plain attention (phase 14's bar). The vlm's cross_gate starts
# at 0 (tanh(0) = 0: a cross layer would add nothing), so phase 16 sets it
# to 1.0 after init. A jamba prefill whose peak passes ZOO_PEAK_GIB is
# rerun at half the batch.
SEAMLESS_SERVE, SEAMLESS_TF_T = (8, 64, 32), 128
SEAMLESS_TF_CASES = (("bfloat16", 2, 2e-2), ("float32", 2, 1e-4),
                     ("bfloat16", 12, None))
MEMORY_CASES = (("llama-3.2-vision-90b", 10, None),
                ("jamba-1.5-large-398b", 8, 8))
ZOO_PREFILL, ZOO_DECODE, ZOO_TF_T, ZOO_MEMORY = (4, 2048), 32, 64, 16
ZOO_PATHS_TOL = GEMMA_PATHS_TOL
ZOO_PEAK_GIB = 72.0
# the flash forward at the shapes phase 16 gives it, (b, h, t, d, dtype):
# seamless's encoder in the serve run (batch 8, 1,024 fp32 frames), its
# decoder in the forward, the vlm's and jamba's attention in the prefill
# (64 heads of 128 on 8 KV heads: one shape for both)
ZOO_FLASH = ((8, 16, 1024, 64, "float32"), (4, 16, 2048, 64, "bfloat16"),
             (4, 64, 2048, 128, "bfloat16"))
PHASE16_LIMIT_S = 150.0
# Phase 17, training of the MoE, hybrid, vlm and audio families (bf16 models
# with fp32 leaves, held in two parameter groups). seamless-m4t-medium not
# cut, through launch/train.py --full at SEAMLESS_TRAIN (clients, local
# steps, batch, sequence, timed rounds; one more round is profiled), with
# the launcher's 0.1 fp32 frames (its encoder runs in fp32: the fp32 flash
# kernels at [G*b*16, 1024, 64]; its decoder the bf16 ones at [G*b*16, T,
# 64]) and the fused aggregation, launched once per group a round (bf16
# [1, m, 878,143,488] and fp32 [1, m, 12], the 12 cross gates); then at
# 2 + 2 layers down the kernel path and the plain path (phase 6's bar
# PATHS_TOL on the clients' updates: over all parameters, on each attention
# projection and on the fp32 group); then TRAIN_ZOO_ARCHS at reduced() in
# bf16 (two groups) with TRAIN_ZOO (clients, local steps, batch, sequence,
# rounds), kernel vs plain within PATHS_TOL; and the flash kernels at the
# path's shapes (TRAIN_FLASH, (bh, t, d, dtype)) and the aggregation at both
# groups' shapes, checked and timed
SEAMLESS_TRAIN = dict(clients=4, steps=2, batch=2, seq=512, rounds=5)
SEAMLESS_BF16_N = 878_143_488
TRAIN_ZOO_ARCHS = ("mixtral-8x22b", "llama4-maverick-400b-a17b",
                   "jamba-1.5-large-398b", "llama-3.2-vision-90b")
TRAIN_ZOO = dict(clients=2, steps=2, batch=2, seq=64, rounds=2)
TRAIN_FLASH = ((128, 1024, 64, "float32"), (128, 512, 64, "bfloat16"))
PHASE17_LIMIT_S = 150.0
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkdv")
# the wide-head route's three kernels (fp32 self-attention above D = 256)
FLASH_WIDE_NAMES = ("flash_attention_wide_fwd", "flash_attention_wide_bwd_dq",
                    "flash_attention_wide_bwd_dkdv")
# Phase 18, launch and checkpointing: the resumed SmolLM-135M run (full
# width and depth, bf16) and the two-group run (jamba at reduced() in bf16)
CKPT_LM = dict(clients=8, steps=2, batch=2, seq=512, rounds=4)
CKPT_GROUPS = dict(clients=2, steps=2, batch=2, seq=64, rounds=4)
# gqa_flash_attention at SmolLM's shape: [B, T, H, D] on KV heads
GQA_SHAPE = (2, 2048, 9, 64, 3)
DRYRUN_TOL = 0.02
PHASE18_LIMIT_S = 90.0
# Phase 19, RWKV6 training (ROADMAP item 10). (a) the WKV6 backward kernels
# (wkv6_bwd_state + wkv6_bwd_chunk, under the chunked forward) against the
# autograd of the plain chunked version at (b, h, t, d, decay): the prefill
# shape, strong decay over 4096 steps, ragged T, D = 128; then 40 heads of
# two models folded into the head axis, each model with its own bonus u, as
# the model stack lays them out
WKV_BWD_SHAPES = [(4, 40, 4096, 64, "ref"), (1, 4, 4096, 64, "strong"),
                  (2, 4, 63, 64, "ref"), (2, 4, 65, 64, "strong"),
                  (2, 4, 100, 64, "ref"), (2, 8, 512, 128, "ref")]
WKV_BWD_FOLDED = (1, 2, 40, 512, 64)      # (b, models, heads, t, d)
# every gradient divided by its largest magnitude, and dlog w = dw * w as it
# is, within fp32 atol = rtol of the plain version's autograd; dw itself is
# dlog w / w, whose fp32 rounding the division magnifies where w is small
# (strong decay: the plain version's own dw lies up to 7.7e-5 of its largest
# from the float64 function, the kernel's 1.0e-4; 0.5 relative at a small
# element)
WKV_BWD_TOL = 1e-3
# (b) reduced() rwkv6 through the kernels against the plain path: fp32 client
# updates within RWKV_TRAIN_FP32_TOL relative (the WKV6 kernels' ~4e-5
# forward and ~1e-6 backward errors through 2 local steps), bf16 in two
# groups within PATHS_TOL (phase 17's bar)
RWKV_TRAIN_REDUCED = dict(clients=2, steps=2, batch=2, seq=128, rounds=2)
RWKV_TRAIN_FP32_TOL = 1e-3
# (c) rwkv6-3b at full width and depth through launch/train.py --full:
# clients (halved while the run does not fit), local steps, batch, sequence,
# timed rounds (one more is profiled)
RWKV_TRAIN = dict(clients=4, steps=2, batch=1, seq=1024, rounds=4)
RWKV_PARAMS = 3_073_313_280
RWKV_FP32_PARAMS = 245_760
PHASE19_LIMIT_S = 150.0
# Phase 20, the sweep's multi-device split (ROADMAP item 6) on the one card,
# one worker process per mesh rank (repro_torch.sharding.pool): (a) phase
# 2's Table-1 cell for fedpbc (seeds 0-2, B = 3, use_kernel=True) on
# devices=[cuda:0] (NCCL, a world of 1) against mesh=None in this process,
# every CellResult field bitwise; (b) the same on two ranks sharing cuda:0
# (gloo; B = 3 padded to 4), bitwise or within SHARD_TOL (phase 3's bar)
# with the op named; (c) lm-family (LM_SWEEP: B = 8, m = 4, 10 rounds) on
# make_2d_mesh(1, 2) over cuda:0 twice (each rank trains 2 of the 4 clients
# of every trajectory) against one device within LM_PATHS_TOL
CELL_FIELDS = ("test_acc", "train_acc", "loss", "num_active", "server")
SHARD_TOL = 1e-5
PHASE20_LIMIT_S = 90.0

# Phase 21: the last seven suites of benchmarks/run.py on the port
# (repro_torch.paper), each through its run(...) with use_kernel=True and
# its JSON in a temporary directory. extensions runs its default protocol
# (250 rounds, m = 100) over seeds 0-2 at the reference's Eq.-9 p_base of
# each seed (REFERENCE_P_BASE: run_training draws p_base as the Table-1
# sweep does), Table 1's convention: each (scheme, algorithm) 3-seed mean
# must clear the JAX reference's 3-seed mean less ACC_MARGIN. One seed
# cannot be held to that bar: the reference's own seed 2 misses it
# (markov_nonhom fedpbc 0.5447, fedpbc_m 0.3960). The means, on the CPU:
#   PYTHONPATH=src python scripts/extensions_reference_bars.py
EXTENSIONS_REFERENCE_MEAN = {
    ("bernoulli_tv", "fedpbc"): 0.7206666999393039,
    ("bernoulli_tv", "fedpbc_m"): 0.648666693104638,
    ("markov_nonhom", "fedpbc"): 0.6370000309414333,
    ("markov_nonhom", "fedpbc_m"): 0.4917777975400288}
EXTENSIONS_ROUNDS = 250
EXTENSIONS_SEEDS = (0, 1, 2)
# The floor above is seed noise's measure: fedpbc_m's seed std on
# markov_nonhom is ~0.095, and with its momentum lost fedpbc_m would score
# as fedpbc does, above its bar. So phase 21 also holds FedPBC-M's momentum
# exactly, free of seed noise: run_training's first two rounds of fedpbc
# and fedpbc_m at one seed see the same draws, so round 1 leaves both
# servers equal and round 2's aggregate step is the same for both; FedPBC-M's
# server must then lead FedPBC's by FEDPBC_M_BETA times round 1's step
# (src/repro/core/algorithms.py:321, fedpbc_m_beta), within FP32_TOL.
FEDPBC_M_BETA = 0.8
# sweep, cut in rounds and seeds only (m = 32 and the widths as the
# suite's): 100 rounds -> 40, 8 seeds -> 4, the ablations' 4 seeds -> 2
# and their max(rounds // 3, 20) rounds -> 10
SWEEP_CUT = dict(rounds=40, n_seeds=4, ablation_seeds=2, ablation_rounds=10)
# lm_sweep at its own smoke configuration (the reference's --smoke: the
# quartet at lr 0.1, m = 4, d_model 32, 1 layer, T = 16, 2 rounds, one
# eval; its cohort arm fedpbc and fedavg at m = 64, C = 8), each arm run
# twice (warm, then timed) on one card
LM_SMOKE = dict(lm_layers=1, local_steps=1, rounds=2)
# scale at its --smoke configuration: m = 10,000, C = 256, 6 rounds
SCALE_SMOKE = dict(ms=(10_000,), rounds=6)
SCALE_DEADLINE = 4
PHASE21_LIMIT_S = 120.0
# phase 22 (the analysis gate's runtime half): phase 2's cell at 20 rounds
# under the host-sync census; SmolLM-135M served at full width for a few
# tokens (batch, prompt, gen); runner pins at one segment length no other
# phase uses, so its first call builds a runner
PHASE22_ROUNDS, PHASE22_EVAL_EVERY = 20, 10
PHASE22_SERVE = (8, 4, 4)
PHASE22_SEGMENT_ROUNDS = 3
PHASE22_PIN_ROUNDS = 5
PHASE22_LIMIT_S = 90.0
# phase 23 (the production meshes and the examples): the dry-run rows
# (arch, shape, multi_pod) counted in worker processes, the rank-0 run's
# row, the LM trainer example's arguments (a few rounds at 2 clients)
PHASE23_ROWS = (("smollm-135m", "train_4k", False),
                ("smollm-135m", "prefill_32k", False),
                ("smollm-135m", "decode_32k", False),
                ("smollm-135m", "train_4k", True))
PHASE23_RANK0 = ("smollm-135m", "prefill_32k")     # 16x16
PHASE23_TRAIN_ARGS = ("--rounds", "3", "--clients", "2", "--log-every", "1")
PHASE23_EXAMPLES = (("quickstart", ()), ("unreliable_links_demo", ()),
                    ("train_federated_lm", PHASE23_TRAIN_ARGS),
                    ("serve_batched", ()))
PHASE23_LIMIT_S = 150.0
# Phase 24, sequence-parallel activations in the sharded LM sweep (ROADMAP
# item 6c): two gloo ranks sharing cuda:0 (make_2d_mesh(1, 2)), each
# sequence split over "model" (run_sharded_2d's activation_spec =
# P(None, "model", None)); (a) lm-family as LM_SWEEP (10 rounds), (b)
# lm-wide cut from phase 12's 5 rounds to SEQ_WIDE_ROUNDS so that the phase
# fits, each against its single-device run within LM_PATHS_TOL; (c) the
# flash kernels' causal-offset route alone at rank 1's local shapes of (a)
# and (b) in fp32 and at a bf16 shape at SmolLM's head dim, as (bh, tq, d,
# q_offset, dtype), beside their aligned twins (bh, t, d, dtype) re-timed
# in the same call
SEQ_WIDE_ROUNDS = 1
SEQ_OFFSET_SHAPES = ((256, 16, 16, 16, "float32"),
                     (256, 128, 128, 128, "float32"),
                     (144, 1024, 64, 1024, "bfloat16"))
SEQ_ALIGNED_TWINS = ((256, 32, 16, "float32"), (256, 256, 128, "float32"),
                     (144, 2048, 64, "bfloat16"))
PHASE24_LIMIT_S = 120.0
# Phase 25, the sequence split of the MoE, RWKV6 and hybrid families (ROADMAP
# item 6d) on phase 24's make_2d_mesh(1, 2) of cuda:0, and the WKV6
# kernels' zero-padded head-dim route: (a) the route alone at head dims 16
# and 32 as (b, heads, T, D) (the rwkv6 LM sweep's training call at
# d_model 64: 8 trajectories x 4 clients x 4 heads of 16; the same at
# d_model 128), then LM_SWEEP at rwkv6-3b on one device through it against
# the plain path; (b) LM_SWEEP at each of SEQ_FAMILY_ARCHS split over the
# two ranks against one device; (c) lm-wide (LM_WIDE, one round) at each
# of SEQ_FAMILY_WIDE_ARCHS likewise, and WKV6 at rank 1's local shape there
# from a carried state, timed. (c) runs rwkv6 alone so that the whole smoke
# keeps its room in 1,200 s: mixtral there took 36.8 s of a 113.7-s phase
# (NVIDIA H100 at 700 W), and phase 24b runs the flash offset route at
# lm-wide's shape already; jamba's Mamba has no kernel of its own
SEQ_FAMILY_ARCHS = ("rwkv6-3b", "mixtral-8x22b", "jamba-1.5-large-398b")
SEQ_FAMILY_WIDE_ARCHS = ("rwkv6-3b",)
WKV_PAD_SHAPES = ((2, 128, 32, 16), (2, 128, 32, 32))
PHASE25_LIMIT_S = 150.0
# Phase 26, the LM sweep at every width the reference runs: reduced()
# keeps 4 heads, so lm_d_model / 4 passes the WKV6 kernels' 128 above
# lm_d_model 512 and the flash kernels' 256 above 1024. 26a: the WKV6 block
# route, (b, h, t, d), at 26b's launch shape (lm-family's G = 32 models x
# 4 heads of 256, b 2, T = 32: rwkv6-3b at lm_d_model 1024), and at b 2,
# 4 heads, T = 128, at D = 256 and at rwkv6-3b's own width, 2,560 (D = 640);
# the wide-head flash kernels at 26b's launch shape (lm-family's G = 32
# models x b 2 x 4 heads, T = 32, D = 288) and at D = 512 (lm_d_model
# 2048), (bh, t, d). 26b: lm-family through the kernels at
# (smollm-135m, 1152: flash D = 288) and (rwkv6-3b, 1024: WKV6 D = 256),
# cut to 3 rounds as lm-576 is, against the plain path.
WIDE_WKV_SHAPES = ((2, 128, 32, 256), (2, 4, 128, 256), (2, 4, 128, 640))
WIDE_FLASH_SHAPES = ((256, 32, 288), (64, 256, 512))
LM_WIDE_HEADS = (("smollm-135m", 1152), ("rwkv6-3b", 1024))
LM_WIDE_HEADS_CUT = dict(rounds=3, eval_every=3)
# 26b's peak device memory a run, kept well inside the card's 80 GB
WIDE_HEADS_PEAK_GIB = 40.0
PHASE26_LIMIT_S = 90.0


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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
    from repro_torch.launch.roofline import peak_rates

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
    ``nvcc -Xptxas -v`` report; a flash kernel's causal-offset
    instantiation is ``<kernel>_offset``, and a kernel that is no template
    on the head dim (the wide-head route's) has head dim None."""
    table, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(flash_[a-z_]+?)(ILi(\d+)E(Lb1E)?|E)", line)
            key = None if m is None else (
                m.group(1) + ("_offset" if m.group(4) else ""),
                int(m.group(3)) if m.group(3) else None)
            if key:
                table[key] = {}
        elif key and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            table[key].update({f"spill_{kind}": int(n) for n, kind in nums})
        elif key and "Used" in line and "registers" in line:
            table[key]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return table


def tf32_peak(torch):
    """The card's dense TF32 tensor-core rate (flop/s): half its bf16 one
    (``roofline.peak_rates``), as NVIDIA's data sheets give it for all
    three H100 variants."""
    from repro_torch.launch.roofline import peak_rates

    return peak_rates(torch.cuda.get_device_name(0))[2] / 2


def check_flash_shape(torch, fa, ref, gen, shape, tag, forward_only=False):
    """Forward and dq/dk/dv of the kernels against the plain version and
    its autograd at ``shape`` (b, h, t, d, window, softcap, dtype, causal)
    within ``FLASH_TOL``; fails on a mismatch, returns the max |err| of
    each output. ``forward_only``: the forward alone (a serving shape)."""
    b, h, t, d, win, cap, dtype, causal = shape
    dt = getattr(torch, dtype)
    dev = gen.device
    q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device=dev)
                  .to(dt) for _ in range(4))
    ts = [x.clone().requires_grad_(not forward_only) for x in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, window=win,
                             logit_softcap=cap)
    rs = [x.float().requires_grad_(not forward_only) for x in (q, k, v)]
    want = ref.flash_attention_ref(*rs, causal=causal, window=win,
                                   logit_softcap=cap)
    grads = want_grads = ()
    if not forward_only:
        grads = torch.autograd.grad(out, ts, g)
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
                 window=0, cap=0.0, forward_only=False, q_offset=0,
                 wide=False):
    """The three kernels at ``[bh, t, d]`` causal, with ``window`` and
    softcap ``cap`` (CUDA-graph replays; ``q_offset``: the causal-offset
    route, keys ``[bh, q_offset + t, d]``, SDPA then with an explicit
    bottom-right boolean mask), the plain version and its
    autograd (CUDA events around eager calls) and one
    ``scaled_dot_product_attention`` call forward and backward (the
    yardstick; the port never calls it); each pass's bound from its bytes
    at ``bw`` and its flops at ``peak`` (the dtype's rate) for the pairs
    the causal mask and the window allow, and for fp32 the tensor-core
    bound, bytes or three times the flops at ``tf32_peak`` (3xTF32). SDPA has neither a window nor a
    softcap: with either, its time is of plain causal attention (more
    pairs, no tanh), kept as ``sdpa_ms`` and not as ``library_ms``.
    ``forward_only``: the forward alone (a serving shape, which no path
    differentiates). ``wide``: the wide-head route's kernels (fp32 above D
    = 256, self-attention), and SDPA under the first of its backends that
    runs at this shape (flash, memory-efficient, cuDNN, math), named as
    ``sdpa_backend``."""
    import contextlib

    import torch.nn.functional as F

    from repro_torch.launch.roofline import flash_work

    dev = gen.device
    dt = getattr(torch, dtype)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    if wide:
        fwd_fn, dq_fn, dkdv_fn = (fa.flash_attention_wide_fwd,
                                  fa.flash_attention_wide_bwd_dq,
                                  fa.flash_attention_wide_bwd_dkdv)
    else:
        kw["q_offset"] = q_offset
        fwd_fn, dq_fn, dkdv_fn = (fa.flash_attention_fwd,
                                  fa.flash_attention_bwd_dq,
                                  fa.flash_attention_bwd_dkdv)
    tk = q_offset + t
    q, do = (torch.randn(bh, t, d, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, generator=gen, device=dev).to(dt)
            for _ in range(2))
    o, lse = fwd_fn(q, k, v, **kw)
    ms = {"fwd": time_ms(lambda: fwd_fn(q, k, v, **kw), iters=20)}
    if not forward_only:
        dq, delta = dq_fn(q, k, v, o, do, lse, **kw)
        ms["dq"] = time_ms(lambda: dq_fn(q, k, v, o, do, lse, **kw),
                           iters=20)
        ms["dkdv"] = time_ms(lambda: dkdv_fn(q, k, v, do, lse, delta, **kw),
                             iters=20)
        del dq, delta
    # the plain version: forward, and its autograd for dq alone and for
    # dk, dv alone (each less the forward it reruns)
    qr, kr, vr = (x.clone().requires_grad_(not forward_only)
                  for x in (q, k, v))

    def plain_fwd():
        return ref.flash_attention_ref(qr, kr, vr, window=window,
                                       logit_softcap=cap, q_offset=q_offset)

    plain_f = time_ms_events(plain_fwd, iters=5)
    plain = {"fwd": plain_f}
    if not forward_only:
        plain["dq"] = time_ms_events(lambda: torch.autograd.grad(
            plain_fwd(), [qr], do), iters=5) - plain_f
        plain["dkdv"] = time_ms_events(lambda: torch.autograd.grad(
            plain_fwd(), [kr, vr], do), iters=5) - plain_f
    del qr, kr, vr
    torch.cuda.empty_cache()
    # the yardstick: one scaled_dot_product_attention call, forward and
    # backward (its backward computes dq, dk and dv together)
    q4, k4, v4 = (x.view(1, bh, x.shape[1], d).clone().requires_grad_(True)
                  for x in (q, k, v))
    # the causal mask: is_causal (top-left) for self-attention, an explicit
    # bottom-right one at an offset
    mask = None
    if q_offset:
        pos = torch.arange(tk, device=dev)
        mask = pos[q_offset:, None] >= pos[None, :]
    causal = dict(is_causal=True) if mask is None else dict(attn_mask=mask)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, **causal)

    backend, pick = None, contextlib.nullcontext
    if wide:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        for b in (SDPBackend.FLASH_ATTENTION,
                  SDPBackend.EFFICIENT_ATTENTION,
                  SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(b):
                    torch.autograd.grad(sdpa(), [q4, k4, v4],
                                        do.view(1, bh, t, d))
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            backend = b.name
            pick = functools.partial(sdpa_kernel, b)
            break
    same = not window and not cap
    with torch.no_grad(), pick():
        sdpa_err = (sdpa().float() - o.view(1, bh, t, d).float()).abs(
        ).max() if same else None
    with pick():
        lib_f = time_ms(lambda: F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), **causal), iters=20)
    sdpa_ms = {"fwd": lib_f}
    if not forward_only:
        with pick():
            lib_b = time_ms_events(lambda: torch.autograd.grad(
                sdpa(), [q4, k4, v4], do.view(1, bh, t, d)), iters=10) \
                - time_ms_events(sdpa, iters=10)
        sdpa_ms.update(dq=lib_b, dkdv=lib_b)
    note = "" if same else (" (causal only: SDPA has no window and no "
                            "softcap, so not the same function)")
    work = flash_work(bh, t, d, window, q.element_size(), q_offset)
    flops = {kk: f for kk, (f, _) in work.items()}
    nbytes = {kk: n for kk, (_, n) in work.items()}
    bound = {kk: max(nbytes[kk] / bw, flops[kk] / peak) * 1e3 for kk in ms}
    by = {kk: "operations" if flops[kk] / peak > nbytes[kk] / bw
          else "bytes" for kk in ms}
    tf32 = tf32_peak(torch)
    bound_tc = {kk: max(nbytes[kk] / bw, 3 * flops[kk] / tf32) * 1e3
                if dtype == "float32" else None for kk in ms}
    short = "bf16" if dtype == "bfloat16" else "fp32"
    masks = "causal" + (f", window {window}" if window else "") + (
        f", softcap {cap:g}" if cap else "") + (
        f", q_offset {q_offset} (bottom-right SDPA mask)" if q_offset
        else "")
    at = f"[{bh},{t},{d}]" if not q_offset else f"[{bh},{t}|{tk},{d}]"
    route = "flash_attention_wide_" if wide else "flash_attention_"
    named = f" ({backend} backend)" if backend else ""
    for kk in ms:
        print(f"{tag} timing {route}"
              f"{'fwd' if kk == 'fwd' else 'bwd_' + kk} "
              f"{at} {short} {masks}: kernel {ms[kk]:.5f} ms, "
              f"plain {plain[kk]:.5f} ms, scaled_dot_product_attention"
              f"{named} {'fwd' if kk == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{sdpa_ms[kk]:.5f} ms{note}, bound {bound[kk]:.5f} ms "
              f"({flops[kk]:.4e} flop at {peak / 1e12:g} TFLOP/s {short}; "
              f"{nbytes[kk]} bytes)"
              + ("" if bound_tc[kk] is None else
                 f", tensor-core bound {bound_tc[kk]:.5f} ms (3 x the flop "
                 f"at {tf32 / 1e12:g} TFLOP/s tf32)")
              + f", {flops[kk] / ms[kk] / 1e9:.2f} TFLOP/s achieved",
              flush=True)
    if not forward_only:
        bwd = ms["dq"] + ms["dkdv"]
        print(f"{tag} backward total (dq + dkdv) vs SDPA backward{note}, "
              f"{at} {short} {masks}: {ms['dq']:.5f} + "
              f"{ms['dkdv']:.5f} = {bwd:.5f} ms vs {lib_b:.5f} ms, "
              f"{bwd / lib_b:.2f}x; "
              f"{(flops['dq'] + flops['dkdv']) / bwd / 1e9:.2f} TFLOP/s",
              flush=True)
    if same:
        print(f"{tag} scaled_dot_product_attention vs kernel forward: max "
              f"|diff| {sdpa_err.item():.3e}", flush=True)
    del q, k, v, do, o, lse, q4, k4, v4
    torch.cuda.empty_cache()
    return {kk: dict(ms=ms[kk], plain_ms=plain[kk],
                     library_ms=sdpa_ms[kk] if same else None,
                     sdpa_ms=sdpa_ms[kk], bound_ms=bound[kk],
                     bound_by=by[kk], bound_tc_ms=bound_tc[kk],
                     flops=flops[kk], bytes=nbytes[kk],
                     shape=[bh, t, d], dtype=dtype, window=window,
                     softcap=cap, **({"tk": tk, "q_offset": q_offset}
                                     if q_offset else {}),
                     **({"sdpa_backend": backend} if wide else {}))
            for kk in ms}


def phase4_flash(torch, fa, ref, bw, bf16_peak, fp32_peak, build_log):
    print_ptxas("phase4", build_log)
    ptxas = ptxas_table(build_log)
    names = list(FLASH_TC.values()) + list(FLASH_F32.values())
    for name in names + [n + "_offset" for n in names]:
        got = {kk[1]: vv for kk, vv in ptxas.items() if kk[0] == name}
        print(f"phase4 ptxas {name} by head dim: " + "; ".join(
            f"D={dd}: {vv.get('registers')} registers, spill stores "
            f"{vv.get('spill_stores')} B, loads {vv.get('spill_loads')} B"
            for dd, vv in sorted(got.items())), flush=True)
    if sorted({kk[1] for kk in ptxas}) != list(fa.HEAD_DIMS):
        fail(f"the build's head dims {sorted({kk[1] for kk in ptxas})} are "
             f"not the wrapper's {fa.HEAD_DIMS}")
    for name in [*FLASH_F32.values(),
                 *(n + "_offset" for n in FLASH_F32.values())]:
        got = {kk[1]: vv for kk, vv in ptxas.items() if kk[0] == name}
        if sorted(got) != list(fa.HEAD_DIMS) or any(
                vv.get("spill_stores") or vv.get("spill_loads")
                for vv in got.values()):
            fail(f"ptxas reports spills in {name}, or misses a head dim")
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
    # registers and spills by head dim, of the bf16 and the fp32 kernels
    design = {kk: {f"D={key[1]}": vv for key, vv in sorted(ptxas.items())
                   if key[0] == FLASH_TC[kk]} for kk in timed}
    f32 = {kk: {f"D={key[1]}": vv for key, vv in sorted(ptxas.items())
                if key[0] == FLASH_F32[kk]} for kk in timed}
    for kk, r in timed.items():
        del r["shape"], r["dtype"], r["window"], r["softcap"]
        pick = (lambda e: e["o"]) if kk == "fwd" else (
            lambda e: e["dq"]) if kk == "dq" else (
            lambda e: max(e["dk"], e["dv"]))
        r.update(ptxas=design[kk], ptxas_fp32=f32[kk],
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


def wkv_work(b, h, t, d, direction="fwd"):
    """(bytes, flops) one WKV6 call needs (``roofline.wkv6_work``): each
    input read and each output written once, the flops of the step
    recurrence (forward: 5 D^2 + 5 D per (b, h) and step; backward: 14 D^2
    + 13 D). The chunked form the kernels run does more (pairwise scores,
    exponentials, the chunk-state workspaces); that is its cost, not the
    function's."""
    from repro_torch.launch.roofline import wkv6_work

    flops, nbytes = wkv6_work(b * h, t, d, heads=h)[direction]
    return nbytes, flops


def wkv_ptxas(log, kernels):
    """{kernel: {head dim: {registers, spill_stores, spill_loads, smem}}}
    of the WKV6 kernels from an ``nvcc -Xptxas -v`` report (``smem``: the
    static shared memory ptxas reports; the dynamic one is
    ``rk.shared_bytes``)."""
    table, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(wkv6_[a-z_]+)ILi(\d+)E", line)
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
    if "wkv6_bwd" in n:
        return "wkv6 backward (CUDA)"
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


def profile_window(torch, label, fn, per, unit, top=0):
    """``fn`` once under ``torch.profiler`` (CPU and CUDA activities):
    wall and device kernel time per ``unit`` (``per`` of them in one call),
    the device's idle share (1 - kernel time / wall time; the kernels run
    on one stream), kernels and ``aten`` operator calls per unit, and the
    device time per unit by kernel family (and, with ``top``, of that many
    kernels, the longest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_family, by_kernel, device_us, kernels, aten = {}, {}, 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            aten += ev.count if ev.key.startswith("aten::") else 0
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + us
        by_kernel[ev.key[:120]] = by_kernel.get(ev.key[:120], 0.0) + us
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
    if top:
        out[f"device_ms_per_{unit}_by_kernel"] = {
            k: v / 1e3 / per for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:top]}
    print(f"{label} profiled (torch.profiler): " + json.dumps(out),
          flush=True)
    return out


def reset_wkv_counts(rk):
    """The WKV6 wrapper's counts to 0: calls, and calls by route and the
    backward's."""
    rk.reset_counts()


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
    suites give it: Fig. 3's ``[1, 50, 50]`` (and its 2-D route; ``run_one``)
    and ``[9, 50, 50]`` (an algorithm's batch, ``run_batch``), Table 2's
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
        ((9, 50, 50), [0, 1, 2] * 3),
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
        torch, f"phase9 fig3 run_one fedpbc (0.9, 0.1), {FIG3_PROFILE_ROUNDS} "
        f"rounds", lambda: fig3_quadratic.run_one(
            "fedpbc", 0.9, 0.1, seed=0, use_kernel=True,
            **dict(protocol, rounds=FIG3_PROFILE_ROUNDS)),
        FIG3_PROFILE_ROUNDS, "round")
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
    from repro_torch.launch.roofline import peak_rates

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

        with _Recorded(fig3_quadratic, "run_batch") as runs:
            fig3, launches = suite("fig3", lambda: fig3_quadratic.run(
                rounds=FIG3_ROUNDS, use_kernel=True))
        for key, ref in FIG3_REFERENCE.items():
            port = [tr[-1][1] for args, out, _ in runs if args[0] == key[0]
                    for tr in out[key[1:]]]
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
        if launches != 2 * FIG3_ROUNDS:
            fail(f"Fig. 3 launched the aggregation {launches} times, "
                 f"expected {2 * FIG3_ROUNDS} (one a round for each "
                 f"algorithm's batch)")
        for args, out, sec in runs:
            b = sum(len(v) for v in out.values())
            res["batches"].append({
                "suite": "fig3", "scheme": "bernoulli_ti (p0, p1)",
                "algos": [args[0]], "trajectories": b, "rounds": FIG3_ROUNDS,
                "seconds": sec, "rounds_per_s": FIG3_ROUNDS / sec})
            print(f"phase9 fig3 bernoulli_ti (p0, p1) {args[0]}: "
                  f"{FIG3_ROUNDS} rounds x {b} trajectories in {sec:.3f} s = "
                  f"{FIG3_ROUNDS / sec:.2f} rounds/s", flush=True)
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


def _flash_launches(model, cfg):
    """The flash forward's launches in one ``forward`` and in one
    ``decode_step``: one per self-attention layer of a full or swa kind
    (``dispatch.attention``; not the SSM layers, not chunked ones), plus
    one per audio encoder layer in both (``decode_step`` encodes the
    memory again at every step, as the reference's does)."""
    enc = cfg.encoder_layers if cfg.family == "audio" else 0
    layers = sum(cfg.layer_kind(i) != "ssm"
                 and model.attn_kind(cfg, i) in ("full", "swa")
                 for i in range(cfg.num_layers))
    return layers + enc, enc


def _teacher_forcing(torch, fa, model, params, cfg, toks, label, tol,
                     memory=None):
    """``forward`` on ``toks [1, T]`` (and ``memory``) through the flash
    kernel and through the plain attention against T ``decode_step``
    calls: max |decode - forward| / max |forward| of each, and kernel vs
    plain; fails past ``tol`` (None: measured). For an MoE model also the
    (layer, token) pairs whose top-k experts differ between the paths: in
    bf16 a hidden state that rounds otherwise may tip a near tie of the
    router."""
    from repro_torch.models import moe as moe_mod

    dev = toks.device
    T = toks.shape[1]
    per_forward, per_step = _flash_launches(model, cfg)
    picks = {}
    with torch.no_grad():
        fwd = {}
        for path, backend in (("kernel", None), ("plain", "torch")):
            fa.flash_attention_fwd.launches = 0
            (fwd[path], _), picks[path] = _picks(moe_mod, lambda: (
                model.forward(params, cfg, toks, memory=memory,
                              backend=backend)))
            want = per_forward if path == "kernel" else 0
            if fa.flash_attention_fwd.launches != want:
                fail(f"{label}: the {path} forward launched the flash "
                     f"kernel {fa.flash_attention_fwd.launches} times, "
                     f"expected {want}")

        def decode():
            cache = model.make_cache(cfg, 1, T, device=dev)
            outs = []
            for t in range(T):
                lg, cache = model.decode_step(params, cfg, toks[:, t:t + 1],
                                              cache, t, memory=memory)
                outs.append(lg[:, 0])
            return torch.stack(outs, 1)

        fa.flash_attention_fwd.launches = 0
        dec, picks["decode"] = _picks(moe_mod, decode)
    if fa.flash_attention_fwd.launches != per_step * T:
        fail(f"{label}: decode_step launched the flash kernel "
             f"{fa.flash_attention_fwd.launches} times, expected "
             f"{per_step * T}")
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
        # the decode's error before its first token routed otherwise: a
        # flip changes that token's hidden state and, through the caches,
        # every later one
        flipped = (by_layer(picks["decode"]) != want).any(-1).any(0)
        first = int(flipped.nonzero()[0]) if flipped.any() else T
        rel["first_flipped_token"] = first
        rel["plain_before_first_flip"] = (
            (dec[:, :first] - fwd["plain"][:, :first]).abs().max()
            / fwd["plain"].abs().max()).item() if first else None
        flips = (f"; (layer, token) pairs routed otherwise than the plain "
                 f"forward: kernel forward {rel['routing_flips']['kernel']}"
                 f", decode {rel['routing_flips']['decode']} of {L * T}; "
                 f"decode vs plain forward before the first such token "
                 f"({first}): {rel['plain_before_first_flip']}")
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


def _first_periods(params, n, encoder_layers=None):
    """The leaves of a model's first ``n`` periods (views), and of the
    audio encoder's first ``encoder_layers`` layers if given."""
    out = {}
    for k, v in params.items():
        if k.startswith("blocks."):
            v = v[:n]
        elif k.startswith("encoder.") and encoder_layers is not None:
            v = v[:encoder_layers]
        out[k] = v
    return out


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


def _zoo_memory(torch, cfg, b, dev):
    """Seeded ``0.1 * N(0, 1)`` image tokens (vlm) or audio frames (audio)
    ``[b, M, d_model]`` fp32 (constant memory makes every token alike)."""
    m = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
    gen = torch.Generator(device=dev).manual_seed(ZOO_MEMORY)
    return 0.1 * torch.randn(b, m, cfg.d_model, generator=gen, device=dev)


def _range_share(torch, module, attr, fn):
    """``fn()`` under ``torch.profiler`` with every call of
    ``module.attr`` inside a ``record_function`` range: the ranges' time on
    the device (their GPU annotations in the trace, each the span from the
    first kernel of a call to its last) over the device time of all
    kernels."""
    from unittest import mock

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    real, name = getattr(module, attr), f"range_{attr}"

    def ranged(*a, **kw):
        with record_function(name):
            return real(*a, **kw)

    torch.cuda.synchronize()
    with mock.patch.object(module, attr, ranged), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = span = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if ev.key == name:
            span += us
        else:
            total += us
    if not span:
        fail(f"the profile of {attr} has no GPU annotation of its ranges")
    return dict(share=span / total, range_device_ms=span / 1e3,
                total_device_ms=total / 1e3)


def phase16_flash(torch, fa, ref, bw, bf16_peak, fp32_peak):
    """The flash forward at phase 16's shapes (``ZOO_FLASH``) against its
    plain version within ``FLASH_TOL``, and timed beside the plain version,
    SDPA's causal forward and its bound."""
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(16)
    out = {}
    for b, h, t, d, dtype in ZOO_FLASH:
        err = check_flash_shape(torch, fa, ref, gen,
                                (b, h, t, d, 0, 0.0, dtype, True), "phase16",
                                forward_only=True)
        peak = bf16_peak if dtype == "bfloat16" else fp32_peak
        r = flash_timing(torch, fa, ref, gen, b * h, t, d, dtype, bw, peak,
                         "phase16", forward_only=True)["fwd"]
        out[f"[{b * h},{t},{d}] {dtype}"] = dict(r, max_abs_err=err["o"])
        torch.cuda.empty_cache()
    return out


def phase16_seamless(torch, fa, card):
    """seamless-m4t-medium at full width and depth: the serve launcher
    (the fp32 encoder through the flash kernel at every step), a prefill
    forward with seeded frames, kernel vs plain at 2 + 2 layers, teacher
    forcing."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    arch = "seamless-m4t-medium"
    cfg = get_config(arch)
    if (cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.head_dim,
            cfg.vocab_size) != (12, 12, 1024, 64, 256206):
        fail("seamless-m4t-medium's config is not the published one")
    res = {"n_params": cfg.param_count()}
    params, res["init_s"], _, _ = _counted(torch, counters, lambda: (
        model.init_leaves(torch.Generator(device=dev).manual_seed(0), cfg)))
    res["n_leaf_params"] = sum(v.numel() for v in params.values())
    print(f"phase16a {arch}: {cfg.encoder_layers} encoder + "
          f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.attention.num_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, untied head, GELU MLP; param_count "
          f"{res['n_params']}, {res['n_leaf_params']} with audio_proj and "
          f"enc_norm, bf16, seeded in {res['init_s']:.2f} s (not cut)",
          flush=True)
    per_forward, per_step = _flash_launches(model, cfg)
    b, p_len, g_len = SEAMLESS_SERVE
    args = ["--arch", arch, "--full", "--batch", str(b)]
    res["profile"] = profile_window(
        torch, f"phase16a serve {arch} (batch {b}, prompt 4, gen 4)",
        lambda: serve.main(args + ["--prompt-len", "4", "--gen", "4"],
                           params=params), 8, "step")
    out, _, launches, peak = _counted(torch, counters, lambda: serve.main(
        args + ["--prompt-len", str(p_len), "--gen", str(g_len)],
        params=params))
    steps = p_len + g_len
    want = [per_step * steps, 0, 0]
    decode_s = out["seconds"] - out["prefill_seconds"]
    print(f"phase16a serve {arch} --full batch {b} prompt {p_len} gen "
          f"{g_len} on {card}: {out['seconds']:.4f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s incl. prefill (decode "
          f"{b * g_len / decode_s:.1f} tokens/s, "
          f"{1e3 * out['seconds'] / steps:.3f} ms per step); idle share "
          f"{res['profile']['device_idle_share']:.3f} (profiled window); "
          f"first ids {out['ids'][0][:12].tolist()}; flash launches "
          f"{launches} (want {want}: {per_step} a step, the encoder); peak "
          f"memory {peak / 2 ** 30:.3f} GiB; done at "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if tuple(out["ids"].shape) != (b, g_len) or not (
            (out["ids"] >= 0) & (out["ids"] < cfg.vocab_size)).all():
        fail(f"{arch}: the served ids are misshapen or out of the "
             f"vocabulary")
    if launches != want:
        fail(f"{arch}: serving launched flash kernels {launches}, not "
             f"{want}")
    res["serve"] = dict(seconds=out["seconds"],
                        tokens_per_s=out["tokens_per_s"],
                        decode_tokens_per_s=b * g_len / decode_s,
                        ms_per_step=1e3 * out["seconds"] / steps,
                        peak_gib=peak / 2 ** 30, flash_launches=launches)
    del out

    # (b) a prefill forward with seeded frames, through the kernels
    B, T = ZOO_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(16)).to(dev)
    mem = _zoo_memory(torch, cfg, B, dev)

    def forward(p, c, tk, m, backend=None):
        with torch.no_grad():
            return model.forward(p, c, tk, memory=m, backend=backend)[0]

    logits, sec, launches, peak = _counted(torch, counters, lambda: (
        forward(params, cfg, toks, mem)))
    want = [per_forward, 0, 0]
    ok = (tuple(logits.shape) == (B, T, cfg.vocab_size)
          and torch.isfinite(logits).all().item() and launches == want)
    print(f"phase16a forward {arch} [{B}, {T}] with frames "
          f"{list(mem.shape)} fp32 on {card}: {sec:.4f} s = "
          f"{B * T / sec:.1f} tokens/s; logits {list(logits.shape)} finite; "
          f"flash launches {launches} (want {want}: encoder and decoder, "
          f"one a layer); peak memory {peak / 2 ** 30:.3f} GiB "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail(f"{arch}: the forward is misshapen or non-finite, or launched "
             f"{launches}, not {want}")
    res["forward"] = dict(seconds=sec, tokens_per_s=B * T / sec,
                          peak_gib=peak / 2 ** 30, flash_launches=launches)
    del logits
    c2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
    p2 = _first_periods(params, 2, encoder_layers=2)
    kern = forward(p2, c2, toks[:1], mem[:1])
    plain = forward(p2, c2, toks[:1], mem[:1], "torch")
    rel = ((kern - plain).abs().max() / plain.abs().max()).item()
    print(f"phase16a forward [1, {T}] at 2 + 2 layers, kernel vs plain "
          f"attention: max |logit diff| / max |logit| {rel:.3e} (limit "
          f"{ZOO_PATHS_TOL:g}) {'ok' if rel <= ZOO_PATHS_TOL else 'OUTSIDE'}"
          f"; done at {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not rel <= ZOO_PATHS_TOL:
        fail(f"{arch}: the forward through the kernel disagrees with the "
             f"plain attention")
    res["forward"]["kernel_vs_plain_2_2_layers"] = rel
    del kern, plain
    torch.cuda.empty_cache()

    # (c) teacher forcing, decoder and encoder cut alike
    res["teacher_forcing"] = {}
    for dtype, layers, tol in SEAMLESS_TF_CASES:
        c = dataclasses.replace(cfg, dtype=dtype, num_layers=layers,
                                encoder_layers=layers)
        p = _first_periods(params, layers, encoder_layers=layers)
        if dtype == "float32":
            p = {k: v.float() for k, v in p.items()}
        res["teacher_forcing"][f"{dtype}_{layers}_layers"] = \
            _teacher_forcing(torch, fa, model, p, c,
                             toks[:1, :SEAMLESS_TF_T], f"phase16a {arch}",
                             tol, memory=mem[:1])
        del p
        torch.cuda.empty_cache()
    del params, mem
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase16a {arch} done in {res['seconds']:.1f} s", flush=True)
    return res


def phase16_reduced(torch, fa, card, arch, layers, experts):
    """llama-3.2-vision-90b or jamba-1.5-large-398b at published widths and
    reduced depth (and jamba's experts cut): a prefill, greedy decode
    steps, (vlm) kernel vs plain at one period, teacher forcing."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    cut = {"num_layers": [full.num_layers, layers]}
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
        cut["num_experts"] = [full.moe.num_experts, experts]
    row = {"reduced": cut, "n_params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    params, row["init_s"], _, _ = _counted(torch, counters, lambda: (
        model.init_leaves(torch.Generator(device=dev).manual_seed(0), cfg)))
    gates = [k for k in params if k.endswith("cross_gate")]
    for k in gates:             # tanh(0) = 0 would switch the cross layers off
        params[k].fill_(1.0)
    P = model.period_length(cfg)
    kinds = [cfg.layer_kind(i) for i in range(P)]
    print(f"phase16b {arch}: reduced " + ", ".join(
        f"{k} {a} -> {b}" for k, (a, b) in cut.items())
        + f" (published widths: d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"{cfg.attention.num_heads} heads of {cfg.head_dim} on "
        f"{cfg.attention.num_kv_heads} KV heads, period {P}: {kinds}"
        + (f", MoE {cfg.moe.num_experts} experts top-{cfg.moe.top_k} "
           f"every {cfg.moe_every}" if cfg.moe else "")
        + f"); {row['n_params']} parameters ({row['active_params']} active "
        f"a token), {row['n_params'] * 2 / 2 ** 30:.1f} GiB bf16, seeded in "
        f"{row['init_s']:.2f} s" + (f"; cross_gate set to 1.0 on "
                                   f"{len(gates)} leaves" if gates else ""),
        flush=True)
    per_forward, per_step = _flash_launches(model, cfg)
    B, T = ZOO_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(16)).to(dev)
    mem = _zoo_memory(torch, cfg, B, dev) if cfg.family == "vlm" else None
    dropped, real_moe = [], moe_mod.moe_apply

    def counted_moe(p, x, c):
        # the share of (token, choice) slots over capacity, read beside
        # the layer's own routing (one more router product)
        idx, _, _ = moe_mod._router(p, x, c)
        dropped.append(1.0 - moe_mod.slots(idx, c, x.shape[1])[1]
                       .float().mean())
        return real_moe(p, x, c)

    def prefill(b):
        with torch.no_grad():
            return model.forward(params, cfg, toks[:b], memory=(
                None if mem is None else mem[:b]))

    while True:
        dropped.clear()
        with mock.patch.object(moe_mod, "moe_apply", counted_moe):
            (logits, aux), sec, launches, peak = _counted(
                torch, counters, lambda: prefill(B))
        if peak <= ZOO_PEAK_GIB * 2 ** 30:
            break
        del logits, aux
        if B == 1:
            fail(f"{arch}: the prefill's peak passes {ZOO_PEAK_GIB:g} GiB "
                 f"at batch 1")
        print(f"phase16b {arch}: the prefill's peak "
              f"{peak / 2 ** 30:.3f} GiB passes {ZOO_PEAK_GIB:g} GiB; "
              f"halving its batch to {B // 2}", flush=True)
        B //= 2
        row.setdefault("reduced", {})["prefill_batch"] = [ZOO_PREFILL[0], B]
    drop = [d.item() for d in dropped]
    want = [per_forward, 0, 0]
    ok = (tuple(logits.shape) == (B, T, cfg.vocab_size)
          and torch.isfinite(logits).all().item() and launches == want
          and (not cfg.moe or (math.isfinite(aux.item()) and aux.item() > 0)))
    moe_note = (f"aux (balance loss, summed over {len(drop)} MoE layers) "
                f"{aux.item():.4f}; dropped at capacity factor "
                f"{cfg.moe.capacity_factor:g} by layer "
                f"{[round(d, 4) for d in drop]}; " if cfg.moe else "")
    print(f"phase16b {arch} prefill forward [{B}, {T}]"
          + (f" with image tokens {list(mem.shape)} fp32" if mem is not None
             else "") + f" on {card}: {sec:.4f} s = {B * T / sec:.1f} "
          f"tokens/s; {moe_note}flash launches {launches} (want {want}: one "
          f"per self-attention layer); peak memory {peak / 2 ** 30:.3f} GiB "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        fail(f"{arch}: the prefill is misshapen or non-finite, its aux is "
             f"not positive, or its flash launches are {launches}, not "
             f"{want}")
    row["prefill"] = dict(batch=B, seconds=sec, tokens_per_s=B * T / sec,
                          peak_gib=peak / 2 ** 30, flash_launches=launches)
    if cfg.moe:
        row["prefill"].update(aux=aux.item(), dropped_share_by_layer=drop)
    tok = logits[:, -1].argmax(-1)[:, None]
    del logits
    if cfg.family == "hybrid":
        share = _range_share(torch, ssm_mod, "ssm_apply",
                             lambda: prefill(B))
        print(f"phase16b {arch} prefill profiled (torch.profiler): the "
              f"{kinds.count('ssm')} Mamba layers take "
              f"{share['range_device_ms']:.3f} of "
              f"{share['total_device_ms']:.3f} device ms = "
              f"{share['share']:.3f} (their ranges' GPU annotations)",
              flush=True)
        row["prefill"]["mamba_device_share"] = share

    def decode(n, tok=tok):
        cache = model.make_cache(cfg, B, n, device=dev)
        ids = []
        with torch.no_grad():
            for t in range(n):
                lg, cache = model.decode_step(params, cfg, tok, cache, t,
                                              memory=(None if mem is None
                                                      else mem[:B]))
                tok = lg[:, -1].argmax(-1)[:, None]
                ids.append(tok)
        return torch.cat(ids, 1)

    prof = profile_window(torch, f"phase16b {arch} decode (batch {B}, 4 "
                          f"steps)", lambda: decode(4), 4, "step")
    ids, sec, launches, peak = _counted(torch, counters,
                                        lambda: decode(ZOO_DECODE))
    want = [per_step * ZOO_DECODE, 0, 0]
    ok = (tuple(ids.shape) == (B, ZOO_DECODE) and launches == want
          and ((ids >= 0) & (ids < cfg.vocab_size)).all().item())
    print(f"phase16b {arch} greedy decode batch {B}, {ZOO_DECODE} steps: "
          f"{sec:.4f} s = {B * ZOO_DECODE / sec:.1f} tokens/s, "
          f"{1e3 * sec / ZOO_DECODE:.3f} ms per step; idle share "
          f"{prof['device_idle_share']:.3f} (profiled window); first ids "
          f"{ids[0][:8].tolist()}; flash launches {launches} (want {want}); "
          f"peak memory {peak / 2 ** 30:.3f} GiB {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        fail(f"{arch}: decode ids misshapen or flash launches {launches}")
    row["decode"] = dict(seconds=sec, tokens_per_s=B * ZOO_DECODE / sec,
                         ms_per_step=1e3 * sec / ZOO_DECODE,
                         peak_gib=peak / 2 ** 30, profile=prof,
                         flash_launches=launches)
    tf_params, tf_cfg = params, cfg
    if cfg.family == "vlm":                 # one period: 4 self + 1 cross
        tf_cfg = dataclasses.replace(cfg, num_layers=P)
        tf_params = _first_periods(params, 1)
        with torch.no_grad():
            kern, plain = (model.forward(tf_params, tf_cfg, toks[:1],
                                         memory=mem[:1], backend=be)[0]
                           for be in (None, "torch"))
        rel = ((kern - plain).abs().max() / plain.abs().max()).item()
        print(f"phase16b {arch} forward [1, {T}] at {P} layers, kernel vs "
              f"plain attention: max |logit diff| / max |logit| {rel:.3e} "
              f"(limit {ZOO_PATHS_TOL:g}) "
              f"{'ok' if rel <= ZOO_PATHS_TOL else 'OUTSIDE'}", flush=True)
        if not rel <= ZOO_PATHS_TOL:
            fail(f"{arch}: the forward through the kernel disagrees with "
                 f"the plain attention")
        row["kernel_vs_plain_one_period"] = rel
        del kern, plain
    if cfg.moe:
        m = cfg.moe
        tf_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    row["teacher_forcing"] = _teacher_forcing(
        torch, fa, model, tf_params, tf_cfg, toks[:1, :ZOO_TF_T],
        f"phase16b {arch}", None,
        memory=None if mem is None else mem[:1])
    del params, tf_params, toks, mem
    gc.collect()
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_phase
    print(f"phase16b {arch} done in {row['seconds']:.1f} s", flush=True)
    return row


def phase16_zoo(torch, fa, ref, card, bw, bf16_peak, fp32_peak):
    """The hybrid, vlm and audio families at published widths: the flash
    forward at their shapes, seamless-m4t-medium not cut, then vision and
    jamba at reduced depth, one model at a time; held to
    ``PHASE16_LIMIT_S``."""
    t_phase = time.perf_counter()
    res = {"flash": phase16_flash(torch, fa, ref, bw, bf16_peak, fp32_peak)}
    res["seamless-m4t-medium"] = phase16_seamless(torch, fa, card)
    for arch, layers, experts in MEMORY_CASES:
        res[arch] = phase16_reduced(torch, fa, card, arch, layers, experts)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase16 done in {res['seconds']:.1f} s (limit "
          f"{PHASE16_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE16_LIMIT_S:
        fail(f"phase 16 took {res['seconds']:.1f} s, over its "
             f"{PHASE16_LIMIT_S:g} s")
    return res


class _ByShape:
    """Inside ``with``: each of ``mod``'s ``names`` counts its calls by the
    dtype and shape of its first argument, ``counts[name]["<dtype> [..]"]``
    (keys only: no tensor is kept); the wrappers' own ``launches`` count
    as ever."""

    def __init__(self, mod, names):
        self.mod, self.names = mod, names
        self.counts = {n: {} for n in names}

    def __enter__(self):
        self.real = {n: getattr(self.mod, n) for n in self.names}
        for n, real in self.real.items():
            setattr(self.mod, n, self._Wrapper(self.counts[n], real))
        return self.counts

    class _Wrapper:
        """Calls ``real``, counting by its first argument; ``launches``
        (and a flash wrapper's ``offset_launches``) reads and writes
        ``real``'s (the wrapper stands in for it under its module name,
        which ``real`` counts its launches by)."""

        def __init__(self, counts, real):
            self.counts, self.real = counts, real

        def __call__(self, x, *a, **kw):
            key = f"{str(x.dtype).replace('torch.', '')} {list(x.shape)}"
            self.counts[key] = self.counts.get(key, 0) + 1
            return self.real(x, *a, **kw)

        @property
        def launches(self):
            return self.real.launches

        @launches.setter
        def launches(self, value):
            self.real.launches = value

        @property
        def offset_launches(self):
            return self.real.offset_launches

        @offset_launches.setter
        def offset_launches(self, value):
            self.real.offset_launches = value

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(self.mod, n, real)


def _train_args(arch, t, *extra):
    return ["--arch", arch, "--clients", str(t["clients"]), "--local-steps",
            str(t["steps"]), "--batch", str(t["batch"]), "--seq",
            str(t["seq"]), "--rounds", str(t["rounds"]), "--log-every", "1",
            *extra]


def _client_updates(out):
    """The clients' models less the initial server model, fp32, per group
    ``[1, m, n_g]`` (every client trains every round; the active ones then
    hold the new server model)."""
    from repro_torch.core.params import gmap

    return gmap(lambda c, i: c.float() - i.float()[:, None],
                out["state"].clients, out["initial"])


def _fp32_moved(torch, layout, out, label):
    """The layout's fp32 leaves are fp32 in the server and the clients and
    every client's has moved; returns their count."""
    fp32 = sorted(layout.fp32)
    server = layout.views(out["state"].server)
    clients = layout.views(out["state"].clients)
    initial = layout.views(out["initial"])
    bad = [k for k in fp32 if server[k].dtype != torch.float32
           or clients[k].dtype != torch.float32]
    still = [k for k in fp32 if any(torch.equal(c, initial[k][0])
                                    for c in clients[k][0])]
    if not fp32 or bad or still:
        fail(f"{label}: fp32 leaves {len(fp32)}, not fp32 {bad}, not moved "
             f"in some client {still}")
    return len(fp32)


def _paths_distance(torch, layout, updates, groups):
    """``||u_kernel - u_plain|| / ||u_plain||`` over all parameters, over
    the fp32 group and over the leaves of each suffix in ``groups``; 0 where
    neither path moves them (the cross-attention's ``wq`` and ``wk`` under
    the launcher's constant memory: every key is alike, so the softmax is
    flat whatever the query and their gradient is exactly zero), inf where
    only the kernel path does."""
    def rel(a, b):
        if b.norm() == 0:
            return 0.0 if a.norm() == 0 else math.inf
        return ((a - b).norm() / b.norm()).item()

    k, p = updates["kernel"], updates["plain"]
    out = {"all": rel(torch.cat([x.reshape(-1) for x in k]),
                      torch.cat([x.reshape(-1) for x in p])),
           "fp32 group": rel(k[1], p[1])}
    kv, pv = layout.views(k), layout.views(p)
    for g in groups:
        names = [n for n in kv if n.endswith(g)]
        if names:
            out[g] = rel(torch.cat([kv[n].reshape(-1) for n in names]),
                         torch.cat([pv[n].reshape(-1) for n in names]))
    return out


def _two_paths(torch, train, fa, args, want_flash, label):
    """``train.main(args)`` down the kernel path (flash kernels, fused
    aggregation) and the plain path (``backend="torch"``, the branch
    aggregation) from the same generators; each path's flash launches
    checked (``want_flash`` each on the kernel path, none on the plain
    one). Returns ``({path: out}, {path: seconds})``."""
    counters = [getattr(fa, n) for n in FLASH_NAMES]
    outs, secs = {}, {}
    try:
        for path, backend, agg in (("kernel", None, "1"),
                                   ("plain", "torch", "0")):
            os.environ["REPRO_USE_KERNEL"] = agg
            out, secs[path], launches, _ = _counted(
                torch, counters, lambda: train.main(args, backend=backend))
            want = [want_flash if path == "kernel" else 0] * 3
            losses = np.asarray(out["losses"])
            print(f"{label} {path} path: losses "
                  f"{[round(float(x), 4) for x in losses]}, flash launches "
                  f"{launches} (want {want}), {secs[path]:.2f} s",
                  flush=True)
            if launches != want or not np.isfinite(losses).all():
                fail(f"{label}: the {path} path launched {launches} (not "
                     f"{want}) or logged a non-finite loss")
            outs[path] = out
    finally:
        os.environ.pop("REPRO_USE_KERNEL", None)
    return outs, secs


def phase17_kernels(torch, fa, masked, ref, bw, bf16_peak, fp32_peak, n):
    """The flash kernels at the training path's shapes (``TRAIN_FLASH``,
    forward and backward) against the plain version and its autograd
    within ``FLASH_TOL``, timed (SDPA forward and backward the library);
    the aggregation at both parameter groups' shapes, ``[1, m, n]`` bf16
    and ``[1, m, 12]`` fp32 (OP_MEAN, two of m active), against its plain
    version, timed beside ``torch.bmm``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    flash = {}
    for bh, t, d, dtype in TRAIN_FLASH:
        err = check_flash_shape(torch, fa, ref, gen,
                                (bh // 16, 16, t, d, 0, 0.0, dtype, True),
                                "phase17d")
        peak = bf16_peak if dtype == "bfloat16" else fp32_peak
        r = flash_timing(torch, fa, ref, gen, bh, t, d, dtype, bw, peak,
                         "phase17d")
        for kk, e in (("fwd", err["o"]), ("dq", err["dq"]),
                      ("dkdv", max(err["dk"], err["dv"]))):
            r[kk]["max_abs_err"] = e
        flash[f"{dtype} [{bh}, {t}, {d}]"] = r
        torch.cuda.empty_cache()
    m = SEAMLESS_TRAIN["clients"]
    agg = {}
    for width, dtype, tol in ((n, torch.bfloat16, BF16_TOL),
                              (12, torch.float32, FP32_TOL)):
        x = torch.randn(1, m, width, generator=gen, device=dev).to(dtype)
        mask = torch.zeros(1, m, dtype=torch.bool, device=dev)
        mask[0, :2] = True
        op = torch.zeros(1, dtype=torch.int32, device=dev)
        prev = torch.randn(1, width, generator=gen, device=dev)
        p = torch.rand(1, m, generator=gen, device=dev)
        args = (x, mask, op, prev, p)
        got = masked.fused_masked_agg(*args)
        want = ref.fused_masked_agg_ref(*args)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=tol, atol=tol) and \
            torch.isfinite(got).all().item()
        del got, want
        torch.cuda.empty_cache()
        key = f"{str(dtype).replace('torch.', '')} {[1, m, width]}"
        r = time_agg(torch, masked, ref, args, bw, fp32_peak, iters=10)
        r["max_abs_err"] = err
        agg[key] = r
        print(f"phase17d aggregation {key}: max_abs_err {err:.3e} tol "
              f"{tol:g} {'ok' if ok else 'MISMATCH'}; kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, torch.bmm "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bytes']} bytes)", flush=True)
        if not ok:
            fail(f"the aggregation disagrees with its plain version at {key}")
        del x, mask, op, prev, p, args
        torch.cuda.empty_cache()
    return {"flash": flash, "agg": agg}


def phase17_seamless(torch, fa, masked, train, card):
    """seamless-m4t-medium at full width and depth through the training
    launcher: ``SEAMLESS_TRAIN`` timed rounds and one profiled, the fused
    aggregation on; flash launches by dtype and shape, aggregation launches
    by group, the cross gates fp32 and moved, tokens/s, peak memory."""
    from unittest import mock

    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models import model

    t = SEAMLESS_TRAIN
    arch = "seamless-m4t-medium"
    cfg = get_config(arch)
    layout = model.param_layout(cfg)
    sizes = layout.sizes(torch.bfloat16)
    if sizes != (SEAMLESS_BF16_N, cfg.num_layers):
        fail(f"{arch}'s parameter groups are {sizes}, not "
             f"({SEAMLESS_BF16_N}, {cfg.num_layers})")
    rounds = t["rounds"] + 1
    prof = {}
    real_make = core.make_run_rounds

    def make(*a, **kw):
        run, calls = real_make(*a, **kw), [0]

        def run_rounds(st, ds, draws, k):
            calls[0] += 1
            if calls[0] <= t["rounds"]:
                return run(st, ds, draws, k)
            box = []
            prof.update(profile_window(
                torch, f"phase17a {arch} train, one round",
                lambda: box.append(run(st, ds, draws, k)), k, "round"))
            return box[0]

        return run_rounds

    counters = [getattr(fa, n) for n in FLASH_NAMES] + [
        masked.fused_masked_agg]
    args = _train_args(arch, dict(t, rounds=rounds), "--full")
    os.environ["REPRO_USE_KERNEL"] = "1"
    try:
        with mock.patch.object(core, "make_run_rounds", make), \
                _ByShape(fa, FLASH_NAMES) as flash, \
                _ByShape(masked, ("fused_masked_agg",)) as agg:
            out, sec, launches, peak = _counted(
                torch, counters, lambda: train.main(args))
    finally:
        os.environ.pop("REPRO_USE_KERNEL", None)
    losses = np.asarray(out["losses"])
    stamps = out["round_seconds"]
    loop_s = stamps[t["rounds"] - 1]
    tokens = t["rounds"] * t["clients"] * t["steps"] * t["batch"] * t["seq"]
    steady = (t["rounds"] - 1) / (loop_s - stamps[0])
    g = t["clients"] * t["batch"] * cfg.attention.num_heads
    per = rounds * t["steps"] * cfg.num_layers
    want_flash = {n: {f"bfloat16 [{g}, {t['seq']}, {cfg.head_dim}]": per,
                      f"float32 [{g}, {cfg.num_audio_frames}, "
                      f"{cfg.head_dim}]": per} for n in FLASH_NAMES}
    want_agg = {f"bfloat16 [1, {t['clients']}, {sizes[0]}]": rounds,
                f"float32 [1, {t['clients']}, {sizes[1]}]": rounds}
    n_fp32 = _fp32_moved(torch, layout, out, f"phase17a {arch}")
    server_moved = not all(torch.equal(a, b) for a, b in
                           zip(out["state"].server, out["initial"]))
    print(f"phase17a train {arch} --full (12 + 12 layers, d_model 1024, "
          f"vocab 256,206, bf16; groups {list(sizes)}: the fp32 one the "
          f"cross gates, {n_fp32} leaf) m={t['clients']} s={t['steps']} "
          f"b={t['batch']} "
          f"T={t['seq']} on {card}: {t['rounds']} rounds in {loop_s:.3f} s "
          f"= {tokens / loop_s:.1f} tokens/s, {t['rounds'] / loop_s:.4f} "
          f"rounds/s (after the first round {steady:.4f} rounds/s, "
          f"{steady * tokens / t['rounds']:.1f} tokens/s; first round "
          f"{stamps[0]:.3f} s); call {sec:.2f} s with the init and the "
          f"profiled round; peak memory {peak / 2 ** 30:.3f} GiB; losses "
          f"{[round(float(x), 4) for x in losses]}; server moved "
          f"{server_moved}", flush=True)
    print(f"phase17a launches: flash fwd/dq/dkdv {launches[:3]} (want "
          f"{2 * per} each) by shape {json.dumps(flash)}; fused_masked_agg "
          f"{launches[3]} (want {2 * rounds}) by shape {json.dumps(agg)}",
          flush=True)
    if len(losses) != rounds or not np.isfinite(losses).all():
        fail(f"{arch}: a training loss is not finite")
    if flash != want_flash or launches[:3] != [2 * per] * 3:
        fail(f"{arch}: flash launches {flash}, not {want_flash}")
    if agg != {"fused_masked_agg": want_agg} or launches[3] != 2 * rounds:
        fail(f"{arch}: aggregation launches {agg}, not {want_agg}")
    if not all(torch.isfinite(x).all().item() for x in out["state"].server):
        fail(f"{arch}: the server params are not finite")
    res = dict(rounds=t["rounds"], loop_s=loop_s,
               tokens_per_s=tokens / loop_s,
               rounds_per_s=t["rounds"] / loop_s,
               steady_rounds_per_s=steady,
               steady_tokens_per_s=steady * tokens / t["rounds"],
               first_round_s=stamps[0], call_s=sec,
               peak_gib=peak / 2 ** 30, losses=losses.tolist(),
               flash_launches=flash, agg_launches=agg["fused_masked_agg"],
               groups=list(sizes), profile=prof, server_moved=server_moved)
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 2 + 2 layers, full width: the kernel path against the plain path
    cut = dict(t, rounds=2)
    args = _train_args(arch, cut, "--full", "--layers", "2",
                       "--encoder-layers", "2")
    outs, secs = _two_paths(torch, train, fa, args,
                            cut["rounds"] * cut["steps"] * 4,
                            "phase17b 2 + 2 layers")
    c2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2)
    updates = {k: _client_updates(v) for k, v in outs.items()}
    rel = _paths_distance(torch, model.param_layout(c2), updates,
                          ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                           "cross.wq", "cross.wk", "cross.wv", "cross.wo"))
    print(f"phase17b kernel vs plain path, full width, 2 + 2 layers, T="
          f"{cut['seq']}, {cut['rounds']} rounds: relative client-update "
          f"distance " + " ".join(f"{k} {v:.4e}" for k, v in rel.items())
          + f" (limit {PATHS_TOL:g})", flush=True)
    if not all(v <= PATHS_TOL for v in rel.values()):
        fail(f"{arch}: the kernel and plain training paths diverge")
    res["paths_2_2_layers"] = rel
    del outs, updates
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase17_zoo(torch, fa, train, card):
    """``TRAIN_ZOO_ARCHS`` at ``reduced()`` in bf16 through the training
    launcher, kernel path against plain path: finite losses, every fp32
    leaf fp32 and moved, MoE aux finite and positive on the trained
    server, the clients' updates within ``PATHS_TOL``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model

    t = TRAIN_ZOO
    res = {}
    for arch in TRAIN_ZOO_ARCHS:
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  dtype="bfloat16")
        layout = model.param_layout(cfg)
        per_fwd, _ = _flash_launches(model, cfg)
        args = _train_args(arch, t, "--dtype", "bfloat16")
        outs, secs = _two_paths(torch, train, fa, args,
                                t["rounds"] * t["steps"] * per_fwd,
                                f"phase17c {arch}")
        n_fp32 = _fp32_moved(torch, layout, outs["kernel"],
                             f"phase17c {arch}")
        aux = None
        if cfg.moe:
            server = layout.views(outs["kernel"]["state"].server)
            toks = torch.randint(0, cfg.vocab_size, (1, t["batch"], t["seq"]),
                                 generator=torch.Generator().manual_seed(17)
                                 ).cuda()
            with torch.no_grad():
                _, a = model.forward(server, cfg, toks)
            aux = a.item()
            if not (math.isfinite(aux) and aux > 0):
                fail(f"{arch}: the trained model's aux {aux} is not finite "
                     f"and positive")
        updates = {k: _client_updates(v) for k, v in outs.items()}
        rel = _paths_distance(torch, layout, updates, ())
        print(f"phase17c {arch} reduced bf16 ({cfg.num_layers} layers, "
              f"d_model {cfg.d_model}, groups "
              f"{list(layout.sizes(torch.bfloat16))}, {n_fp32} fp32 "
              f"leaves, all moved) m={t['clients']} s={t['steps']} "
              f"b={t['batch']} T={t['seq']} {t['rounds']} rounds on {card}: "
              f"aux {aux}; kernel vs plain relative client-update distance "
              + " ".join(f"{k} {v:.4e}" for k, v in rel.items())
              + f" (limit {PATHS_TOL:g} on all)", flush=True)
        if not rel["all"] <= PATHS_TOL:
            fail(f"{arch}: the kernel and plain training paths diverge")
        res[arch] = dict(paths=rel, aux=aux, seconds=secs,
                         flash_launches=t["rounds"] * t["steps"] * per_fwd,
                         losses={k: v["losses"] for k, v in outs.items()})
        del outs, updates
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase17_train_zoo(torch, fa, masked, ref, train, card, bw, bf16_peak,
                      fp32_peak):
    """Training of the MoE, hybrid, vlm and audio families: the kernels at
    the path's shapes, seamless-m4t-medium at full width and depth, the
    other four at reduced width in bf16; held to ``PHASE17_LIMIT_S``."""
    t_phase = time.perf_counter()
    res = {"kernels": phase17_kernels(torch, fa, masked, ref, bw, bf16_peak,
                                      fp32_peak, SEAMLESS_BF16_N)}
    res["seamless-m4t-medium"] = phase17_seamless(torch, fa, masked, train,
                                                  card)
    res["reduced_bf16"] = phase17_zoo(torch, fa, train, card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase17 done in {res['seconds']:.1f} s (limit "
          f"{PHASE17_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE17_LIMIT_S:
        fail(f"phase 17 took {res['seconds']:.1f} s, over its "
             f"{PHASE17_LIMIT_S:g} s")
    return res


def _timed_checkpoints(torch, log):
    """Wrap ``repro_torch.checkpointing``'s ``save`` and ``restore`` (the
    launcher imports them from there at each call) to append ``(what,
    seconds, bytes)`` to ``log``; returns a function that undoes it."""
    import repro_torch.checkpointing as ck

    save, restore = ck.save, ck.restore

    def timed_save(path, step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fname = save(path, step, tree)
        log.append(("save", time.perf_counter() - t0,
                    os.path.getsize(fname)))
        return fname

    def timed_restore(path, step, template):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(path, step, template)
        torch.cuda.synchronize()
        log.append(("restore", time.perf_counter() - t0, os.path.getsize(
            os.path.join(path, f"ckpt_{step:08d}.npz"))))
        return out

    ck.save, ck.restore = timed_save, timed_restore

    def undo():
        ck.save, ck.restore = save, restore
    return undo


def _state_distance(torch, a, b):
    """The largest |a - b| over the server, clients and optimizer state
    (every group), and whether all of them are equal bit for bit."""
    from repro_torch.core.params import Groups

    def parts(out):
        st = out["state"]
        xs = [st.server, st.clients] + [st.opt_state[k]
                                        for k in sorted(st.opt_state)]
        return [y for x in xs for y in (x if isinstance(x, Groups) else
                                        (x,))]

    pa, pb = parts(a), parts(b)
    equal = all(torch.equal(x, y) for x, y in zip(pa, pb))
    dist = max((x.float() - y.float()).abs().max().item()
               for x, y in zip(pa, pb))
    return dist, equal and a["losses"][-len(b["losses"]):] == b["losses"]


def _nondeterministic_ops(torch, run):
    """The ops that torch reports as nondeterministic while ``run()`` runs
    (its alerts under ``use_deterministic_algorithms(True,
    warn_only=True)``), each named once."""
    import warnings

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.use_deterministic_algorithms(was)
    return sorted({str(w.message).split(" does not have")[0][:120]
                   for w in caught if "determinis" in str(w.message)})


def _resume(torch, fa, masked, train, args, label, want_flash, t):
    """A: ``t["rounds"]`` rounds; B: half of them saved to a checkpoint
    directory; C: all of them from B's directory. Returns C against A:
    bitwise, or within the distance of a second uninterrupted run (then
    the card is nondeterministic somewhere); checkpoint bytes and the
    seconds of each save and restore; C's launches."""
    import tempfile

    counters = [getattr(fa, n) for n in FLASH_NAMES] + [
        masked.fused_masked_agg]
    rounds, half = t["rounds"], t["rounds"] // 2
    log = []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    os.environ["REPRO_USE_KERNEL"] = "1"
    undo = _timed_checkpoints(torch, log)
    try:
        a, a_s, _, _ = _counted(torch, counters, lambda: train.main(
            args + ["--rounds", str(rounds)]))
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as d:
            ck = ["--ckpt-dir", d, "--ckpt-every", str(half)]
            _, b_s, _, _ = _counted(torch, counters, lambda: train.main(
                args + ["--rounds", str(half)] + ck))
            c, c_s, launches, peak = _counted(
                torch, counters, lambda: train.main(
                    args + ["--rounds", str(rounds)] + ck))
        dist, bitwise = _state_distance(torch, a, c)
        a2_dist, ops = None, None
        if not bitwise:
            a2 = train.main(args + ["--rounds", str(rounds)])
            a2_dist, same = _state_distance(torch, a, a2)
            if same:
                fail(f"{label}: the resumed run differs from the "
                     f"uninterrupted one (max |d| {dist:.3e}) while two "
                     "uninterrupted runs agree bit for bit: a checkpoint "
                     "fault")
            ops = _nondeterministic_ops(torch, lambda: train.main(
                args + ["--rounds", str(rounds)]))
            if dist > a2_dist:
                fail(f"{label}: resumed vs uninterrupted {dist:.3e}, over "
                     f"the {a2_dist:.3e} between two uninterrupted runs")
    finally:
        undo()
        os.environ.pop("REPRO_USE_KERNEL", None)
    want = [want_flash] * 3 + [half * (2 if isinstance(
        c["state"].server, tuple) else 1)]
    saves = [x for x in log if x[0] == "save"]
    restores = [x for x in log if x[0] == "restore"]
    print(f"{label}: A {rounds} rounds {a_s:.2f} s, B {half} rounds + save "
          f"{b_s:.2f} s, C restore + {rounds - half} rounds + save "
          f"{c_s:.2f} s; C vs A " + ("bit for bit" if bitwise else
          f"max |d| {dist:.3e} within two uninterrupted runs' {a2_dist:.3e}"
          f" (nondeterministic card path; torch names {ops or 'no op'}, "
          "and the hand-written kernels are not on its list: log the op "
          "in ROADMAP Queue 3)") + f"; checkpoint "
          f"{saves[0][2]:,} bytes, saves "
          f"{[round(x[1], 3) for x in saves]} s, restore "
          f"{[round(x[1], 3) for x in restores]} s; C launches flash "
          f"fwd/dq/dkdv {launches[:3]}, aggregation {launches[3]} (want "
          f"{want}); C's peak {peak / 2 ** 30:.2f} GiB; losses A "
          f"{[round(x, 4) for x in a['losses']]} C "
          f"{[round(x, 4) for x in c['losses']]}", flush=True)
    if launches != want or len(restores) != 1:
        fail(f"{label}: C launched {launches}, expected {want}, restored "
             f"{len(restores)} times")
    return c, dict(bitwise=bitwise, max_abs_diff=dist,
                   uninterrupted_diff=a2_dist, nondeterministic_ops=ops,
                   ckpt_bytes=saves[0][2],
                   save_s=[x[1] for x in saves],
                   restore_s=[x[1] for x in restores],
                   seconds={"A": a_s, "B": b_s, "C": c_s},
                   launches=launches, peak_gib=peak / 2 ** 30)


def phase18_ops(torch, masked, fa, ref):
    """The ops wrappers on the card against their plain versions:
    ``masked_agg_pytree`` over a SmolLM-shaped dict of fp32 leaves of
    ``LM_CLIENTS`` clients (3 active with ``prev``: the reference's
    ``:109``; without: ``:96``; none active with ``prev``: ``prev``
    exactly), one launch a leaf; ``gqa_flash_attention`` at
    ``GQA_SHAPE`` in bf16 within ``FLASH_TOL``, one forward launch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import param_layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    m = LM_CLIENTS
    leaves = param_layout(get_config("smollm-135m")).leaves
    tree = {n: torch.randn((m,) + tuple(s), generator=gen, device=dev)
            for n, s in leaves}
    prev = {n: torch.randn(tuple(s), generator=gen, device=dev)
            for n, s in leaves}
    three = torch.arange(m, device=dev) < 3
    none = torch.zeros(m, dtype=torch.bool, device=dev)
    launches, err = {}, {}
    for case, mask, pv in ((":109 (prev), 3 active", three, prev),
                           (":96 (no prev), 3 active", three, None),
                           (":109 (prev), none active", none, prev)):
        masked.fused_masked_agg.launches = 0
        got = ops.masked_agg_pytree(tree, mask, pv)
        torch.cuda.synchronize()
        launches[case] = masked.fused_masked_agg.launches
        e = 0.0
        for n in tree:
            want = ref.masked_agg_ref(tree[n].reshape(m, -1), mask,
                                      None if pv is None else
                                      pv[n].reshape(-1)).reshape(
                                          got[n].shape)
            e = max(e, (got[n] - want).abs().max().item())
            ok = (torch.equal(got[n], pv[n]) if mask is none else
                  torch.allclose(got[n], want, rtol=FP32_TOL, atol=FP32_TOL))
            if not ok:
                fail(f"masked_agg_pytree {case}: leaf {n} disagrees with "
                     f"the plain version")
        err[case] = e
        if launches[case] != len(leaves):
            fail(f"masked_agg_pytree {case} launched {launches[case]} "
                 f"times for {len(leaves)} leaves")
    del tree, prev
    b, t, h, d, kv = GQA_SHAPE
    q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, t, kv, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    fa.flash_attention_fwd.launches = 0
    got = ops.gqa_flash_attention(q, k, v)
    torch.cuda.synchronize()
    gqa_launches = fa.flash_attention_fwd.launches
    rep = h // kv
    want = ref.flash_attention_ref(
        q.float().transpose(1, 2),
        k.float().transpose(1, 2).repeat_interleave(rep, 1),
        v.float().transpose(1, 2).repeat_interleave(rep, 1)).transpose(1, 2)
    atol, rtol = FLASH_TOL["bfloat16"]
    gqa_err = (got.float() - want).abs().max().item()
    print(f"phase18c masked_agg_pytree over {len(leaves)} SmolLM leaves of "
          f"{m} clients (fp32): max |err| " + ", ".join(
              f"{c} {x:.3e}" for c, x in err.items())
          + f" (tol {FP32_TOL:g}; none active: prev exactly); launches "
          f"{launches}; gqa_flash_attention {list(GQA_SHAPE)} bf16: max "
          f"|err| {gqa_err:.3e} (atol {atol:g} rtol {rtol:g}), flash fwd "
          f"launches {gqa_launches}", flush=True)
    if gqa_launches != 1 or not torch.allclose(got.float(), want,
                                               rtol=rtol, atol=atol):
        fail("gqa_flash_attention disagrees with its plain version or "
             f"launched {gqa_launches} forward kernels")
    return dict(masked_agg_pytree_launches=launches,
                masked_agg_pytree_max_abs_err=err, gqa_launches=gqa_launches,
                gqa_max_abs_err=gqa_err)


def _dense_flops(cfg, b, t):
    """``(weights, attention)``: the matmul FLOPs of one dense forward on
    ``[b, T]`` outside attention (every stacked weight once per token, the
    tied head), and ``b * H * pairs * D * L`` for the causal mask's ``T (T +
    1) / 2`` pairs, of which the flash forward takes 4 and its backward 14
    (``dq`` 6, ``dkdv`` 8)."""
    from repro_torch.models.model import param_layout

    weights = sum(math.prod(s) for _, s in param_layout(cfg).leaves
                  if len(s) == 3)
    attn = (b * cfg.attention.num_heads * (t * (t + 1) // 2)
            * cfg.head_dim * cfg.num_layers)
    return 2 * b * t * (weights + cfg.d_model * cfg.vocab_size), attn


def phase18_launch(torch, fa, masked, ref, train, card, lm, bf16_peak):
    """Launch and checkpointing (the module docstring's phase 18)."""
    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.models import model

    t_phase = time.perf_counter()
    res = {}
    t = CKPT_LM
    args = ["--full", "--arch", "smollm-135m", "--clients",
            str(t["clients"]), "--local-steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--log-every", "1"]
    half = t["rounds"] // 2
    _, res["smollm"] = _resume(torch, fa, masked, train, args,
                               "phase18a smollm-135m full (30 layers, bf16)",
                               half * t["steps"] * LM_LAYERS, t)
    t = CKPT_GROUPS
    arch = "jamba-1.5-large-398b"
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    per_fwd, _ = _flash_launches(model, cfg)
    args = ["--arch", arch, "--clients", str(t["clients"]),
            "--local-steps", str(t["steps"]), "--batch", str(t["batch"]),
            "--seq", str(t["seq"]), "--log-every", "1", "--dtype",
            "bfloat16"]
    c, res["jamba_groups"] = _resume(
        torch, fa, masked, train, args,
        f"phase18b {arch} reduced bf16 (two groups)",
        t["rounds"] // 2 * t["steps"] * per_fwd, t)
    n_fp32 = _fp32_moved(torch, model.param_layout(cfg), c, "phase18b")
    res["jamba_groups"]["fp32_leaves"] = n_fp32
    res["ops"] = phase18_ops(torch, masked, fa, ref)
    # (d) the share of the bf16 peak that phase 5's steady round reaches
    shape = ShapeConfig("phase5", LM_SEQ,
                        LM_CLIENTS * LM_STEPS * lm["batch"], "train")
    smollm = get_config("smollm-135m")
    per_round = model_flops_for(smollm, shape, mode="train")
    mfu = lm["steady_rounds_per_s"] * per_round / bf16_peak
    print(f"phase18d model FLOPs utilisation of phase 5's steady rounds: "
          f"{lm['steady_rounds_per_s']:.4f} rounds/s x {per_round:.4e} "
          f"model FLOPs a round (6 N m s b T) / {bf16_peak:.4g} bf16 "
          f"FLOP/s = {mfu:.4f} on {card}", flush=True)
    res["mfu"] = dict(value=mfu, model_flops_per_round=per_round,
                      steady_rounds_per_s=lm["steady_rounds_per_s"])
    # (e) the dry run on meta
    row = dryrun.lower_pair("smollm-135m", "train_4k", verbose=False)
    print("phase18e dry run " + json.dumps(
        {k: v for k, v in row.items() if k != "trace"}), flush=True)
    if row["status"] != "ok":
        fail(f"the dry run of smollm-135m x train_4k failed: {row}")
    t0 = time.perf_counter()
    counted = dryrun.count_step(
        smollm, ShapeConfig("phase5", LM_SEQ, LM_CLIENTS * lm["batch"],
                            "train"),
        num_clients=LM_CLIENTS, local_steps=LM_STEPS)["flops"]
    dense, attn = _dense_flops(smollm, lm["batch"], LM_SEQ)
    head = 2 * lm["batch"] * LM_SEQ * smollm.d_model * smollm.vocab_size
    analytic = LM_CLIENTS * LM_STEPS * (3 * dense + head + 18 * attn)
    rel = abs(counted - analytic) / analytic
    print(f"phase18e phase 5's round on meta (m={LM_CLIENTS}, s={LM_STEPS}, "
          f"b={lm['batch']}, T={LM_SEQ}): counted {counted:.6e} FLOPs, "
          f"analytic {analytic:.6e} (relative {rel:.3e}, limit "
          f"{DRYRUN_TOL:g}); its model FLOPs {per_round:.6e} are "
          f"{per_round / counted:.4f} of it; {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    if rel > DRYRUN_TOL:
        fail("the dry run's counted FLOPs miss the analytic count")
    res["dryrun"] = dict(row={k: v for k, v in row.items() if k != "trace"},
                         phase5_counted=counted, phase5_analytic=analytic)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase18 done in {res['seconds']:.1f} s (limit "
          f"{PHASE18_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE18_LIMIT_S:
        fail(f"phase 18 took {res['seconds']:.1f} s, over its "
             f"{PHASE18_LIMIT_S:g} s")
    return res


def _wkv_bwd_inputs(torch, gen, b, h, t, d, decay):
    """WKV6 inputs as phase 7's, and the output gradients: do ~ N(0, 1),
    dS_T ~ 0.1 N."""
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    r, k, v = (0.5 * rand(b, h, t, d) for _ in range(3))
    if decay == "ref":
        w = torch.exp(-torch.exp(-3.0 + 0.5 * rand(b, h, t, d)))
    else:
        w = 1e-3 + (0.1 - 1e-3) * torch.rand(b, h, t, d, generator=gen,
                                               device=dev)
    ins = [r, k, v, w, 0.3 * rand(h, d), 0.1 * rand(b, h, d, d)]
    return ins, rand(b, h, t, d), 0.1 * rand(b, h, d, d)


def _wkv_bwd_check(torch, rk, ref, ins, do, ds_t, label):
    """The backward through ``rwkv6_chunk_autograd`` (one chunked forward,
    one backward) against the plain version's autograd (and the step
    scan's at T <= 128): each gradient's largest error, its largest error
    over its largest magnitude and the atol it needs at rtol WKV_BWD_TOL as
    it is; fails past WKV_BWD_TOL (module constants) or on a non-finite
    gradient. Returns the largest error over all gradients."""
    leaves = [x.clone().requires_grad_(True) for x in ins]
    before = dict(rk.rwkv6_chunk.launches_by_route)
    o, s_t = rk.rwkv6_chunk_autograd(*leaves)
    got = torch.autograd.grad([o, s_t], leaves, [do, ds_t])
    torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in
              rk.rwkv6_chunk.launches_by_route.items()}
    if counts != {"chunked": 1, "step": 0, "backward": 1}:
        fail(f"{label}: the autograd WKV6 call counted {counts}")
    wants = {"plain": ref.rwkv6_chunk_grads(*ins, do, ds_t)}
    if ins[0].shape[2] <= 128:
        wants["step scan"] = ref.rwkv6_chunk_grads(
            *ins, do, ds_t, fn=ref.rwkv6_chunk_ref)
    worst, parts, ok = 0.0, [], True
    for which, want in wants.items():
        for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                              want):
            finite = bool(torch.isfinite(g).all())
            err = (g - x).abs().max().item()
            scale = x.abs().max().item()
            need = ((g - x).abs() - WKV_BWD_TOL * x.abs()).max().item()
            good = finite and torch.allclose(
                g / scale, x / scale, rtol=WKV_BWD_TOL, atol=WKV_BWD_TOL)
            ok = ok and good
            worst = max(worst, err)
            parts.append(f"{name} {err:.3e} ({err / scale:.2e} of "
                         f"{scale:.3g}; atol needed as is {need:.2e})"
                         + ("" if finite else " NOT FINITE"))
        dlogw = (got[3] - want[3]) * ins[3]
        need = (dlogw.abs() - WKV_BWD_TOL * (want[3] * ins[3]).abs()).max()
        ok = ok and bool(need.item() <= WKV_BWD_TOL)
        parts.append(f"dlog w: atol needed as is {need.item():.2e}")
        print(f"{label} vs {which} autograd: " + "; ".join(parts)
              + f"; tol {WKV_BWD_TOL:g} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        parts = []
    if not ok:
        fail(f"{label}: the WKV6 backward disagrees with its plain version")
    return worst


def phase19_wkv_bwd(torch, rk, ref, bw, fp32_peak, build_log):
    """(a) the WKV6 backward kernels: ptxas, checks at ``WKV_BWD_SHAPES``
    and ``WKV_BWD_FOLDED``, the time at the prefill shape against the
    plain version's autograd and the bound."""
    print_ptxas("phase19a", build_log)
    ptxas = wkv_ptxas(build_log, rk.BWD_KERNELS)
    for name in rk.BWD_KERNELS:
        by_d = ptxas.get(name, {})
        print(f"phase19a ptxas {name} by head dim: " + "; ".join(
            f"D={dd}: {vv.get('registers')} registers, spill stores "
            f"{vv.get('spill_stores')} B, loads {vv.get('spill_loads')} B, "
            f"shared {vv.get('smem')} B static + "
            f"{rk.shared_bytes(name, dd)} B dynamic"
            for dd, vv in sorted(by_d.items())), flush=True)
        if sorted(by_d) != list(rk.HEAD_DIMS) or any(
                vv.get("spill_stores") or vv.get("spill_loads")
                for vv in by_d.values()):
            fail(f"ptxas reports spills in {name}, or misses a head dim")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    worst = 0.0
    for shape in WKV_BWD_SHAPES:
        ins, do, ds_t = _wkv_bwd_inputs(torch, gen, *shape)
        worst = max(worst, _wkv_bwd_check(torch, rk, ref, ins, do, ds_t,
                                          f"phase19a wkv6 backward "
                                          f"{list(shape)}"))
        del ins, do, ds_t
        torch.cuda.empty_cache()
    # two models of 40 heads folded into the head axis, another u each
    b, g, h, t, d = WKV_BWD_FOLDED
    parts = [_wkv_bwd_inputs(torch, gen, b, h, t, d, "ref")
             for _ in range(g)]
    ins = [torch.cat([p[0][i] for p in parts], 0 if i == 4 else 1)
           for i in range(6)]
    do = torch.cat([p[1] for p in parts], 1)
    ds_t = torch.cat([p[2] for p in parts], 1)
    worst = max(worst, _wkv_bwd_check(
        torch, rk, ref, ins, do, ds_t, f"phase19a wkv6 backward folded "
        f"[{b}, {g}x{h}, {t}, {d}] (u per model)"))
    for i, (ins_g, do_g, ds_g) in enumerate(parts):   # each model alone
        _wkv_bwd_check(torch, rk, ref, ins_g, do_g, ds_g,
                       f"phase19a wkv6 backward model {i} alone")
    del parts, ins, do, ds_t
    torch.cuda.empty_cache()

    shape = WKV_BWD_SHAPES[0]
    ins, do, ds_t = _wkv_bwd_inputs(torch, gen, *shape)
    _, _, ws = rk._forward(*ins, "chunked")
    ms = time_ms(lambda: rk.rwkv6_chunk_backward(*ins[:5], ws, do, ds_t),
                 iters=10)
    fwd_ms = time_ms(lambda: rk.rwkv6_chunk(*ins, route="chunked"), iters=10)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    o, s_t = ref.rwkv6_chunk_plain(*leaves)
    plain_ms = time_ms_events(lambda: torch.autograd.grad(
        [o, s_t], leaves, [do, ds_t], retain_graph=True), iters=2)
    del o, s_t, leaves, ws
    nbytes, flops = wkv_work(*shape[:4], direction="bwd")
    bound_ms = max(nbytes / bw, flops / fp32_peak) * 1e3
    by = "operations" if flops / fp32_peak > nbytes / bw else "bytes"
    tf32 = tf32_peak(torch)
    bound_tc = max(nbytes / bw, 3 * flops / tf32) * 1e3
    print(f"phase19a timing wkv6 backward {list(shape[:4])} fp32 (two "
          f"launches: wkv6_bwd_state, wkv6_bwd_chunk; CUDA-graph replays): "
          f"kernel {ms:.5f} ms (the chunked forward {fwd_ms:.5f} ms), plain "
          f"autograd backward {plain_ms:.5f} ms (CUDA events), library none "
          f"(no single PyTorch call computes WKV6's backward), bound "
          f"{bound_ms:.5f} ms by {by} ({nbytes} bytes at {bw / 1e12:g} "
          f"TB/s; {flops:.4e} flop at {fp32_peak / 1e12:g} TFLOP/s fp32), "
          f"tensor-core bound {bound_tc:.5f} ms (3 x the flop at "
          f"{tf32 / 1e12:g} TFLOP/s tf32)", flush=True)
    del ins, do, ds_t
    torch.cuda.empty_cache()
    return dict(ms=ms, forward_ms=fwd_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, bound_tc_ms=bound_tc,
                bytes=nbytes, flops=flops,
                max_abs_err=worst, shape=list(shape[:4]), ptxas=ptxas)


def _rwkv_updates(torch, layout, outs):
    """``||u_kernel - u_plain|| / ||u_plain||`` of the clients' updates
    over all parameters, over the fp32 leaves and over the time mix's
    projections (``wr``, ``wk``, ``wv``, ``wo``), for one buffer or two
    groups."""
    from repro_torch.core.params import gmap

    ups = {k: gmap(lambda c, i: c.float() - i.float()[:, None],
                   v["state"].clients, v["initial"]) for k, v in outs.items()}
    views = {k: layout.views(v) for k, v in ups.items()}

    def rel(names):
        a = torch.cat([views["kernel"][n].reshape(-1) for n in names])
        b = torch.cat([views["plain"][n].reshape(-1) for n in names])
        return ((a - b).norm() / b.norm()).item()

    names = [n for n, _ in layout.leaves]
    out = {"all": rel(names),
           "fp32 leaves": rel([n for n in names if n in layout.fp32])}
    for suffix in ("wr", "wk", "wv", "wo"):
        out[f"tmix.{suffix}"] = rel([n for n in names
                                     if n.endswith(f"tmix.{suffix}")])
    return out


def phase19_reduced(torch, rk, masked, train, card):
    """(b) reduced() rwkv6 through the kernels against the plain path, in
    fp32 (one buffer) and bf16 (two groups)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model

    t = RWKV_TRAIN_REDUCED
    res = {}
    for dtype, tol in (("float32", RWKV_TRAIN_FP32_TOL),
                       ("bfloat16", PATHS_TOL)):
        cfg = dataclasses.replace(reduced(get_config("rwkv6-3b")),
                                  dtype=dtype)
        layout = model.param_layout(cfg)
        per = t["rounds"] * t["steps"] * cfg.num_layers
        groups = 1 if dtype == "float32" else 2
        args = _train_args("rwkv6-3b", t, "--dtype", dtype)
        outs = {}
        try:
            for path, backend, agg in (("kernel", None, "1"),
                                       ("plain", "torch", "0")):
                os.environ["REPRO_USE_KERNEL"] = agg
                reset_wkv_counts(rk)
                masked.fused_masked_agg.launches = 0
                outs[path] = train.main(args, backend=backend)
                counts = dict(rk.rwkv6_chunk.launches_by_route)
                n_agg = masked.fused_masked_agg.launches
                want = {"chunked": per if path == "kernel" else 0,
                        "step": 0,
                        "backward": per if path == "kernel" else 0}
                want_agg = groups * t["rounds"] if path == "kernel" else 0
                losses = np.asarray(outs[path]["losses"])
                print(f"phase19b {dtype} {path} path: losses "
                      f"{[round(float(x), 4) for x in losses]}, wkv6 "
                      f"launches {counts} (want {want}), aggregation "
                      f"{n_agg} (want {want_agg})", flush=True)
                if counts != want or n_agg != want_agg \
                        or not np.isfinite(losses).all():
                    fail(f"phase19b {dtype} {path} path: launches {counts}"
                         f", {n_agg} or a non-finite loss")
        finally:
            os.environ.pop("REPRO_USE_KERNEL", None)
        rel = _rwkv_updates(torch, layout, outs)
        n_fp32 = _fp32_moved(torch, layout, outs["kernel"],
                             f"phase19b {dtype}") if groups == 2 else 0
        print(f"phase19b reduced rwkv6 {dtype} ({cfg.num_layers} layers, "
              f"d_model {cfg.d_model}, {groups} group(s)) m={t['clients']} "
              f"s={t['steps']} b={t['batch']} T={t['seq']} {t['rounds']} "
              f"rounds on {card}: kernel vs plain relative client-update "
              f"distance " + " ".join(f"{k} {v:.4e}" for k, v in rel.items())
              + f" (limit {tol:g} on each)", flush=True)
        if not all(v <= tol for v in rel.values()):
            fail(f"phase19b {dtype}: the kernel and plain training paths "
                 "diverge")
        res[dtype] = dict(paths=rel, fp32_leaves_moved=n_fp32,
                          losses={k: v["losses"] for k, v in outs.items()},
                          wkv6_launches_per_direction=per)
        del outs
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase19_full(torch, rk, masked, train, card):
    """(c) rwkv6-3b at full width and depth through the training launcher:
    ``RWKV_TRAIN`` timed rounds and one profiled, the fused aggregation on,
    the clients halved while the run does not fit the card."""
    from unittest import mock

    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = get_config("rwkv6-3b")
    layout = model.param_layout(cfg)
    sizes = layout.sizes(torch.bfloat16)
    if layout.size != RWKV_PARAMS or sizes[1] != RWKV_FP32_PARAMS:
        fail(f"rwkv6-3b has {layout.size} parameters in groups {sizes}, "
             f"not {RWKV_PARAMS} with {RWKV_FP32_PARAMS} fp32")
    t = dict(RWKV_TRAIN)
    rounds = t["rounds"] + 1
    tried = []
    while True:
        prof = {}
        real_make = core.make_run_rounds

        def make(*a, **kw):
            run, calls = real_make(*a, **kw), [0]

            def run_rounds(st, ds, draws, k):
                calls[0] += 1
                if calls[0] <= t["rounds"]:
                    return run(st, ds, draws, k)
                box = []
                prof.update(profile_window(
                    torch, "phase19c rwkv6-3b train, one round",
                    lambda: box.append(run(st, ds, draws, k)), k, "round",
                    top=8))
                return box[0]

            return run_rounds

        args = _train_args("rwkv6-3b", dict(t, rounds=rounds), "--full")
        os.environ["REPRO_USE_KERNEL"] = "1"
        try:
            with mock.patch.object(core, "make_run_rounds", make):
                reset_wkv_counts(rk)
                out, sec, launches, peak = _counted(
                    torch, [masked.fused_masked_agg], lambda: train.main(args))
            break
        except torch.OutOfMemoryError as e:
            # the next try's _counted frees this one's tensors, once the
            # traceback that holds them is gone
            tried.append(t["clients"])
            print(f"phase19c out of memory at {t['clients']} clients "
                  f"({str(e).splitlines()[0][:160]}); halving them",
                  flush=True)
            if t["clients"] == 1:
                fail("rwkv6-3b does not train on one card at one client")
            t["clients"] //= 2
        finally:
            os.environ.pop("REPRO_USE_KERNEL", None)
    counts = dict(rk.rwkv6_chunk.launches_by_route)
    losses = np.asarray(out["losses"])
    stamps = out["round_seconds"]
    loop_s = stamps[t["rounds"] - 1]
    tokens = t["rounds"] * t["clients"] * t["steps"] * t["batch"] * t["seq"]
    steady = (t["rounds"] - 1) / (loop_s - stamps[0])
    per = rounds * t["steps"] * cfg.num_layers
    want = {"chunked": per, "step": 0, "backward": per}
    n_fp32 = _fp32_moved(torch, layout, out, "phase19c rwkv6-3b")
    print(f"phase19c train rwkv6-3b --full ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, bf16; {layout.size} parameters in groups "
          f"{list(sizes)}: the fp32 one decay base, bonus and ln_x, "
          f"{n_fp32} leaves) m={t['clients']} (out of memory at {tried}) "
          f"s={t['steps']} b={t['batch']} T={t['seq']} on {card}: "
          f"{t['rounds']} rounds in {loop_s:.3f} s = "
          f"{tokens / loop_s:.1f} tokens/s, {t['rounds'] / loop_s:.4f} "
          f"rounds/s (after the first round {steady:.4f} rounds/s, "
          f"{steady * tokens / t['rounds']:.1f} tokens/s; first round "
          f"{stamps[0]:.3f} s); call {sec:.2f} s with the init and the "
          f"profiled round; peak memory {peak / 2 ** 30:.3f} GiB; losses "
          f"{[round(float(x), 4) for x in losses]}", flush=True)
    print(f"phase19c launches: wkv6 {counts} (want {want}); "
          f"fused_masked_agg {launches[0]} (want {2 * rounds})", flush=True)
    if len(losses) != rounds or not np.isfinite(losses).all():
        fail("rwkv6-3b: a training loss is not finite")
    if counts != want:
        fail(f"rwkv6-3b: wkv6 launches {counts}, not {want}")
    if launches[0] != 2 * rounds:
        fail(f"rwkv6-3b: aggregation launches {launches[0]}, not "
             f"{2 * rounds}")
    if peak > 80e9:
        fail(f"rwkv6-3b: peak memory {peak} bytes is over 80 GB")
    if not all(torch.isfinite(x).all().item() for x in out["state"].server):
        fail("rwkv6-3b: the server params are not finite")
    res = dict(clients=t["clients"], out_of_memory_at=tried,
               rounds=t["rounds"], loop_s=loop_s,
               tokens_per_s=tokens / loop_s,
               rounds_per_s=t["rounds"] / loop_s,
               steady_rounds_per_s=steady,
               steady_tokens_per_s=steady * tokens / t["rounds"],
               first_round_s=stamps[0], call_s=sec,
               peak_gib=peak / 2 ** 30, losses=losses.tolist(),
               wkv6_launches=counts, agg_launches=launches[0],
               groups=list(sizes), profile=prof)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase19_rwkv_train(torch, rk, masked, ref, train, card, bw, fp32_peak,
                       build_log):
    """RWKV6 training: the backward kernels, reduced() kernel vs plain,
    rwkv6-3b at full width and depth; held to ``PHASE19_LIMIT_S``."""
    t_phase = time.perf_counter()
    res = {"backward": phase19_wkv_bwd(torch, rk, ref, bw, fp32_peak,
                                       build_log)}
    res["reduced"] = phase19_reduced(torch, rk, masked, train, card)
    res["rwkv6-3b"] = phase19_full(torch, rk, masked, train, card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase19 done in {res['seconds']:.1f} s (limit "
          f"{PHASE19_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE19_LIMIT_S:
        fail(f"phase 19 took {res['seconds']:.1f} s, over its "
             f"{PHASE19_LIMIT_S:g} s")
    return res


def _cells_diff(a_cells, b_cells):
    """The largest |difference| of each ``CellResult`` field over two runs'
    cells, which must match in number, coordinates and shapes."""
    if len(a_cells) != len(b_cells):
        fail(f"{len(b_cells)} cells where {len(a_cells)} were expected")
    out = dict.fromkeys(CELL_FIELDS, 0.0)
    for a, b in zip(a_cells, b_cells):
        if (a.algo, a.hparams, a.strategy, a.eval_rounds) != \
                (b.algo, b.hparams, b.strategy, b.eval_rounds):
            fail(f"cells {a.algo} and {b.algo} differ in their coordinates")
        for f in CELL_FIELDS:
            x = np.asarray(getattr(a, f), np.float64)
            y = np.asarray(getattr(b, f), np.float64)
            if x.shape != y.shape:
                fail(f"{f}: shape {y.shape} where {x.shape} was expected")
            if x.size:
                out[f] = max(out[f], float(np.abs(x - y).max()))
    return out


def _ranks_line(label, res):
    print(f"{label}: backend {res.backend}; " + "; ".join(
        f"rank {r.rank} on {r.device} {r.seconds:.3f} s" for r in res.ranks),
        flush=True)
    return {"backend": res.backend,
            "ranks": [dict(rank=r.rank, device=r.device, seconds=r.seconds)
                      for r in res.ranks]}


def _batch_count_probe(torch, masked, grid, spec, server):
    """Where a run on 2 rows may differ from one on 3: the round's batched
    ops on rows 0-1 of a 3-row input against the same ops on those 2 rows
    alone (the test logits ``x @ w1`` over B models, the client loss and
    its gradient over B * m models, the aggregation over ``[B, m, n]``).
    Returns the largest |difference| of each; 0 where bitwise."""
    from repro_torch.experiments.tasks import mlp_logits

    task = grid.get_traced_task(spec)
    sh = task.shared
    gen = torch.Generator(device=server.device).manual_seed(0)
    m, s, b = spec.num_clients, spec.local_steps, spec.batch_size
    clients = server.unsqueeze(1).expand(-1, m, -1).contiguous()
    clients = clients + 1e-3 * torch.randn(clients.shape, generator=gen,
                                           device=server.device)
    pick = torch.randint(0, sh["x"].shape[0], (3, m, b),
                         generator=gen, device=server.device)
    batch = {"x": sh["x"][pick], "y": sh["y"][pick]}
    active = torch.rand((3, m), generator=gen, device=server.device) < 0.5
    ops = {
        "test logits (x @ w1 over B models)": lambda r: mlp_logits(
            task.layout.views(server[:r]), sh["xt"]),
        "client loss (x @ w1 over B * m models)": lambda r: task.loss_fn(
            clients[:r], {k: v[:r] for k, v in batch.items()}),
        "client gradient (its backward)": lambda r: _grad(
            torch, task, clients[:r], {k: v[:r] for k, v in batch.items()}),
        "fused_masked_agg over [B, m, n]": lambda r: masked.fused_masked_agg(
            clients[:r], active[:r],
            torch.zeros(r, dtype=torch.int32, device=server.device),
            server[:r].float().contiguous(),
            torch.full((r, m), 0.5, device=server.device))}
    out = {}
    for name, fn in ops.items():
        full, two = fn(3)[:2], fn(2)
        out[name] = float((full - two).abs().max())
    return out


def _grad(torch, task, clients, batch):
    leaf = clients.clone().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(task.loss_fn(leaf, batch).sum(), leaf)[0]


def phase20_sharded(torch, masked, fa, grid):
    """The sweep's multi-device split through the pool on the one card
    (``PHASE20_LIMIT_S``); see the constants above."""
    import threading

    from repro_torch.experiments import shard, sweep
    from repro_torch.launch.mesh import make_2d_mesh, make_batch_mesh
    from repro_torch.launch.roofline import collective_stats
    from repro_torch.sharding import pool

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    res = {}
    # the three sub-phases' pools start together while this process runs
    # the plain counterparts; a pool that failed to start here is started
    # again, and fails the run, at its first call
    meshes = {"a": make_batch_mesh([card]), "b": make_batch_mesh([card, card]),
              "c": make_2d_mesh(1, 2, [card, card])}
    starts = {k: threading.Thread(target=pool.pool_for, args=(m,),
                                  daemon=True) for k, m in meshes.items()}
    for t in starts.values():
        t.start()

    def await_pool(key):
        """Seconds this process waited for sub-phase ``key``'s pool."""
        t0 = time.perf_counter()
        starts[key].join(pool.START_TIMEOUT_S)
        waited = time.perf_counter() - t0
        res[key]["pool_wait_s"] = waited
        return waited
    spec = grid.SweepSpec(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                          seeds=SEEDS, rounds=ROUNDS, eval_every=EVAL_EVERY,
                          num_clients=CLIENTS, use_kernel=True)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) one worker on the card against this process
    plain, plain_s = timed(lambda: grid.run_cell_batch(
        spec, "fedpbc", "bernoulli_tv", mesh=None))
    res["a"] = {}
    waited = await_pool("a")
    one, one_s = timed(lambda: grid.run_cell_batch(
        spec, "fedpbc", "bernoulli_tv", devices=[card]))
    run = shard.last_run()
    diff = _cells_diff(plain, one)
    agg = [v["launches"]["fused_masked_agg"] for v in run.values]
    res["a"].update(_ranks_line("phase20a devices=[cuda:0]", run),
                    plain_s=plain_s, sharded_s=one_s, max_abs_diff=diff,
                    agg_launches=agg)
    print(f"phase20a fedpbc, seeds 0-2, {ROUNDS} rounds: mesh=None "
          f"{plain_s:.3f} s (beside the pools' starts), one worker "
          f"{one_s:.3f} s after a wait of {waited:.3f} s for its pool; "
          f"largest |diff| by field {diff}; the worker's fused_masked_agg "
          f"launches {agg} (rounds {ROUNDS})", flush=True)
    if run.backend != "nccl" or len(run.values) != 1:
        fail(f"phase 20a ran on {len(run.values)} ranks under {run.backend}, "
             "expected one NCCL rank")
    if any(diff.values()):
        fail(f"phase 20a is not bitwise: {diff}")
    if agg != [ROUNDS]:
        fail(f"phase 20a: the worker launched the aggregation {agg} times, "
             f"expected {ROUNDS}")

    # (b) two ranks sharing the card: B = 3 padded to 4, 2 rows a rank
    res["b"] = {}
    waited = await_pool("b")
    two, two_s = timed(lambda: grid.run_cell_batch(
        spec, "fedpbc", "bernoulli_tv", mesh=meshes["b"]))
    run = shard.last_run()
    diff = _cells_diff(plain, two)
    agg = [v["launches"]["fused_masked_agg"] for v in run.values]
    rows = [v["rows"] for v in run.values]
    probe = _batch_count_probe(torch, masked, grid, spec,
                               torch.as_tensor(plain[0].server, device=card))
    worst = max(diff.values())
    res["b"].update(_ranks_line("phase20b two ranks on cuda:0", run),
                    sharded_s=two_s, max_abs_diff=diff, agg_launches=agg,
                    rows=rows, batch_count_ops=probe)
    print(f"phase20b B = 3 padded to 4, rows by rank {rows}: {two_s:.3f} s "
          f"after a wait of {waited:.3f} s for its pool; largest |diff| "
          f"from 20a's plain "
          f"run by field {diff} (tol {SHARD_TOL:g}); fused_masked_agg "
          f"launches by rank {agg}; the round's batched ops on 2 rows "
          f"against 3: {probe}", flush=True)
    if run.backend != "gloo" or rows != [2, 2]:
        fail(f"phase 20b ran {rows} rows under {run.backend}, expected 2 "
             "and 2 under gloo")
    if two[0].test_acc.shape[0] != len(SEEDS) or \
            len({a.tobytes() for a in two[0].loss}) != len(SEEDS):
        fail("phase 20b: a padding row reached the result")
    if worst > 0:
        named = [k for k, v in probe.items() if v > 0] or [
            "none of the probed ops"]
        print(f"phase20b not bitwise ({worst:.3e}); the ops that differ at "
              f"2 rows against 3: {named}", flush=True)
    if worst > SHARD_TOL or agg != [ROUNDS, ROUNDS]:
        fail(f"phase 20b: |diff| {worst:.3e} over {SHARD_TOL:g}, or "
             f"aggregation launches {agg}")
    for key in ("a", "b"):
        pool.pool_for(meshes[key]).close()

    # (c) lm-family on a ("batch", "model") mesh of two ranks on the card
    lm = grid.SweepSpec(**LM_SWEEP)
    E = len(sweep.eval_rounds(lm.rounds, lm.eval_every))
    (task, st_p, out_p), lm_plain_s = timed(lambda: grid.run_batch_states(
        lm, FAMILY, "bernoulli_ti", mesh=None))
    mesh2d = meshes["c"]
    res["c"] = {}
    waited = await_pool("c")
    (_, st_s, out_s), lm_s = timed(lambda: grid.run_batch_states(
        lm, FAMILY, "bernoulli_ti", mesh=mesh2d))
    run = shard.last_run()
    B = len(FAMILY) * len(lm.lrs)
    m, k = lm.num_clients, mesh2d.shape["model"]
    rows_d = (st_p.server - st_s.server).abs().amax(-1)
    loss_d = float((out_p["metrics"]["loss"]
                    - out_s["metrics"]["loss"]).abs().max())
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkdv", "fused_masked_agg")
    launches = [[v["launches"][nm] for nm in names] for v in run.values]
    want = _want_launches(lm, E)
    n = task.layout.size
    stats = collective_stats(k, rows=B, clients=m, group_bytes=[4 * n],
                             rounds=lm.rounds, final_bytes=[4 * n, 4])
    gathers = [v["gathers"] for v in run.values]
    res["c"].update(
        _ranks_line("phase20c make_2d_mesh(1, 2) on cuda:0", run),
        plain_s=lm_plain_s, sharded_s=lm_s,
        max_server_diff=float(rows_d.max()), max_loss_diff=loss_d,
        launches=launches, want_launches=want,
        flash_bh=B * (m // k) * lm.batch_size * 4, gathers=gathers,
        collective_stats=dict(bytes_by_kind=stats.bytes_by_kind,
                              count_by_kind=stats.count_by_kind,
                              t_collective_s=stats.t_collective))
    print(f"phase20c lm-family B = {B}, m = {m} split {m // k} a rank, "
          f"{lm.rounds} rounds: one device {lm_plain_s:.3f} s, the mesh "
          f"{lm_s:.3f} s after a wait of {waited:.3f} s for its pool; "
          f"largest |server "
          f"diff| of a trajectory {rows_d.max().item():.3e} (tol "
          f"{LM_PATHS_TOL:g}), loss {loss_d:.3e}; launches by rank (flash "
          f"fwd, dq, dkdv, aggregation) {launches}, expected {want} each, "
          f"the flash kernels at [{res['c']['flash_bh']}, {lm.lm_seq}, "
          f"{lm.lm_d_model // 4}] (the rank's {m // k} clients); all-gathers "
          f"by rank {[(g['bytes_by_kind'], g['count_by_kind'], round(g['seconds'], 4)) for g in gathers]}, "
          f"counted {stats.bytes_by_kind} in {stats.count_by_kind} "
          f"({stats.t_collective * 1e3:.4f} ms at NVLink's 450 GB/s)",
          flush=True)
    if run.backend != "gloo" or len(run.values) != 2:
        fail(f"phase 20c ran {len(run.values)} ranks under {run.backend}")
    if not rows_d.max() <= LM_PATHS_TOL:
        fail("phase 20c: the 2-D mesh and one device diverge")
    if any(row != want for row in launches):
        fail(f"phase 20c launches {launches}, expected {want} on each rank")
    if any(g["bytes_by_kind"] != stats.bytes_by_kind
           or g["count_by_kind"] != stats.count_by_kind for g in gathers):
        fail("phase 20c: the all-gathers moved other bytes than "
             "collective_stats counts")
    pool.close_pools()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase20 done in {res['seconds']:.1f} s (limit "
          f"{PHASE20_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE20_LIMIT_S:
        fail(f"phase 20 took {res['seconds']:.1f} s, over its "
             f"{PHASE20_LIMIT_S:g} s")
    return res


def _suite_counts(masked, fa, rk):
    """The launch counters phase 21 reads, set to 0: the aggregation, the
    three flash kernels and the WKV6 wrapper by route."""
    counters = (masked.fused_masked_agg, fa.flash_attention_fwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv)
    for c in counters:
        c.launches = 0
    reset_wkv_counts(rk)

    def read():
        out = dict(zip(("fused_masked_agg",) + FLASH_NAMES,
                       (c.launches for c in counters)))
        out.update({f"wkv6_{k}": v for k, v in
                    rk.rwkv6_chunk.launches_by_route.items()})
        return out
    return read


def _momentum_check(torch):
    """FedPBC-M's server momentum on the card, free of seed noise: the
    first two rounds of fedpbc (the kernel) and of fedpbc_m through
    ``paper.common.run_training`` (markov_nonhom, m = 100, seed 0, an eval
    each round), the server read after each round by wrapping its
    ``make_run_rounds``. The same seed gives both the same draws, and the
    momentum starts at 0, so round 1 leaves the two servers equal and round
    2's aggregate step is the same for both: FedPBC-M's round-2 server must
    be FedPBC's plus ``FEDPBC_M_BETA`` times round 1's step."""
    from unittest import mock

    from repro_torch.paper import common

    real = common.make_run_rounds
    servers = {}

    def spy(*a, **k):
        run = real(*a, **k)

        def wrapped(st, ds, draws, n):
            if not servers[algo]:
                servers[algo].append(st.server.clone())
            st, ds, mets = run(st, ds, draws, n)
            servers[algo].append(st.server.clone())
            return st, ds, mets
        return wrapped
    with mock.patch.object(common, "make_run_rounds", spy):
        for algo in ("fedpbc", "fedpbc_m"):
            servers[algo] = []
            common.run_training(algo, "markov_nonhom", rounds=2, m=100,
                                seed=0, eval_every=1, use_kernel=True)
    s0, s1, s2 = servers["fedpbc"]
    m0, m1, m2 = servers["fedpbc_m"]
    lead = FEDPBC_M_BETA * (s1 - s0)
    err = (m2 - (s2 + lead)).abs().max().item()
    out = dict(round1_diff=(m1 - s1).abs().max().item(), round2_err=err,
               lead_max=lead.abs().max().item(), beta=FEDPBC_M_BETA)
    print(f"phase21 extensions momentum (markov_nonhom, seed 0, 2 rounds): "
          f"|fedpbc_m - fedpbc| after round 1 {out['round1_diff']:.3e}; "
          f"after round 2 fedpbc_m leads by {FEDPBC_M_BETA} x round 1's "
          f"step (largest {out['lead_max']:.3e}) within {err:.3e} (tol "
          f"{FP32_TOL:g})", flush=True)
    if not torch.equal(s0, m0):
        fail("phase 21 extensions: fedpbc and fedpbc_m start from other "
             "models")
    if not (torch.allclose(m1, s1, atol=FP32_TOL, rtol=FP32_TOL)
            and torch.allclose(m2, s2 + lead, atol=FP32_TOL, rtol=FP32_TOL)):
        fail(f"phase 21 extensions: FedPBC-M's momentum is off: {out}")
    if not out["lead_max"] > 100 * FP32_TOL:
        fail(f"phase 21 extensions: round 1's step ({out['lead_max']:.3e}) "
             "is too small to show the momentum")
    return out


def _suite_agg_timing(torch, masked, ref, args, bw, flops, nbytes=None):
    """``time_agg`` at the kernels suite's inputs. Its bound counts the
    bytes the function reads and writes: ``agg_work``'s (the mask, the
    opcode, the active rows of ``x``, ``p`` under OP_KNOWN_P, ``prev`` where
    the op reads it, the output written once) plus the inactive rows of
    ``x``, which it reads too (an inactive row's 0 * x carries a non-finite
    value into the result, as the reference's does); ``nbytes`` replaces
    that count. ``agg_work``'s bound over the active rows alone is kept as
    ``bound_active_ms``."""
    x, mask, op, prev, p = args
    t = time_agg(torch, masked, ref, args, bw, flops)
    if nbytes is None:
        inactive = mask.numel() - int(mask.sum())
        nbytes = t["bytes"] + inactive * x.shape[2] * x.element_size()
    _, nops = agg_work(x, mask, op)
    t.update(bound_active_ms=t["bound_ms"], bytes_active=t["bytes"],
             bound_ms=max(nbytes / bw, nops / flops) * 1e3, bytes=nbytes,
             bound_by="bytes" if nbytes / bw >= nops / flops
             else "operations")
    return t


def _kernels_suite_checks(torch, kb, fa, rk, ref, masked, bw, fp32_peak):
    """The kernels suite's shapes again, outside its counted run: each
    kernel against its plain version within its phase's bar (the suite's
    own inputs), and timed beside its plain version, its library call and
    its bound."""
    from repro_torch.kernels.dispatch import resolve_backend

    out = {"batched_agg": {}}
    for B, m in kb.SIZES:
        args = kb.agg_inputs(B, m)
        got = masked.fused_masked_agg(*args)
        want = ref.fused_masked_agg_ref(*args)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL):
            fail(f"phase 21: the aggregation at [{B},{m},{kb.N}] is "
                 f"{err:.3e} from its plain version (tol {FP32_TOL:g})")
        t = _suite_agg_timing(torch, masked, ref, args, bw, fp32_peak)
        t.update(max_abs_err=err, shape=[B, m, kb.N])
        out["batched_agg"][f"batched_agg_B{B}_m{m}_n{kb.N}"] = t
        print(f"phase21 kernels fused_masked_agg [{B},{m},{kb.N}] fp32, ops "
              f"0,1,2 cycling, half active: max_abs_err {err:.3e} (tol "
              f"{FP32_TOL:g}); kernel {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, torch.bmm {t['library_ms']:.5f} ms, "
              f"bound {t['bound_ms']:.5f} ms ({t['bytes']} bytes: every "
              f"row of x, prev and p where the op reads them; the active "
              f"rows alone {t['bound_active_ms']:.5f} ms)",
              flush=True)
    x, mask = kb.masked_inputs()
    got, want = masked.masked_agg(x, mask), ref.masked_agg_ref(x, mask)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL):
        fail(f"phase 21: masked_agg at {list(x.shape)} is {err:.3e} from "
             "its plain version")
    n = x.shape[1]
    # the wrapper's launch: B = 1, OP_MEAN, a zero prev and unit p
    args = (x[None], mask[None], torch.zeros(1, dtype=torch.int32,
                                             device=x.device),
            torch.zeros(1, n, device=x.device),
            torch.ones(1, x.shape[0], device=x.device))
    # masked_agg(x, mask) needs x, the mask and its output, no prev or p
    nbytes = (x.numel() * x.element_size()
              + mask.numel() * mask.element_size() + n * 4)
    t = _suite_agg_timing(torch, masked, ref, args, bw, fp32_peak, nbytes)
    t.update(max_abs_err=err, shape=list(x.shape))
    out["masked_agg"] = t
    print(f"phase21 kernels masked_agg {list(x.shape)} fp32 (prev=None): "
          f"max_abs_err {err:.3e}; kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms, torch.bmm {t['library_ms']:.5f} ms, "
          f"bound {t['bound_ms']:.5f} ms ({t['bytes']} bytes: x, the mask "
          f"and the output; the port's wrapper also reads a zero prev, "
          f"which the function does not need; the active rows alone "
          f"{t['bound_active_ms']:.5f} ms)", flush=True)
    q, k, v = kb.flash_inputs()
    got, want = fa.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v)
    err = (got - want).abs().max().item()
    atol, rtol = FLASH_TOL["float32"]
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        fail(f"phase 21: flash at {list(q.shape)} is {err:.3e} from its "
             "plain version")
    b, h, tq, d = q.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    t = flash_timing(torch, fa, ref, gen, b * h, tq, d, "float32", bw,
                     fp32_peak, "phase21 kernels", forward_only=True)["fwd"]
    t.update(max_abs_err=err, suite_shape=list(q.shape))
    out["flash_fwd"] = t
    args = kb.wkv_inputs()
    o1, s1 = rk.rwkv6_chunk(*args)
    o2, s2 = ref.rwkv6_chunk_ref(*args)
    err = max((o1 - o2).abs().max().item(), (s1 - s2).abs().max().item())
    if not (torch.allclose(o1, o2, atol=WKV_TOL, rtol=WKV_TOL)
            and torch.allclose(s1, s2, atol=WKV_TOL, rtol=WKV_TOL)):
        fail(f"phase 21: WKV6 at {kb.WKV_SHAPE} is {err:.3e} from the step "
             "scan")
    nbytes, flops = wkv_work(*kb.WKV_SHAPE)
    ms = time_ms(lambda: rk.rwkv6_chunk(*args), iters=20)
    plain_ms = time_ms_events(lambda: ref.rwkv6_chunk_ref(*args), iters=3)
    bound = max(nbytes / bw, flops / fp32_peak) * 1e3
    out["wkv6_chunked"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
        bound_by="bytes" if nbytes / bw >= flops / fp32_peak
        else "operations", bytes=nbytes, flops=flops, max_abs_err=err,
        route=rk.route_for(kb.WKV_SHAPE[2]), shape=list(kb.WKV_SHAPE))
    print(f"phase21 kernels rwkv6_chunk {list(kb.WKV_SHAPE)} fp32 "
          f"({out['wkv6_chunked']['route']} route): max_abs_err {err:.3e} "
          f"(tol {WKV_TOL:g}); kernel {ms:.5f} ms, plain (step scan) "
          f"{plain_ms:.5f} ms, bound {bound:.5f} ms ({nbytes} bytes, "
          f"{flops:.4e} flop)", flush=True)
    out["kernel_backend"] = resolve_backend(x)
    return out


def phase21_suites(torch, masked, fa, rk, ref, bw, fp32_peak, dry_row):
    """The last seven suites of ``benchmarks/run.py`` on the card (the
    module docstring's phase 21; ``PHASE21_LIMIT_S``)."""
    import tempfile
    from types import SimpleNamespace

    from repro_torch.paper import (
        extensions,
        kernels_bench,
        lm_sweep,
        roofline,
        scale,
        sweep_throughput,
        throughput,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = {"launches": {}, "seconds": {}}
    bench = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase21-", dir=os.path.join(ROOT,
                                                               "build"))

    def suite(name, fn):
        read = _suite_counts(masked, fa, rk)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["seconds"][name] = time.perf_counter() - t0
        res["launches"][name] = read()
        print(f"phase21 {name}: {res['seconds'][name]:.1f} s, launches "
              f"{res['launches'][name]}", flush=True)
        return out

    def written(name):
        with open(os.path.join(tmp, f"{name}.json")) as f:
            return json.load(f)

    try:
        # kernels: every family at the reference's shapes
        rows = suite("kernels", lambda: kernels_bench.run(
            out_path=os.path.join(tmp, "kernels.json")))
        bench["kernels"] = written("kernels")
        kb = bench["kernels"]
        got = res["launches"]["kernels"]
        want_agg = 7 * len(kernels_bench.SIZES) + 1
        if kb["kernel_backend"] != "kernel" or any(
                a["kernel_backend"] != "kernel" for a in kb["batched_agg"]):
            fail(f"phase 21: the kernels suite ran on {kb['kernel_backend']}")
        if (got["fused_masked_agg"], got["flash_attention_fwd"],
                got["wkv6_chunked"]) != (want_agg, 1, 1):
            fail(f"phase 21: the kernels suite launched {got}, expected the "
                 f"aggregation {want_agg} times (6 timed calls and one check "
                 "an arm, one masked_agg), the flash forward and the chunked "
                 "WKV6 route once")
        worst = max(a["max_abs_diff"] for a in kb["batched_agg"])
        print(f"phase21 kernels suite rows {rows}; batched_agg's largest "
              f"max_abs_diff {worst:.3e}", flush=True)
        res["kernels"] = _kernels_suite_checks(
            torch, kernels_bench, fa, rk, ref, masked, bw, fp32_peak)

        # throughput: the per-round loop against the multi-round engine
        tp = suite("throughput", lambda: throughput.run(
            use_kernel=True, out_path=os.path.join(tmp, "throughput.json")))
        bench["throughput"] = tp
        want = 3 * tp["rounds"] + 2
        if tp["final_loss_loop"] != tp["final_loss_scan"] or \
                res["launches"]["throughput"]["fused_masked_agg"] != want:
            fail(f"phase 21 throughput: losses {tp['final_loss_loop']} / "
                 f"{tp['final_loss_scan']}, aggregation launches "
                 f"{res['launches']['throughput']['fused_masked_agg']} "
                 f"(expected {want}: once a round of the warm-ups and the "
                 "two timed runs)")

        # extensions: FedPBC (the kernel, once a round) and FedPBC-M, at
        # the reference's p_base of each seed
        from unittest import mock

        from repro_torch.paper import common

        def reference_p(seed, m, classes, **kw):
            spec = SimpleNamespace(num_clients=m, seeds=(seed,))
            return _reference_p_base(spec, kw)[0], None, None
        with mock.patch.object(common, "build_base_probs", reference_p):
            ext = suite("extensions", lambda: extensions.run(
                rounds=EXTENSIONS_ROUNDS, seeds=EXTENSIONS_SEEDS,
                use_kernel=True))
        bench["extensions"] = {f"{s}/{a}": v for (s, a), v in ext.items()}
        for key, acc in ext.items():
            bar = EXTENSIONS_REFERENCE_MEAN[key] - ACC_MARGIN
            print(f"phase21 extensions {key}: 3-seed mean {acc:.4f} (bar "
                  f"{bar:.4f}, the reference's 3-seed mean "
                  f"{EXTENSIONS_REFERENCE_MEAN[key]:.4f} less {ACC_MARGIN})",
                  flush=True)
            if not acc >= bar:
                fail(f"phase 21 extensions {key}: {acc:.4f} below {bar:.4f}")
        if res["launches"]["extensions"]["fused_masked_agg"] != \
                2 * len(EXTENSIONS_SEEDS) * EXTENSIONS_ROUNDS:
            fail("phase 21 extensions: the aggregation should launch once a "
                 "round of FedPBC's runs and never for FedPBC-M")
        res["momentum"] = _momentum_check(torch)

        # sweep: the suite's own agreement checks raise on a divergence
        sw = suite("sweep", lambda: sweep_throughput.run(
            use_kernel=True, out_path=os.path.join(tmp, "sweep.json"),
            **SWEEP_CUT))
        bench["sweep"] = sw
        R, S = SWEEP_CUT["rounds"], SWEEP_CUT["n_seeds"]
        Ra, P = SWEEP_CUT["ablation_rounds"], 8
        # one launch a round of each batch run: the seed axis (2 batched,
        # S sequential), the ablations (2 traced, P per-value), the family
        # (2) and its 4 members (2 each), the device axis's one card (2)
        want = (2 + S) * R + (2 + P) * Ra + 10 * Ra + 2 * Ra
        if res["launches"]["sweep"]["fused_masked_agg"] != want:
            fail(f"phase 21 sweep: {res['launches']['sweep']} launches, "
                 f"expected {want} of the aggregation")

        # scale: the cohort and buffered engines launch no aggregation
        sc = suite("scale", lambda: scale.run(
            use_kernel=True, out_path=os.path.join(tmp, "scale.json"),
            **SCALE_SMOKE))
        bench["scale"] = sc
        for e in sc["by_m"].values():
            if min(e["commits_per_seed"]) < 1 or \
                    e["mean_commit_staleness"] > SCALE_DEADLINE:
                fail(f"phase 21 scale at m = {e['m']}: commits "
                     f"{e['commits_per_seed']}, staleness "
                     f"{e['mean_commit_staleness']}")
        if res["launches"]["scale"]["fused_masked_agg"]:
            fail("phase 21 scale launched the aggregation")

        # lm_sweep at its smoke size: every loss finite
        losses = []
        real = lm_sweep.make_runner

        def spy(*a, **k):
            run = real(*a, **k)

            def wrapped(batch, draws=None):
                st, out = run(batch, draws=draws)
                losses.append(out["metrics"]["loss"])
                return st, out
            return wrapped
        lm_sweep.make_runner = spy
        try:
            lm = suite("lm_sweep", lambda: lm_sweep.run(smoke=True,
                                                        use_kernel=True))
        finally:
            lm_sweep.make_runner = real
        bench["lm_sweep"] = lm
        got = res["launches"]["lm_sweep"]
        want = [2 * (a + b) for a, b in zip(
            _want_launches(SimpleNamespace(cohort_size=None, **LM_SMOKE), 1),
            _want_launches(SimpleNamespace(cohort_size=8, **LM_SMOKE), 1))]
        have = [got[n] for n in FLASH_NAMES + ("fused_masked_agg",)]
        print(f"phase21 lm_sweep launches (flash fwd, dq, dkdv, "
              f"aggregation) {have}, expected {want}; losses finite: "
              f"{all(bool(torch.isfinite(x).all()) for x in losses)}",
              flush=True)
        if have != want or not losses or not all(
                bool(torch.isfinite(x).all()) for x in losses):
            fail("phase 21 lm_sweep: launches or losses off")

        # roofline: phase 18e's dry-run row for smollm-135m x train_4k
        path = os.path.join(tmp, "dryrun_all.json")
        with open(path, "w") as f:
            json.dump([dry_row], f)
        rows = suite("roofline", lambda: roofline.run(path=path))
        bench["roofline"] = rows
        if [r["status"] for r in rows] != ["ok"]:
            fail(f"phase 21 roofline: rows {rows}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    res["bench"] = bench
    res["total_s"] = time.perf_counter() - t_phase
    print(f"phase21 done in {res['total_s']:.1f} s (limit "
          f"{PHASE21_LIMIT_S:g} s); by suite "
          + ", ".join(f"{k} {v:.1f} s" for k, v in res["seconds"].items()),
          flush=True)
    if res["total_s"] > PHASE21_LIMIT_S:
        fail(f"phase 21 took {res['total_s']:.1f} s, over its "
             f"{PHASE21_LIMIT_S:g} s")
    return res


def _census(lint, syncs, static, label, per, unit):
    """Print a host-sync census (events a ``unit`` inside steps and out of
    them, every in-step site) and fail if an in-step site is no finding
    of the static gate; returns its JSON summary."""
    inside, outside = syncs.sites(in_step=True), syncs.sites(in_step=False)
    n_in, n_out = sum(inside.values()), sum(outside.values())
    print(f"{label}: {n_in} syncs inside steps ({n_in / per:g} a {unit}), "
          f"{n_out} outside ({n_out / per:g} a {unit}); in-step sites "
          + (", ".join(f"{k} x{v}" for k, v in sorted(inside.items()))
             or "none") + "; out-of-step sites "
          + (", ".join(f"{k} x{v}" for k, v in sorted(outside.items()))
             or "none"), flush=True)
    sites = [(k.rsplit(":", 1)[0], int(k.rsplit(":", 1)[1])) for k in inside]
    missed = lint.unmatched_sites(sites, static)
    if missed:
        fail(f"{label}: in-step sync sites the static gate does not flag: "
             f"{[f'{f}:{n}' for f, n in missed]} (extend the rule)")
    return {"in_step": n_in, "outside": n_out, f"in_step_per_{unit}": n_in / per,
            f"outside_per_{unit}": n_out / per, "in_step_sites": inside,
            "outside_sites": outside}


def phase22_analysis(torch, masked, fa, grid):
    """The analysis gate's runtime half on the card: (a) phase 2's cell at
    ``PHASE22_ROUNDS`` rounds under ``HostSyncSanitizer``; (b) SmolLM-135M
    served at full width through ``serve.main``, without and with
    ``keep_logits`` (its ``.cpu()`` a token is the known positive); (c)
    runner pins: ``segment_runner_for`` for two specs that differ in lr and
    gamma builds one runner, and a second ``run_sweep`` at other
    hyperparameters compiles no Triton specialisation. Every in-step sync
    site must be a finding of the static gate (``lint.host_sync_sites``).
    Held to ``PHASE22_LIMIT_S``."""
    from repro_torch.analysis import lint, sanitize
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    static = lint.host_sync_sites()
    res = {"static_sync_findings": len(static)}
    print(f"phase22 static gate: {len(static)} host-sync findings in "
          f"src/repro_torch (new, grandfathered or suppressed)", flush=True)

    # (a) the sweep round
    spec = grid.SweepSpec(algorithms=FAMILY, schemes=("bernoulli_tv",),
                          seeds=SEEDS, rounds=PHASE22_ROUNDS,
                          eval_every=PHASE22_EVAL_EVERY,
                          num_clients=CLIENTS, use_kernel=True)
    masked.fused_masked_agg.launches = 0
    with sanitize.HostSyncSanitizer() as syncs:
        cells = grid.run_sweep(spec)
        torch.cuda.synchronize()
    launches = masked.fused_masked_agg.launches
    res["sweep"] = _census(lint, syncs, static, "phase22a run_sweep "
                           f"({PHASE22_ROUNDS} rounds)", PHASE22_ROUNDS,
                           "round")
    res["sweep"]["agg_launches"] = launches
    print(f"phase22a fused_masked_agg launches {launches} (want "
          f"{PHASE22_ROUNDS}: one a round)", flush=True)
    if launches != PHASE22_ROUNDS:
        fail(f"phase 22a: {launches} aggregation launches, expected one a "
             f"round ({PHASE22_ROUNDS})")
    if not all(np.isfinite(c.server).all() for c in cells):
        fail("phase 22a: non-finite parameters")

    # (b) serving: syncs a decode_step, without and with keep_logits
    b, p_len, g_len = PHASE22_SERVE
    steps = p_len + g_len
    cfg = get_config("smollm-135m")
    params = model.init_leaves(torch.Generator(device="cuda").manual_seed(0),
                               cfg)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkdv)
    serve_src = os.path.join(ROOT, "src", "repro_torch", "launch",
                             "serve.py")
    with open(serve_src) as fh:
        keep_line = next(i for i, text in enumerate(fh, 1)
                         if "kept.append(" in text)
    keep_site = f"src/repro_torch/launch/serve.py:{keep_line}"
    res["serve"] = {}
    for keep in (False, True):
        for c in counters:
            c.launches = 0
        with sanitize.HostSyncSanitizer() as syncs:
            out = serve.main(["--arch", "smollm-135m", "--full", "--batch",
                              str(b), "--prompt-len", str(p_len), "--gen",
                              str(g_len)], params=params, keep_logits=keep)
            torch.cuda.synchronize()
        row = _census(lint, syncs, static, f"phase22b serve smollm-135m "
                      f"--full batch {b}, {p_len} + {g_len} steps, "
                      f"keep_logits={keep}", steps, "step")
        row["flash_launches"] = [c.launches for c in counters]
        row["ids_shape"] = list(out["ids"].shape)
        res["serve"][f"keep_logits_{str(keep).lower()}"] = row
        if tuple(out["ids"].shape) != (b, g_len):
            fail(f"phase 22b: served ids {tuple(out['ids'].shape)}")
        if keep and row["in_step_sites"].get(keep_site, 0) != steps:
            fail(f"phase 22b: keep_logits's .cpu() at {keep_site} showed "
                 f"{row['in_step_sites'].get(keep_site, 0)} times in "
                 f"steps, expected once a token ({steps})")
    del params
    print(f"phase22b flash launches "
          f"{[r['flash_launches'] for r in res['serve'].values()]} (decode_"
          f"step attends with the plain decode_attention)", flush=True)

    # (c) runner pins
    base = dict(algorithms=("fedpbc",), schemes=("bernoulli_tv",),
                seeds=(0,), num_clients=CLIENTS, use_kernel=True)
    points = [grid.SweepSpec(**base, lr=0.05, gamma=0.3),
              grid.SweepSpec(**base, lr=0.2, gamma=0.7)]
    built = sanitize.runner_count(grid.segment_runner_for)
    with sanitize.assert_no_new_runners(grid.segment_runner_for, max_new=1,
                                        label="phase22c segments"):
        runners = [grid.segment_runner_for(
            sp, "fedpbc", "bernoulli_tv",
            segment_rounds=PHASE22_SEGMENT_ROUNDS) for sp in points]
    grown = sanitize.runner_count(grid.segment_runner_for) - built
    if grown != 1 or runners[0] is not runners[1]:
        fail(f"phase 22c: two specs differing only in lr and gamma built "
             f"{grown} segment runners, expected exactly 1 (one shared)")
    masked.fused_masked_agg.launches = 0
    sweeps = [dataclasses.replace(sp, rounds=PHASE22_PIN_ROUNDS,
                                  eval_every=PHASE22_PIN_ROUNDS)
              for sp in points]
    grid.run_sweep(sweeps[0])
    specs_before = masked.compiled_specializations()
    if specs_before is None:
        fail("phase 22c: masked_agg.compiled_specializations() is None on "
             "the card (no Triton cache introspection)")
    with sanitize.assert_no_new_runners(masked.compiled_specializations,
                                        label="phase22c triton"):
        grid.run_sweep(sweeps[1])
        torch.cuda.synchronize()
    res["pins"] = {"segment_runners_built": grown,
                   "triton_specializations": specs_before,
                   "agg_launches": masked.fused_masked_agg.launches}
    print(f"phase22c segment_runner_for at lr/gamma 0.05/0.3 and 0.2/0.7: "
          f"built +{grown}, one runner; run_sweep at both points: Triton "
          f"specialisations {specs_before} -> "
          f"{masked.compiled_specializations()}; aggregation launches "
          f"{res['pins']['agg_launches']}", flush=True)
    if res["pins"]["agg_launches"] != 2 * PHASE22_PIN_ROUNDS:
        fail(f"phase 22c: {res['pins']['agg_launches']} aggregation "
             f"launches, expected {2 * PHASE22_PIN_ROUNDS}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase22 done in {res['seconds']:.1f} s (limit "
          f"{PHASE22_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE22_LIMIT_S:
        fail(f"phase 22 took {res['seconds']:.1f} s, over its "
             f"{PHASE22_LIMIT_S:g} s")
    return res


_DRY_ROW = """
import json, sys
from repro_torch.launch import dryrun
r = dryrun.lower_pair(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "1",
                      verbose=False)
print("ROW " + json.dumps({k: v for k, v in r.items() if k != "trace"}))
if r["status"] == "FAIL":
    print(r["trace"], file=sys.stderr)
"""


def _spawn(argv, env_extra=None):
    """A worker process of phase 23, its output kept in temporary files
    (read by ``_reap``, so no pipe fills while this process works)."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **(env_extra or {}))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(argv, stdout=out, stderr=err, text=True,
                            env=env, cwd=ROOT)
    return proc, out, err


def _reap(spawned, label, timeout):
    proc, out, err = spawned
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"phase 23: {label} ran over {timeout:g} s")
    out.seek(0)
    err.seek(0)
    text, errs = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        print(errs[-3000:], file=sys.stderr, flush=True)
        fail(f"phase 23: {label} exited {proc.returncode}")
    return text


def phase23_meshes(torch, fa):
    """The dry run on the production meshes, rank 0 of the 16x16 prefill
    on the card, and the four examples (see the module docstring). Held to
    ``PHASE23_LIMIT_S``."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    # (a) and (c) start in worker processes, (b) runs here meanwhile
    rows = {(a, s, mp): _spawn([sys.executable, "-c", _DRY_ROW, a, s,
                                "1" if mp else "0"],
                               {"CUDA_VISIBLE_DEVICES": ""})
            for a, s, mp in PHASE23_ROWS}
    examples = {name: _spawn([sys.executable, os.path.join(
        ROOT, "examples", "torch_port", f"{name}.py"), *args])
        for name, args in PHASE23_EXAMPLES}
    try:
        res = _phase23_checks(torch, fa, dryrun, get_config, INPUT_SHAPES,
                              rows, examples)
    finally:
        for proc, _, _ in [*rows.values(), *examples.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase23 done in {res['seconds']:.1f} s (limit "
          f"{PHASE23_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE23_LIMIT_S:
        fail(f"phase 23 took {res['seconds']:.1f} s, over its "
             f"{PHASE23_LIMIT_S:g} s")
    return res


def _check_rank0_attention(torch, call):
    """Phase 23b's flash forward at rank 0's local shape and keywords
    (``call``: ``run_rank0``'s ``attention``) on unit normals through
    ``dispatch.attention`` (the kernel), against the plain version
    (``attention_ref`` in fp32, chunked over keys, so no ``T x T`` score
    tensor) within ``FLASH_TOL``. Fails on a mismatch; returns the max
    |err|."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.attention import attention_ref

    kw = {n: x for n, x in call["kw"].items() if n != "backend"}
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = (torch.randn(call["shape"], generator=gen, device="cuda")
               .to(call["dtype"]) for _ in range(3))
    atol, rtol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    got = dispatch.attention(q, k, v, **kw)
    want = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    ok = (torch.allclose(got.float(), want, rtol=rtol, atol=atol)
          and bool(torch.isfinite(got).all()))
    print(f"phase23b flash forward at rank 0's local {call['shape']} "
          f"{q.dtype} {kw}, unit normals, vs attention_ref fp32: "
          f"max_abs_err {err:.3e}, max|ref| {want.abs().max().item():.3e} "
          f"| atol {atol:g} rtol {rtol:g} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"phase 23b: the flash forward disagrees with its plain "
             f"version at rank 0's local {call['shape']}")
    return err


def _phase23_checks(torch, fa, dryrun, get_config, INPUT_SHAPES, rows,
                    examples):
    """Phase 23's (b) here, then (a)'s and (c)'s workers reaped and
    checked."""
    res = {"rows": {}, "examples": {}}

    # (b) rank 0 of the 16x16 prefill on the card
    arch, shape_name = PHASE23_RANK0
    cfg = get_config(arch)
    fa.flash_attention_fwd.launches = 0
    run = dryrun.run_rank0(
        cfg, INPUT_SHAPES[shape_name], device="cuda",
        measure=lambda fn: profile_window(torch, "phase23b rank 0 prefill",
                                          fn, 1, "step"))
    kernel_launches = fa.flash_attention_fwd.launches
    call = run.pop("attention")
    res["rank0"] = {**run, "kernel_launches": kernel_launches}
    print(f"phase23b rank 0 of {arch} x {shape_name} (16x16) on cuda:0: "
          f"{run['launches']} flash forward launches a step at "
          f"{run['flash_shapes']} (counter {kernel_launches} over the warm "
          f"and measured steps); logits {run['out_shape']} global, "
          f"{run['out_local_shape']} on rank 0; inputs "
          f"{run['input_bytes']} B, peak above what was allocated before "
          f"the step {run['peak_bytes']} B; the step's values not "
          f"compared (a simulated group's collectives deliver no other "
          f"rank's data)",
          flush=True)
    if kernel_launches != 2 * run["launches"]:
        fail(f"phase 23b: the flash forward's counter says "
             f"{kernel_launches} launches, the step recorded "
             f"{run['launches']} (x2 runs)")
    res["rank0"]["max_abs_err"] = _check_rank0_attention(torch, call)

    # (a) the rows
    for key, proc in rows.items():
        out = _reap(proc, f"dry-run row {key}", PHASE23_LIMIT_S)
        row = json.loads(next(line[4:] for line in out.splitlines()
                              if line.startswith("ROW ")))
        res["rows"][f"{key[0]} x {key[1]} {row['mesh']}"] = row
        print(f"phase23a {key[0]} x {key[1]} mesh={row['mesh']} "
              f"{row['status']} count_s {row.get('count_s')} param_bytes "
              f"{row.get('param_bytes')} argument_bytes "
              f"{row.get('argument_bytes')} collectives "
              f"{json.dumps(row.get('collectives'))} by axis "
              f"{json.dumps(row.get('collective_bytes_by_axis'))} by op "
              f"{json.dumps(row.get('collective_bytes_by_op'))} replicated "
              f"ops {json.dumps(row.get('replicated_ops'))} "
              f"t_compute/memory/collective {row.get('t_compute_s')} "
              f"{row.get('t_memory_s')} {row.get('t_collective_s')}",
              flush=True)
        if row["status"] != "ok":
            fail(f"phase 23a: row {key} is {row['status']}: "
                 f"{row.get('error')}")
        if row["mode"] == "train" and not row["t_collective_s"] > 0:
            fail(f"phase 23a: train row {key} has no collective time")
        if key[2]:
            axes = row["collective_bytes_by_axis"]
            if (row.get("num_clients") != 2
                    or not row["client_placements"].startswith(
                        "(Shard(dim=1)")
                    or axes.get("pod", 0) < row["param_bytes"]):
                fail(f"phase 23a: 2x16x16 row: clients "
                     f"{row.get('num_clients')} placed "
                     f"{row.get('client_placements')}, pod bytes "
                     f"{axes.get('pod', 0)} (want 2 clients over 'pod' and "
                     f"pod traffic >= {row['param_bytes']})")
    row = res["rows"][f"{arch} x {shape_name} 16x16"]
    want = sorted(tuple(x) for x in row["flash_shapes"])
    if (run["launches"] != row["flash_launches"]["fwd"]
            or [tuple(x) for x in run["flash_shapes"]] != want):
        fail(f"phase 23b: rank 0 launched {run['launches']} at "
             f"{run['flash_shapes']}, the count predicts "
             f"{row['flash_launches']['fwd']} at {want}")
    bound_ms = 1e3 * max(row["t_compute_s"], row["t_memory_s"])
    res["rank0"]["row_bound_ms"] = bound_ms
    print(f"phase23b device ms {run['measured']['device_ms_per_step']:.3f} "
          f"(wall {run['measured']['wall_ms_per_step']:.1f}) beside the "
          f"row's max(t_compute, t_memory) {bound_ms:.3f} ms; peak "
          f"{run['peak_bytes']} B and inputs {run['input_bytes']} B beside "
          f"the row's argument_bytes {row['argument_bytes']} B", flush=True)
    if run["input_bytes"] != row["argument_bytes"]:
        fail(f"phase 23b: rank 0's inputs on the card take "
             f"{run['input_bytes']} B, the count says "
             f"{row['argument_bytes']} B")

    # (c) the examples
    for name, proc in examples.items():
        out = _reap(proc, f"example {name}", PHASE23_LIMIT_S)
        res["examples"][name] = out.strip().splitlines()[-1][:200]
        print(f"phase23c examples/torch_port/{name}.py exit 0: "
              f"{res['examples'][name]}", flush=True)
    if "implicit gossiping wins" not in res["examples"]["quickstart"]:
        fail("phase 23c: the quickstart printed no FedPBC result")
    return res


def check_flash_offset(torch, fa, gen, bh, tq, d, q_offset, dtype, tag):
    """The three kernels' causal-offset route, ``q [bh, tq, d]`` at
    ``q_offset`` against ``k, v [bh, q_offset + tq, d]`` through
    ``flash_attention``, against the model stack's plain
    ``attention_ref(..., q_offset=...)`` in fp32 and its autograd within
    ``FLASH_TOL``; one launch of each kernel, at the offset. Fails on a
    mismatch; returns each output's max |err|."""
    from repro_torch.models.attention import attention_ref

    dt = getattr(torch, dtype)
    dev = gen.device
    tk = q_offset + tq
    q, g = (torch.randn(1, bh, tq, d, generator=gen, device=dev).to(dt)
            for _ in range(2))
    k, v = (torch.randn(1, bh, tk, d, generator=gen, device=dev).to(dt)
            for _ in range(2))
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkdv)
    before = [f.offset_launches for f in fns]
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*ts, q_offset=q_offset)
    grads = torch.autograd.grad(out, ts, g)
    rs = [x.float().transpose(1, 2).clone().requires_grad_(True)
          for x in (q, k, v)]
    want = attention_ref(*rs, q_offset=q_offset)
    want_grads = torch.autograd.grad(want, rs, g.float().transpose(1, 2))
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dtype]
    e, ok = {}, True
    for n, a, w in zip(("o", "dq", "dk", "dv"), (out,) + grads,
                       (want,) + want_grads):
        w = w.transpose(1, 2)
        e[n] = (a.float() - w).abs().max().item()
        ok = ok and bool(torch.isfinite(a).all()) and torch.allclose(
            a.float(), w, rtol=rtol, atol=atol)
    launched = [f.offset_launches - b for f, b in zip(fns, before)]
    print(f"{tag} flash causal-offset route q [{bh},{tq},{d}] at q_offset "
          f"{q_offset} vs k, v [{bh},{tk},{d}] {dtype}: max_abs_err "
          + " ".join(f"{n} {x:.3e}" for n, x in e.items())
          + f" against attention_ref (atol {atol:g} rtol {rtol:g}); "
          f"offset launches {launched} "
          f"{'ok' if ok and launched == [1, 1, 1] else 'MISMATCH'}",
          flush=True)
    if not ok or launched != [1, 1, 1]:
        fail(f"the causal-offset route disagrees with attention_ref at "
             f"[{bh},{tq}|{tk},{d}] {dtype}, or launched {launched}")
    del q, k, v, g, ts, out, grads, rs, want, want_grads
    torch.cuda.empty_cache()
    return e


def _gib(n):
    return None if n is None else round(n / 2 ** 30, 3)


def _seq_cell(torch, grid, shard, spec, mesh, label, *, clients_too=False):
    """One family batch of ``spec`` on one device (this process) and with
    each sequence split over ``mesh``'s two model ranks (the pool), with
    phase 24's bars: the largest |server diff| of a trajectory within
    ``LM_PATHS_TOL``, both ranks' servers and outputs bitwise equal
    (their digests), each rank's launches as one device's with rank 1's
    training at an offset and rank 0's not, no plain attention on either
    rank, every rank's collectives as ``collective_stats`` counts them.
    ``clients_too``: the same runner once more with the clients split
    (``activation_spec=None``), for its wall and peak memory a rank."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.experiments import sweep
    from repro_torch.launch.roofline import collective_stats

    fed = spec.cell_config(spec.algorithms[0], spec.schemes[0])
    task = grid.get_traced_task(spec)
    batch = grid.make_cell_batch(spec, fed, task, algos=spec.algorithms)
    plain = grid.make_runner(spec, fed, task)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, out_p = plain(batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    r2d = grid.make_runner(spec, fed, task, shard_mesh=mesh)
    t0 = time.perf_counter()
    st_s, out_s = shard.run_sharded_2d(r2d, batch, mesh,
                                       activation_spec=shard.SEQUENCE_SPEC)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    run = shard.last_run()
    B, m, k = batch.batch_size, spec.num_clients, mesh.shape["model"]
    L, s, T = spec.lm_layers, spec.local_steps, spec.lm_seq
    E = len(sweep.eval_rounds(spec.rounds, spec.eval_every))
    rows_d = (st_p.server - st_s.server).abs().amax(-1)
    loss_p = out_p["metrics"]["loss"][:, -1].tolist()
    loss_s = out_s["metrics"]["loss"][:, -1].tolist()
    names = FLASH_NAMES + ("fused_masked_agg",)
    launches = [[v["launches"][nm] for nm in names] for v in run.values]
    offset = [[v["offset_launches"][nm] for nm in FLASH_NAMES]
              for v in run.values]
    want = _want_launches(spec, E)
    want_offset = [[0] * 3, [L * s * spec.rounds] * 3]
    cfg = reduced(get_config(spec.lm_arch), d_model=spec.lm_d_model,
                  layers=L)
    kv = spec.batch_size * T * cfg.attention.num_kv_heads * cfg.head_dim * 4
    stats = collective_stats(k, rows=B, clients=m,
                             group_bytes=[4 * task.layout.size],
                             rounds=spec.rounds, sequence=(L, s, kv))
    gathers = [v["gathers"] for v in run.values]
    digests = [v["digest"] for v in run.values]
    plain_calls = [v["plain_attention"] for v in run.values]
    peak = [v["peak_bytes"] for v in run.values]
    res = dict(_ranks_line(f"{label} make_2d_mesh(1, 2) on cuda:0", run),
               B=B, m=m, T=T, rank_T=T // k, plain_s=plain_s,
               seq_parallel_s=seq_s, max_server_diff=float(rows_d.max()),
               final_loss_plain=loss_p, final_loss_seq_parallel=loss_s,
               launches=launches, want_launches=want,
               offset_launches=offset, plain_attention=plain_calls,
               digests_equal=digests[0] == digests[1],
               seq_split=[v["seq_split"] for v in run.values],
               gathers=gathers, peak_bytes=peak,
               flash_rank1_shape=[B * m * spec.batch_size
                                  * cfg.attention.num_heads, T // k,
                                  T, cfg.head_dim],
               collective_stats=dict(bytes_by_kind=stats.bytes_by_kind,
                                     count_by_kind=stats.count_by_kind,
                                     t_collective_s=stats.t_collective))
    print(f"{label} B = {B}, m = {m}, T = {T} split {T // k} a rank, "
          f"{spec.rounds} rounds: one device {plain_s:.3f} s, the sequence "
          f"split {seq_s:.3f} s; largest |server diff| of a trajectory "
          f"{rows_d.max().item():.3e} (tol {LM_PATHS_TOL:g}); final losses "
          f"one device {[round(x, 6) for x in loss_p]}, split "
          f"{[round(x, 6) for x in loss_s]}; launches by rank (flash fwd, "
          f"dq, dkdv, aggregation) {launches}, expected {want} each; at an "
          f"offset {offset}, expected {want_offset}; rank 1's flash "
          f"shape q [{res['flash_rank1_shape'][0]}, {T // k}] at q_offset "
          f"{T // k} against k, v [{res['flash_rank1_shape'][0]}, {T}]; "
          f"plain attention calls {plain_calls}; the ranks' digests "
          f"{'equal' if digests[0] == digests[1] else 'DIFFER'}; "
          f"collectives by rank {[(g['bytes_by_kind'], g['count_by_kind'], round(g['seconds'], 4)) for g in gathers]}, "
          f"counted {stats.bytes_by_kind} in {stats.count_by_kind} "
          f"({stats.t_collective * 1e3:.4f} ms at NVLink's 450 GB/s); peak "
          f"memory a rank {[_gib(x) for x in peak]} GiB",
          flush=True)
    if run.backend != "gloo" or len(run.values) != 2 \
            or not all(res["seq_split"]):
        fail(f"{label} ran {len(run.values)} ranks under {run.backend}, "
             f"split {res['seq_split']}")
    if not rows_d.max() <= LM_PATHS_TOL:
        fail(f"{label}: the sequence split and one device diverge")
    if not res["digests_equal"]:
        fail(f"{label}: the two model ranks' servers or outputs differ")
    if any(row != want for row in launches) or offset != want_offset:
        fail(f"{label}: launches {launches} (offset {offset}), expected "
             f"{want} ({want_offset})")
    if any(plain_calls):
        fail(f"{label}: the plain attention ran on the card {plain_calls}")
    if any(g["bytes_by_kind"] != stats.bytes_by_kind
           or g["count_by_kind"] != stats.count_by_kind for g in gathers):
        fail(f"{label}: the collectives moved other bytes than "
             "collective_stats counts")
    if clients_too:
        t0 = time.perf_counter()
        st_c, _ = shard.run_sharded_2d(r2d, batch, mesh)
        torch.cuda.synchronize()
        cl = shard.last_run()
        res["clients_split"] = dict(
            seconds=time.perf_counter() - t0,
            peak_bytes=[v["peak_bytes"] for v in cl.values],
            gathers=[v["gathers"] for v in cl.values],
            max_server_diff=float((st_p.server - st_c.server).abs().max()))
        print(f"{label} the same runner with the clients split "
              f"({m // k} a rank): {res['clients_split']['seconds']:.3f} s, "
              f"peak memory a rank "
              f"{[_gib(x) for x in res['clients_split']['peak_bytes']]}"
              f" GiB against the sequence split's "
              f"{[_gib(x) for x in peak]}; largest |server "
              f"diff| {res['clients_split']['max_server_diff']:.3e}",
              flush=True)
        if any(cl.values[i]["seq_split"] for i in range(2)) or \
                not res["clients_split"]["max_server_diff"] <= LM_PATHS_TOL:
            fail(f"{label}: the clients split with the same runner failed")
    return res


def phase24_seq_parallel(torch, fa, ref, grid, bw, fp32_peak, bf16_peak):
    """Sequence-parallel activations in the sharded LM sweep
    (``PHASE24_LIMIT_S``); see the constants above."""
    import threading

    from repro_torch.experiments import shard
    from repro_torch.launch.mesh import make_2d_mesh
    from repro_torch.sharding import pool

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    mesh = make_2d_mesh(1, 2, [card, card])
    start = threading.Thread(target=pool.pool_for, args=(mesh,), daemon=True)
    start.start()
    res = {}
    # (c) first, while the pool starts: the offset route alone, checked and
    # timed, beside its aligned twins
    gen = torch.Generator(device=card).manual_seed(24)
    checks, timed = {}, {}
    for bh, tq, d, off, dt in SEQ_OFFSET_SHAPES:
        key = f"[{bh},{tq}|{off + tq},{d}] {dt}"
        checks[key] = check_flash_offset(torch, fa, gen, bh, tq, d, off, dt,
                                         "phase24c")
        peak = bf16_peak if dt == "bfloat16" else fp32_peak
        timed[key] = flash_timing(torch, fa, ref, gen, bh, tq, d, dt, bw,
                                  peak, "phase24c", q_offset=off)
    for bh, t, d, dt in SEQ_ALIGNED_TWINS:
        peak = bf16_peak if dt == "bfloat16" else fp32_peak
        timed[f"[{bh},{t},{d}] {dt}"] = flash_timing(
            torch, fa, ref, gen, bh, t, d, dt, bw, peak, "phase24c")
    res["c"] = {"max_abs_err": checks, "timed": timed,
                "seconds": time.perf_counter() - t_phase}
    print(f"phase24c done at {res['c']['seconds']:.1f} s", flush=True)
    # (a) lm-family, (b) lm-wide, each sequence split over the two ranks
    t0 = time.perf_counter()
    start.join(pool.START_TIMEOUT_S)
    res["pool_wait_s"] = time.perf_counter() - t0
    print(f"phase24 waited {res['pool_wait_s']:.3f} s for its pool after "
          f"24c", flush=True)
    res["a"] = _seq_cell(torch, grid, shard, grid.SweepSpec(**LM_SWEEP),
                         mesh, "phase24a lm-family")
    wide = grid.SweepSpec(**{**LM_SWEEP, **LM_WIDE,
                             "rounds": SEQ_WIDE_ROUNDS,
                             "eval_every": SEQ_WIDE_ROUNDS})
    res["b"] = _seq_cell(torch, grid, shard, wide, mesh, "phase24b lm-wide",
                         clients_too=True)
    pool.close_pools()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase24 done in {res['seconds']:.1f} s (limit "
          f"{PHASE24_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE24_LIMIT_S:
        fail(f"phase 24 took {res['seconds']:.1f} s, over its "
             f"{PHASE24_LIMIT_S:g} s")
    return res


def _wkv_fwd_check(torch, rk, ref, ins, label, route=None):
    """``rwkv6_chunk`` (one call, ``route`` or by T) against the plain
    version within ``WKV_TOL``; fails on a mismatch. Returns the largest
    error of ``o`` and ``S_T``."""
    o, s_t = rk.rwkv6_chunk(*ins, route=route)
    wo, ws = ref.rwkv6_chunk_plain(*ins, chunk=rk.CHUNK)
    torch.cuda.synchronize()
    err = max((o - wo).abs().max().item(), (s_t - ws).abs().max().item())
    ok = all(bool(torch.isfinite(a).all()) and torch.allclose(
        a, w, rtol=WKV_TOL, atol=WKV_TOL) for a, w in ((o, wo), (s_t, ws)))
    print(f"{label} forward vs plain: max_abs_err {err:.3e} (tol "
          f"{WKV_TOL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{label}: the WKV6 forward disagrees with its plain version")
    return err


def _wkv_timed(torch, rk, ref, gen, shape, label, bw, fp32_peak):
    """The WKV6 wrapper at ``shape`` ``(b, h, t, d)`` from a non-zero
    ``s0`` with a non-zero ``dS_T`` (a state carried into a chunk), checked
    forward and backward against the plain version (the backward through
    ``rwkv6_chunk_autograd``, ``WKV_BWD_TOL``) and counted on the pad or
    block route the head dim takes, then timed: the forward
    (``rwkv6_chunk``, CUDA-graph replays) and the autograd backward (CUDA
    events; on the pad or block route the pads', folds' and slices' copies
    included) beside the plain version's and the bounds at the true head
    dim."""
    b, h, t, d = shape
    ins, do, ds_t = _wkv_bwd_inputs(torch, gen, b, h, t, d, "ref")
    routes = ("padded", "blocked")
    before = {r: dict(getattr(rk.rwkv6_chunk, f"{r}_launches"))
              for r in routes}
    err = max(_wkv_fwd_check(torch, rk, ref, ins, label),
              _wkv_bwd_check(torch, rk, ref, ins, do, ds_t, label))
    # the head dim's route, if any: blocks above 128, the pads below
    route = None if d in rk.HEAD_DIMS else (
        "blocked" if d > rk.HEAD_DIMS[-1] else "padded")
    for r in routes:
        got = {k: v - before[r][k] for k, v in
               getattr(rk.rwkv6_chunk, f"{r}_launches").items()}
        one = int(r == route)
        if got != {"forward": 2 * one, "backward": one}:
            fail(f"{label}: the {r} route counted {got}")
    ms = time_ms(lambda: rk.rwkv6_chunk(*ins, route="chunked"), iters=50)
    plain_ms = time_ms_events(lambda: ref.rwkv6_chunk_plain(
        *ins, chunk=rk.CHUNK), iters=5)

    def backward_ms(fn, iters):
        leaves = [x.clone().requires_grad_(True) for x in ins]
        o, s = fn(*leaves)
        return time_ms_events(lambda: torch.autograd.grad(
            [o, s], leaves, [do, ds_t], retain_graph=True), iters=iters)

    bwd_ms = backward_ms(rk.rwkv6_chunk_autograd, 10)
    plain_bwd_ms = backward_ms(ref.rwkv6_chunk_plain, 3)
    row = dict(shape=list(shape), padded_to=rk.padded_head_dim(d),
               route=route, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               backward_ms=bwd_ms, plain_backward_ms=plain_bwd_ms,
               library_ms=None)
    for key, direction in (("", "fwd"), ("backward_", "bwd")):
        nbytes, flops = wkv_work(b, h, t, d, direction=direction)
        row[f"{key}bound_ms"] = max(nbytes / bw, flops / fp32_peak) * 1e3
        row[f"{key}bound_by"] = ("operations" if flops / fp32_peak
                                 > nbytes / bw else "bytes")
    print(f"{label} timing {list(shape)} fp32 (head dim {d} run at "
          f"{row['padded_to']}, {route or 'as it is'}): forward {ms:.5f} ms "
          f"(CUDA-graph replays; "
          f"plain {plain_ms:.5f}), autograd backward {bwd_ms:.5f} ms (CUDA "
          f"events; plain {plain_bwd_ms:.5f}); bounds {row['bound_ms']:.5f} "
          f"/ {row['backward_bound_ms']:.5f} ms by {row['bound_by']} / "
          f"{row['backward_bound_by']} at the true head dim; library none",
          flush=True)
    del ins, do, ds_t
    torch.cuda.empty_cache()
    return row


def _one_device_counted(torch, grid, spec, task=None):
    """One family batch of ``spec`` on one device with every count (flash
    and its wide-head route, aggregation, WKV6 and its pad and block
    routes, the plain attention and WKV6 calls) set to 0 just
    before and read just after: ``(server, out, counts, wall s, peak
    bytes, batch, task, fed)``; the rest of the final state is freed, and
    the allocator's cache emptied, so that a pool sharing the card finds
    the room."""
    from repro_torch.experiments import shard
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_agg
    from repro_torch.kernels import rwkv6_chunk as rk

    fed = spec.cell_config(spec.algorithms[0], spec.schemes[0])
    task = task or grid.get_traced_task(spec)
    batch = grid.make_cell_batch(spec, fed, task, algos=spec.algorithms)
    runner = grid.make_runner(spec, fed, task)
    fns = dict(zip(FLASH_NAMES + FLASH_WIDE_NAMES, (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkdv, fa.flash_attention_wide_fwd,
        fa.flash_attention_wide_bwd_dq, fa.flash_attention_wide_bwd_dkdv)),
        fused_masked_agg=masked_agg.fused_masked_agg)
    gc.collect()
    torch.cuda.empty_cache()
    for f in fns.values():
        f.launches = 0
    rk.reset_counts()
    dispatch.plain_attention_calls = dispatch.plain_wkv6_calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, out = runner(batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict({k: f.launches for k, f in fns.items()},
                  **shard._wkv6_launches(rk),
                  plain_attention=dispatch.plain_attention_calls,
                  plain_wkv6=dispatch.plain_wkv6_calls)
    peak = torch.cuda.max_memory_allocated()
    server = st.server
    del st, runner
    gc.collect()
    torch.cuda.empty_cache()
    return server, out, counts, sec, peak, batch, task, fed


def _seq_family_cell(torch, grid, shard, spec, mesh, label, one=None):
    """One family batch of ``spec`` (an MoE, RWKV6 or hybrid arch) on one
    device (``one``: that run, already made) and with each sequence split
    over ``mesh``'s two model ranks, with phase 25's bars: the largest
    |server diff| of a trajectory within ``LM_PATHS_TOL``, both ranks'
    servers and outputs bitwise equal, each rank's flash and aggregation
    launches as one device's with rank 1's training at ``q_offset = T /
    2``, its WKV6 calls one device's plus one more forward a layer and
    local step and twice the backward (the chunk's state from zero, then
    its outputs from the carried state), through the zero-padded route
    where the head dim is not the kernels', no plain attention or WKV6
    call on either rank, every rank's collectives as ``collective_stats``
    counts them with the family's ``sequence_exchanges``."""
    import dataclasses as dc

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import rwkv6_chunk as rk
    from repro_torch.launch.roofline import (collective_stats,
                                             sequence_exchanges)

    server_p, out_p, one_counts, plain_s, one_peak, batch, task, fed = (
        one or _one_device_counted(torch, grid, spec))
    r2d = grid.make_runner(spec, fed, task, shard_mesh=mesh)
    t0 = time.perf_counter()
    st_s, out_s = shard.run_sharded_2d(r2d, batch, mesh,
                                       activation_spec=shard.SEQUENCE_SPEC)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    run = shard.last_run()
    B, m, k = batch.batch_size, spec.num_clients, mesh.shape["model"]
    L, s, T = spec.lm_layers, spec.local_steps, spec.lm_seq
    cfg = dc.replace(reduced(get_config(spec.lm_arch), d_model=spec.lm_d_model,
                             layers=L), dtype="float32")
    kinds = [cfg.layer_kind(i) for i in range(L)]
    attn, rwkv = kinds.count("attn"), kinds.count("rwkv")
    steps = s * spec.rounds
    padded = bool(rwkv) and rk.padded_head_dim(cfg.rwkv.head_dim) != \
        cfg.rwkv.head_dim
    want = dict(one_counts, plain_attention=0, plain_wkv6=0)
    want["wkv6_fwd"] += rwkv * steps
    want["wkv6_bwd"] *= 2
    want["wkv6_fwd_padded"] = want["wkv6_fwd"] if padded else 0
    want["wkv6_bwd_padded"] = want["wkv6_bwd"] if padded else 0
    got = [dict(v["launches"], plain_attention=v["plain_attention"],
                plain_wkv6=v["plain_wkv6"]) for v in run.values]
    offset = [[v["offset_launches"][nm] for nm in FLASH_NAMES]
              for v in run.values]
    want_offset = [[0] * 3, [attn * steps] * 3]
    kv = (spec.batch_size * T * cfg.attention.num_kv_heads * cfg.head_dim
          * 4) if attn else 0
    stats = collective_stats(
        k, rows=B, clients=m, group_bytes=[4 * task.layout.size],
        rounds=spec.rounds, sequence=(attn, s, kv),
        exchanges=sequence_exchanges(cfg, batch=spec.batch_size, seq_len=T,
                                     ranks=k))
    rows_d = (server_p - st_s.server).abs().amax(-1)
    gathers = [v["gathers"] for v in run.values]
    digests = [v["digest"] for v in run.values]
    peak = [v["peak_bytes"] for v in run.values]
    res = dict(_ranks_line(f"{label} make_2d_mesh(1, 2) on cuda:0", run),
               arch=spec.lm_arch, B=B, m=m, T=T, rank_T=T // k, layers=L,
               one_device_s=plain_s, seq_parallel_s=seq_s,
               max_server_diff=float(rows_d.max()),
               final_loss_one_device=out_p["metrics"]["loss"][:, -1].tolist(),
               final_loss_seq_parallel=out_s["metrics"]["loss"][:, -1].tolist(),
               one_device_launches=one_counts, launches=got,
               want_launches=want, offset_launches=offset,
               digests_equal=digests[0] == digests[1],
               seq_split=[v["seq_split"] for v in run.values],
               gathers=gathers, one_device_peak_bytes=one_peak,
               peak_bytes=peak,
               collective_stats=dict(bytes_by_kind=stats.bytes_by_kind,
                                     count_by_kind=stats.count_by_kind,
                                     t_collective_s=stats.t_collective))
    print(f"{label} ({spec.lm_arch}, d_model {spec.lm_d_model}, {L} layers "
          f"{kinds}) B = {B}, m = {m}, T = {T} split {T // k} a rank, "
          f"{spec.rounds} rounds: one device {plain_s:.3f} s (peak "
          f"{_gib(one_peak)} GiB), the sequence split {seq_s:.3f} s; largest "
          f"|server diff| of a trajectory {rows_d.max().item():.3e} (tol "
          f"{LM_PATHS_TOL:g}); final losses one device "
          f"{[round(x, 6) for x in res['final_loss_one_device']]}, split "
          f"{[round(x, 6) for x in res['final_loss_seq_parallel']]}; counts "
          f"by rank {got}, expected {want} each; flash at an offset "
          f"{offset}, expected {want_offset}; the ranks' digests "
          f"{'equal' if res['digests_equal'] else 'DIFFER'}; collectives "
          f"by rank {[(g['bytes_by_kind'], g['count_by_kind'], round(g['seconds'], 4)) for g in gathers]}, "
          f"counted {stats.bytes_by_kind} in {stats.count_by_kind} "
          f"({stats.t_collective * 1e3:.4f} ms at NVLink's 450 GB/s); peak "
          f"memory a rank {[_gib(x) for x in peak]} GiB", flush=True)
    if run.backend != "gloo" or len(run.values) != 2 \
            or not all(res["seq_split"]):
        fail(f"{label} ran {len(run.values)} ranks under {run.backend}, "
             f"split {res['seq_split']}")
    if not rows_d.max() <= LM_PATHS_TOL:
        fail(f"{label}: the sequence split and one device diverge")
    if not res["digests_equal"]:
        fail(f"{label}: the two model ranks' servers or outputs differ")
    if one_counts["plain_attention"] or one_counts["plain_wkv6"]:
        fail(f"{label}: one device took a plain version on the card "
             f"{one_counts}")
    if any(row != want for row in got) or offset != want_offset:
        fail(f"{label}: counts {got} (offset {offset}), expected {want} "
             f"({want_offset})")
    if any(g["bytes_by_kind"] != stats.bytes_by_kind
           or g["count_by_kind"] != stats.count_by_kind for g in gathers):
        fail(f"{label}: the collectives moved other bytes than "
             "collective_stats counts")
    del server_p, out_p, st_s, out_s, batch, task
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase25_seq_families(torch, rk, ref, grid, bw, fp32_peak):
    """The sequence split of the MoE, RWKV6 and hybrid families, and the
    WKV6 kernels' zero-padded head-dim route (``PHASE25_LIMIT_S``); see
    the constants above."""
    import dataclasses as dc
    import threading

    from repro_torch.configs import get_config, reduced
    from repro_torch.experiments import shard, sweep, tasks
    from repro_torch.launch.mesh import make_2d_mesh
    from repro_torch.sharding import pool

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    mesh = make_2d_mesh(1, 2, [card, card])
    start = threading.Thread(target=pool.pool_for, args=(mesh,), daemon=True)
    start.start()
    res = {}
    # (a) the pad route alone at head dims 16 and 32, then the rwkv6 LM
    # sweep at head dim 16 through it on one device against the plain path
    gen = torch.Generator(device=card).manual_seed(25)
    res["pad_route"] = {
        f"D={shape[3]}": _wkv_timed(torch, rk, ref, gen, shape,
                                    f"phase25a wkv6 pad route {list(shape)}",
                                    bw, fp32_peak)
        for shape in WKV_PAD_SHAPES}
    spec = grid.SweepSpec(**{**LM_SWEEP, "lm_arch": "rwkv6-3b"})
    one = _one_device_counted(torch, grid, spec)
    server_k, out_k, counts = one[:3]
    E = len(sweep.eval_rounds(spec.rounds, spec.eval_every))
    L, steps = spec.lm_layers, spec.local_steps * spec.rounds
    want = dict(dict.fromkeys(FLASH_NAMES + FLASH_WIDE_NAMES, 0),
                fused_masked_agg=spec.rounds,
                wkv6_fwd=L * (steps + E), wkv6_bwd=L * steps,
                wkv6_fwd_padded=L * (steps + E), wkv6_bwd_padded=L * steps,
                wkv6_fwd_blocked=0, wkv6_bwd_blocked=0,
                plain_attention=0, plain_wkv6=0)
    plain_task = tasks.make_traced_lm_task(
        data_seed=spec.data_seed, num_clients=spec.num_clients,
        arch=spec.lm_arch, d_model=spec.lm_d_model, layers=spec.lm_layers,
        seq_len=spec.lm_seq, classes=spec.classes, n_seqs=spec.lm_n_seqs,
        n_test=spec.lm_n_test, per_client=spec.per_client,
        local_steps=spec.local_steps, batch_size=spec.batch_size,
        device=card, backend="torch")
    server_p, out_p, counts_p = _one_device_counted(
        torch, grid, dc.replace(spec, use_kernel=False), task=plain_task)[:3]
    rows = (server_k - server_p).abs().amax(-1)
    res["a"] = dict(head_dim=16, seconds_kernel=one[3], counts=counts,
                    want_counts=want,
                    plain_path_counts=counts_p,
                    paths_max_row_diff=rows.max().item(),
                    final_loss=out_k["metrics"]["loss"][:, -1].tolist())
    print(f"phase25a rwkv6-3b LM sweep (d_model {spec.lm_d_model}: 4 heads "
          f"of 16, through the pad route to 64), {spec.rounds} rounds on one "
          f"device: {one[3]:.3f} s; counts {counts}, expected {want}; "
          f"against the plain path ({counts_p}): largest |server diff| of a "
          f"trajectory {rows.max().item():.3e} (tol {LM_PATHS_TOL:g})",
          flush=True)
    if counts != want:
        fail(f"phase25a: counts {counts}, expected {want}")
    if counts_p["wkv6_fwd"] or not counts_p["plain_wkv6"] \
            or not rows.max() <= LM_PATHS_TOL:
        fail("phase25a: the rwkv6 LM sweep's kernel and plain paths "
             "diverge, or the plain path launched WKV6")
    del server_p, out_p, plain_task
    res["a"]["seconds"] = time.perf_counter() - t_phase
    # (b) each family's lm-family cell split over the two ranks
    t0 = time.perf_counter()
    start.join(pool.START_TIMEOUT_S)
    res["pool_wait_s"] = time.perf_counter() - t0
    res["b"] = {}
    for arch in SEQ_FAMILY_ARCHS:
        at = grid.SweepSpec(**{**LM_SWEEP, "lm_arch": arch})
        res["b"][arch] = _seq_family_cell(
            torch, grid, shard, at, mesh, f"phase25b {arch}",
            one=one if arch == "rwkv6-3b" else None)
    del one, server_k, out_k
    # (c) lm-wide, one round, split; WKV6 at rank 1's local shape
    res["c"] = {}
    for arch in SEQ_FAMILY_WIDE_ARCHS:
        wide = grid.SweepSpec(**{**LM_SWEEP, **LM_WIDE, "lm_arch": arch,
                                 "rounds": SEQ_WIDE_ROUNDS,
                                 "eval_every": SEQ_WIDE_ROUNDS})
        res["c"][arch] = _seq_family_cell(torch, grid, shard, wide, mesh,
                                          f"phase25c {arch} lm-wide")
    pool.close_pools()
    # rank 1's time-mix call in 25c's rwkv6 cell: b rows, the B * m models'
    # heads folded into the head axis, half the sequence, head dim 128
    hd = reduced(get_config("rwkv6-3b"),
                 d_model=LM_WIDE["lm_d_model"]).rwkv.head_dim
    B = len(LM_SWEEP["algorithms"]) * len(LM_WIDE["lrs"]) * len(
        LM_SWEEP["seeds"])
    shape = (LM_SWEEP["batch_size"],
             B * LM_WIDE["num_clients"] * LM_WIDE["lm_d_model"] // hd,
             LM_WIDE["lm_seq"] // 2, hd)
    res["c"]["wkv6_rank_local"] = _wkv_timed(
        torch, rk, ref, gen, shape, f"phase25c wkv6 rank-local "
        f"{list(shape)} from a carried state", bw, fp32_peak)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase25 done in {res['seconds']:.1f} s (limit "
          f"{PHASE25_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE25_LIMIT_S:
        fail(f"phase 25 took {res['seconds']:.1f} s, over its "
             f"{PHASE25_LIMIT_S:g} s")
    return res


def phase26_wide_heads(torch, fa, rk, ref, grid, bw, fp32_peak, build_log):
    """The LM sweep at every width the reference runs: (a) the WKV6 block
    route and the flash kernels' wide-head route checked against their
    plain versions and timed (the wide kernels' registers and spills from
    ``build_log``, their library's report); (b) lm-family through them at
    ``LM_WIDE_HEADS`` against the plain path (``PHASE26_LIMIT_S``); see
    the constants above."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.experiments import sweep, tasks

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    gen = torch.Generator(device=card).manual_seed(26)
    print_ptxas("phase26a", build_log)
    res = {"wkv6_blocked": {}, "flash_wide": {}, "b": {},
           "ptxas": {k: v for (k, _), v in ptxas_table(build_log).items()}}
    # (a) the WKV6 block route, from a carried state
    for shape in WIDE_WKV_SHAPES:
        label = f"phase26a wkv6 block route {list(shape)}"
        res["wkv6_blocked"]["x".join(map(str, shape))] = _wkv_timed(
            torch, rk, ref, gen, shape, label, bw, fp32_peak)
    # (a) the wide-head flash kernels, through flash_attention's routing
    fns = [getattr(fa, n) for n in FLASH_WIDE_NAMES + FLASH_NAMES]
    for bh, t, d in WIDE_FLASH_SHAPES:
        before = [f.launches for f in fns]
        errs = check_flash_shape(torch, fa, ref, gen,
                                 (bh, 1, t, d, 0, 0.0, "float32", True),
                                 "phase26a")
        got = [f.launches - n for f, n in zip(fns, before)]
        if got != [1, 1, 1, 0, 0, 0]:
            fail(f"phase26a: flash_attention at D = {d} launched {got} "
                 f"(wide fwd, dq, dkdv, then the aligned three)")
        timed = flash_timing(torch, fa, ref, gen, bh, t, d, "float32", bw,
                             fp32_peak, "phase26a", wide=True)
        for kk, r in timed.items():
            r["max_abs_err"] = (errs["o"] if kk == "fwd" else errs["dq"]
                                if kk == "dq" else max(errs["dk"],
                                                       errs["dv"]))
        res["flash_wide"][f"D={d}"] = timed
    res["a_seconds"] = time.perf_counter() - t_phase
    print(f"phase26a done at {res['a_seconds']:.1f} s", flush=True)
    # (b) lm-family through the routes at each width, against the plain
    # path from the same generators
    for arch, d_model in LM_WIDE_HEADS:
        spec = grid.SweepSpec(**{**LM_SWEEP, **LM_WIDE_HEADS_CUT,
                                 "lm_arch": arch, "lm_d_model": d_model})
        cfg = reduced(get_config(arch), d_model=d_model,
                      layers=spec.lm_layers)
        kinds = [cfg.layer_kind(i) for i in range(spec.lm_layers)]
        attn, rwkv = kinds.count("attn"), kinds.count("rwkv")
        server_k, out_k, counts, sec, peak = _one_device_counted(
            torch, grid, spec)[:5]
        E = len(sweep.eval_rounds(spec.rounds, spec.eval_every))
        steps = spec.local_steps * spec.rounds
        want = dict(dict.fromkeys(FLASH_NAMES, 0),
                    **dict(zip(FLASH_WIDE_NAMES, (attn * (steps + E),
                                                  attn * steps,
                                                  attn * steps))),
                    fused_masked_agg=spec.rounds,
                    wkv6_fwd=rwkv * (steps + E), wkv6_bwd=rwkv * steps,
                    wkv6_fwd_padded=0, wkv6_bwd_padded=0,
                    wkv6_fwd_blocked=rwkv * (steps + E),
                    wkv6_bwd_blocked=rwkv * steps,
                    plain_attention=0, plain_wkv6=0)
        plain_task = tasks.make_traced_lm_task(
            data_seed=spec.data_seed, num_clients=spec.num_clients,
            arch=arch, d_model=d_model, layers=spec.lm_layers,
            seq_len=spec.lm_seq, classes=spec.classes,
            n_seqs=spec.lm_n_seqs, n_test=spec.lm_n_test,
            per_client=spec.per_client, local_steps=spec.local_steps,
            batch_size=spec.batch_size, device=card, backend="torch")
        server_p, out_p, counts_p, sec_p, peak_p = _one_device_counted(
            torch, grid, dataclasses.replace(spec, use_kernel=False),
            task=plain_task)[:5]
        rows = (server_k - server_p).abs().amax(-1)
        heads = {"attention": cfg.head_dim if attn else None,
                 "wkv6": cfg.rwkv.head_dim if rwkv else None}
        loss = out_k["metrics"]["loss"]
        row = dict(arch=arch, d_model=d_model, head_dims=heads, kinds=kinds,
                   B=len(spec.algorithms) * len(spec.lrs), m=spec.num_clients,
                   rounds=spec.rounds, seconds_kernel=sec, seconds_plain=sec_p,
                   peak_gib=peak / 2 ** 30, plain_peak_gib=peak_p / 2 ** 30,
                   counts=counts, want_counts=want, plain_path_counts=counts_p,
                   paths_max_row_diff=rows.max().item(),
                   final_loss=loss[:, -1].tolist())
        res["b"][arch] = row
        print(f"phase26b {arch} LM sweep (d_model {d_model}: {kinds}, head "
              f"dims {heads}), {spec.rounds} rounds on one device: kernels "
              f"{sec:.3f} s (peak {row['peak_gib']:.3f} GiB), plain path "
              f"{sec_p:.3f} s (peak {row['plain_peak_gib']:.3f} GiB); counts "
              f"{counts}, expected {want}; plain path {counts_p}; largest "
              f"|server diff| of a trajectory {rows.max().item():.3e} (tol "
              f"{LM_PATHS_TOL:g})", flush=True)
        if counts != want:
            fail(f"phase26b {arch}: counts {counts}, expected {want}")
        if any(counts_p[k] for k in FLASH_NAMES + FLASH_WIDE_NAMES
               + ("fused_masked_agg", "wkv6_fwd", "wkv6_bwd")) \
                or not counts_p["plain_attention"] + counts_p["plain_wkv6"]:
            fail(f"phase26b {arch}: the plain path launched a kernel or "
                 f"took no plain version ({counts_p})")
        if not (torch.isfinite(loss).all()
                and torch.isfinite(server_k).all()):
            fail(f"phase26b {arch}: a non-finite loss or parameter")
        if not rows.max() <= LM_PATHS_TOL:
            fail(f"phase26b {arch}: the kernel and plain paths diverge")
        if max(row["peak_gib"], row["plain_peak_gib"]) > WIDE_HEADS_PEAK_GIB:
            fail(f"phase26b {arch}: peak memory over "
                 f"{WIDE_HEADS_PEAK_GIB:g} GiB")
        del server_k, out_k, server_p, out_p, plain_task
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase26 done in {res['seconds']:.1f} s (limit "
          f"{PHASE26_LIMIT_S:g} s)", flush=True)
    if res["seconds"] > PHASE26_LIMIT_S:
        fail(f"phase 26 took {res['seconds']:.1f} s, over its "
             f"{PHASE26_LIMIT_S:g} s")
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
    from repro_torch.launch.roofline import peak_rates

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)
    bw, fp32_peak, bf16_peak = peak_rates(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    # the CUDA sources build (one nvcc each, the flash kernels' two routes
    # apart) while phase 1 builds the Triton kernel
    sources = [fa.SOURCE, fa.OFFSET_SOURCE, fa.WIDE_SOURCE, rk.SOURCE,
               rk.BWD_SOURCE]
    with ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(build.compile_all, sources)
        k = phase1_kernel(torch, masked, ref)
        logs = nvcc.result()
    print(f"nvcc builds of {', '.join(x.name for x in sources)} (in "
          f"parallel, beside phase 1) done at "
          f"{time.perf_counter() - t0:.1f} s; "
          + "; ".join(log.splitlines()[0] for log in logs.values()),
          flush=True)
    spec, launches, rounds_per_s = phase2_main_path(torch, masked, grid)
    phase3_paths_agree(torch, grid, spec)
    f = phase4_flash(torch, fa, ref, bw, bf16_peak, fp32_peak,
                     logs[fa.SOURCE.name] + logs[fa.OFFSET_SOURCE.name])
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
    mem_zoo = phase16_zoo(torch, fa, ref, card, bw, bf16_peak, fp32_peak)
    train_zoo = phase17_train_zoo(torch, fa, masked, ref, train, card, bw,
                                  bf16_peak, fp32_peak)
    launch = phase18_launch(torch, fa, masked, ref, train, card, lm,
                            bf16_peak)
    rwkv_train = phase19_rwkv_train(torch, rk, masked, ref, train, card, bw,
                                    fp32_peak, logs[rk.BWD_SOURCE.name])
    sharded = phase20_sharded(torch, masked, fa, grid)
    suites = phase21_suites(torch, masked, fa, rk, ref, bw, fp32_peak,
                            launch["dryrun"]["row"])
    analysis = phase22_analysis(torch, masked, fa, grid)
    meshes = phase23_meshes(torch, fa)
    seq = phase24_seq_parallel(torch, fa, ref, grid, bw, fp32_peak,
                               bf16_peak)
    fam = phase25_seq_families(torch, rk, ref, grid, bw, fp32_peak)
    wide_heads = phase26_wide_heads(torch, fa, rk, ref, grid, bw, fp32_peak,
                                    logs[fa.WIDE_SOURCE.name])
    sl = suites["launches"]
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
              "lm_sweep_shapes": lm_sweep["kernels"]["fused_masked_agg"],
              "train_zoo_launches": train_zoo["seamless-m4t-medium"][
                  "agg_launches"],
              "train_zoo_shapes": train_zoo["kernels"]["agg"],
              "ckpt_resume_launches": {
                  k: launch[k]["launches"][3]
                  for k in ("smollm", "jamba_groups")},
              "masked_agg_pytree_launches": launch["ops"][
                  "masked_agg_pytree_launches"],
              # by rank, in the workers of phase 20's sub-phases
              "sharded_launches": {
                  "20a": sharded["a"]["agg_launches"],
                  "20b": sharded["b"]["agg_launches"],
                  "20c": [r[3] for r in sharded["c"]["launches"]]},
              # phase 21: by suite, and the kernels suite's shapes timed
              "suite_launches": {k: v["fused_masked_agg"]
                                 for k, v in sl.items()},
              "kernels_suite_shapes": {
                  **suites["kernels"]["batched_agg"],
                  "masked_agg_64x65536": suites["kernels"]["masked_agg"]},
              # phase 22: the census's sweep (one a round) and the pins
              "analysis_launches": {
                  "22a": analysis["sweep"]["agg_launches"],
                  "22c": analysis["pins"]["agg_launches"]}}
    # phase 24: by rank, in its sequence-split cells
    kernel["seq_parallel_launches"] = {
        f"24{c}": [r[3] for r in seq[c]["launches"]] for c in ("a", "b")}
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
                   for a, _ in MOE_CASES},
                **{f"seamless-m4t-medium_{part}":
                   mem_zoo["seamless-m4t-medium"][part]["flash_launches"][i]
                   for part in ("serve", "forward")},
                **{f"{a}_{part}": mem_zoo[a][part]["flash_launches"][i]
                   for a, _, _ in MEMORY_CASES
                   for part in ("prefill", "decode")}})
    kernels[1]["zoo_shapes"] = mem_zoo["flash"]
    for i, (key, name) in enumerate(zip(("fwd", "dq", "dkdv"), FLASH_NAMES)):
        kernels[1 + i]["train_zoo_launches"] = \
            train_zoo["seamless-m4t-medium"]["flash_launches"][name]
        kernels[1 + i]["train_zoo_shapes"] = {
            sh: v[key] for sh, v in train_zoo["kernels"]["flash"].items()}
    for i in range(3):
        kernels[1 + i]["ckpt_resume_launches"] = {
            k: launch[k]["launches"][i] for k in ("smollm", "jamba_groups")}
        kernels[1 + i]["sharded_launches"] = {
            "20c": [r[i] for r in sharded["c"]["launches"]]}
        kernels[1 + i]["suite_launches"] = {
            k: v[FLASH_NAMES[i]] for k, v in sl.items()}
    kernels[1]["kernels_suite_shapes"] = {
        "flash_attention_512": suites["kernels"]["flash_fwd"]}
    for i in range(3):
        # phase 22b's serve runs: decode_step attends without a kernel
        kernels[1 + i]["analysis_launches"] = {
            f"22b_{k}": v["flash_launches"][i]
            for k, v in analysis["serve"].items()}
    kernels[1]["gqa_launches"] = launch["ops"]["gqa_launches"]
    # phase 23b: rank 0 of the 16x16 prefill, one step
    kernels[1]["mesh_rank0_launches"] = meshes["rank0"]["launches"]
    kernels[1]["mesh_rank0_shapes"] = meshes["rank0"]["flash_shapes"]
    kernels[1]["mesh_rank0_max_abs_err"] = meshes["rank0"]["max_abs_err"]
    for i, key in enumerate(("fwd", "dq", "dkdv")):
        # phase 24: by rank, all launches and those at an offset (rank 1's
        # training), and the offset route's timings beside its twins
        kernels[1 + i]["seq_parallel_launches"] = {
            f"24{c}{part}": [r[i] for r in seq[c][f]]
            for c in ("a", "b") for part, f in (("", "launches"),
                                                ("_offset",
                                                 "offset_launches"))}
        kernels[1 + i]["seq_parallel_shapes"] = {
            sh: v[key] for sh, v in seq["c"]["timed"].items()}
        kernels[1 + i]["seq_parallel_max_abs_err"] = {
            sh: (e["o"] if key == "fwd" else e["dq"] if key == "dq"
                 else max(e["dk"], e["dv"]))
            for sh, e in seq["c"]["max_abs_err"].items()}
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
    kernels[-2]["train_launches"] = {
        k2: v["wkv6_launches"]["chunked"] if k2 == "rwkv6-3b" else
        v["wkv6_launches_per_direction"]
        for k2, v in (("rwkv6-3b", rwkv_train["rwkv6-3b"]),
                      ("reduced_float32", rwkv_train["reduced"]["float32"]),
                      ("reduced_bfloat16",
                       rwkv_train["reduced"]["bfloat16"]))}
    kernels[-1]["crossover_ms"] = wkv["crossover_ms"]
    kernels[-2]["suite_launches"] = {k: v["wkv6_chunked"]
                                     for k, v in sl.items()}
    kernels[-2]["kernels_suite_shapes"] = {
        "rwkv6_chunk_256": suites["kernels"]["wkv6_chunked"]}
    kernels[-1]["suite_launches"] = {k: v["wkv6_step"]
                                     for k, v in sl.items()}
    r = rwkv_train["backward"]
    kernels.append({
        "name": "rwkv6_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_chunk_bwd.cu",
        "replaces": replaces + "; its VJP, which the TPU kernel lacks: "
                    "wkv6_bwd_state, wkv6_bwd_chunk)",
        "launches": rwkv_train["rwkv6-3b"]["wkv6_launches"]["backward"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "flops": r["flops"],
        "bytes": r["bytes"], "shape": r["shape"],
        "suite_launches": {k: v["wkv6_backward"] for k, v in sl.items()},
        "bound_tc_ms": r["bound_tc_ms"],
        "forward_ms": r["forward_ms"], "ptxas_by_head_dim": r["ptxas"],
        "reduced_launches": {
            dt: rwkv_train["reduced"][dt]["wkv6_launches_per_direction"]
            for dt in ("float32", "bfloat16")}})
    # phase 25: the sequence split of the other families, by cell and rank
    cells25 = {f"25{c}_{arch}": cell for c in ("b", "c")
               for arch, cell in fam[c].items() if arch in SEQ_FAMILY_ARCHS}
    kernel["seq_family_launches"] = {
        key: [r["fused_masked_agg"] for r in cell["launches"]]
        for key, cell in cells25.items()}
    for i, name in enumerate(FLASH_NAMES):
        kernels[1 + i]["seq_family_launches"] = {
            f"{key}{part}": [r[name] if part == "" else o[i]
                             for r, o in zip(cell["launches"],
                                             cell["offset_launches"])]
            for key, cell in cells25.items() for part in ("", "_offset")}
    by_name = {k2["name"]: k2 for k2 in kernels}
    wide = fam["c"]["wkv6_rank_local"]
    for name, count, key in (("rwkv6_chunk_fwd", "wkv6_fwd", ""),
                             ("rwkv6_chunk_bwd", "wkv6_bwd", "backward_")):
        by_name[name]["seq_family_launches"] = dict(
            {"25a": fam["a"]["counts"][count]},
            **{k2: [r[count] for r in cell["launches"]]
               for k2, cell in cells25.items()})
        # rank 1's local call in 25c's rwkv6 cell, from a carried state
        by_name[name]["seq_wide_shape"] = {
            "shape": wide["shape"], "ms": wide[f"{key}ms"],
            "plain_ms": wide[f"plain_{key}ms"],
            "bound_ms": wide[f"{key}bound_ms"],
            "bound_by": wide[f"{key}bound_by"],
            "max_abs_err": wide["max_abs_err"]}
    pad = fam["pad_route"]
    kernels.append({
        "name": "rwkv6_chunk_padded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
        "replaces": replaces + "; at a head dim below 64 or between 64 and "
                    "128: the inputs zero-padded to the kernels' next head "
                    "dim, the outputs sliced back)",
        "launches": fam["a"]["counts"]["wkv6_fwd_padded"],
        "max_abs_err": max(r["max_abs_err"] for r in pad.values()),
        "ms": pad["D=16"]["ms"], "plain_ms": pad["D=16"]["plain_ms"],
        "bound_ms": pad["D=16"]["bound_ms"],
        "bound_by": pad["D=16"]["bound_by"], "library_ms": None,
        "shape": pad["D=16"]["shape"],
        "backward_launches": fam["a"]["counts"]["wkv6_bwd_padded"],
        "backward_ms": pad["D=16"]["backward_ms"],
        "plain_backward_ms": pad["D=16"]["plain_backward_ms"],
        "backward_bound_ms": pad["D=16"]["backward_bound_ms"],
        "by_head_dim": pad,
        "seq_family_launches": {
            k2: [[r["wkv6_fwd_padded"], r["wkv6_bwd_padded"]]
                 for r in cell["launches"]]
            for k2, cell in cells25.items()}})
    # phase 26: the wide-head flash kernels and the WKV6 block route,
    # launched in 26b's runs and timed at 26b's launch shapes (and by
    # shape)
    b26 = wide_heads["b"]
    for i, (key, name) in enumerate(zip(("fwd", "dq", "dkdv"),
                                        FLASH_WIDE_NAMES)):
        timed = wide_heads["flash_wide"]
        r = timed[f"D={WIDE_FLASH_SHAPES[0][2]}"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_wide.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76 "
                        "(flash_attention -> _kernel, fp32 above head dim "
                        "256" + ("" if key == "fwd" else
                                 "; its VJP, which the TPU kernel lacks: "
                                 + ("delta and dQ" if key == "dq"
                                    else "dK and dV")) + ")",
            "launches": b26["smollm-135m"]["counts"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "sdpa_backend": r["sdpa_backend"], "flops": r["flops"],
            "bytes": r["bytes"], "shape": r["shape"],
            "by_head_dim": {dd: v[key] for dd, v in timed.items()},
            **wide_heads["ptxas"].get(f"flash_wide_{key}", {}),
            "lm_sweep_launches": {
                arch: row["counts"][name] for arch, row in b26.items()}})
    blk = wide_heads["wkv6_blocked"]
    first = blk["x".join(map(str, WIDE_WKV_SHAPES[0]))]
    kernels.append({
        "name": "rwkv6_chunk_blocked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
        "replaces": replaces + "; at a head dim above 128: the (key block, "
                    "value block) pairs of BLOCK_DIM folded into the head "
                    "axis, one call of the kernels, o summed over the key "
                    "blocks)",
        "launches": b26["rwkv6-3b"]["counts"]["wkv6_fwd_blocked"],
        "max_abs_err": max(r2["max_abs_err"] for r2 in blk.values()),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None, "shape": first["shape"],
        "block_dim": rk.BLOCK_DIM,
        "backward_launches": b26["rwkv6-3b"]["counts"]["wkv6_bwd_blocked"],
        "backward_ms": first["backward_ms"],
        "plain_backward_ms": first["plain_backward_ms"],
        "backward_bound_ms": first["backward_bound_ms"],
        "by_shape": blk})
    print(json.dumps({"paper": paper}), flush=True)
    print(json.dumps({"scale": scale}), flush=True)
    print(json.dumps({"search": found}), flush=True)
    print(json.dumps({"lm_sweep": {k2: v for k2, v in lm_sweep.items()
                                   if k2 != "kernels"}}), flush=True)
    print(json.dumps({"serve": dense}), flush=True)
    print(json.dumps({"launch": launch}), flush=True)
    print(json.dumps({"rwkv_train": {k2: v for k2, v in rwkv_train.items()
                                     if k2 != "backward"}}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"suites": suites["bench"]}), flush=True)
    print(json.dumps({"phase21": {k: v for k, v in suites.items()
                                  if k != "bench"}}), flush=True)
    print(json.dumps({"zoo": {
        "gemma2-9b": gemma, "moe": moe,
        "memory_families": {k: v for k, v in mem_zoo.items()
                            if k != "flash"},
        "training": {k: v for k, v in train_zoo.items()
                     if k != "kernels"}}}), flush=True)
    print(json.dumps({"analysis": analysis}), flush=True)
    print(json.dumps({"meshes": meshes}), flush=True)
    print(json.dumps({"seq_parallel": {k2: v for k2, v in seq.items()
                                       if k2 != "c"}}), flush=True)
    print(json.dumps({"seq_families": fam}), flush=True)
    print(json.dumps({"wide_heads": wide_heads}), flush=True)
    print(f"# total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
