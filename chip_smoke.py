#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure ends the run with a non-zero exit:

1. device  — the card's name, count, power limit and SM clock (fails
   without CUDA);
2. build   — the CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
   with ptxas' registers and spills;
3. kernels — each kernel against its plain PyTorch version on the card:
   bitwise on dyadic data, within a stated tolerance on Gaussian data;
   the sketch kernels bitwise on any items (integer counts), Count-Min
   also on views that start off 16 bytes, on one hot key, past shared
   memory, and grouped with shuffled blocks;
4. main path, on a 10,000,000-row table made on the card from a seed
   (``x`` 160 f32 variables, ``y``, 64 groups ``g``, and an int32
   ``item`` column drawn Zipf(1.1) over 1,000,000 keys), through the
   kernels (launch counters and trace events checked):
   a. ``linregr`` and ``linregr_grouped``, against the plain versions;
   b. one ``Session`` batch of the analytics mix (``profile`` with
      distinct counts, ``linregr``, Count-Min, FM), planned as ONE scan
      through ``xtx``, ``countmin`` and ``column_stats`` (one a numeric
      column), against the statements run solo on the plain versions;
   c. ``countmin_sketch_grouped`` and ``fm_distinct_count_grouped``
      through ``segment_countmin`` and ``segment_fm``, fold states
      against the plain versions;
   d. the card against the CPU port on a small input; then the grouped
      OLS statement's stages timed one by one;
   e. k-means on a 10,000,000 x 32 blobs table (64 true centers), made on
      the card from the seed: ``kmeans_fit`` (k = 64, k-means++) through
      ``kmeans_assign`` against the same fit on the plain version, the
      two-pass variant at 1,000,000 rows, ``kmeans_grouped`` (G = 64,
      k = 8), seconds per fit and per round and the kernel's share;
   f. logistic regression (IRLS) over the 10M x 160 ``x`` with a 0/1
      label drawn from sigmoid(x b): ``logregr`` against the same IRLS in
      float64 on the card, and ``logregr_grouped`` (G = 64); then the
      fits' states on a small input against the CPU port;
5. timing  — CUDA-event times of each kernel (and its device time from
   torch.profiler), its plain version and the library call at the main
   path's shapes, beside the bound; the two Count-Min kernels also with
   the L2 flushed before each launch, and countmin beside torch.bincount
   over the precomputed buckets (a point of reference); ``column_stats``
   on the main path's ``x`` and ``y`` bitwise its plain version first;
h. then, with the tables of a-f dropped but for the Zipf ``item`` column,
   the analytics server on a dyadic 10M x 160 table (``x``, ``y``,
   ``item``, 64 groups ``g``): 8 analyst sessions on threads against one
   ``AnalyticsServer(drain="thread", window_timeout=0.05)``, 4 rounds of
   profile, linregr, Count-Min and FM through ``xtx`` and ``countmin``,
   100,000 dyadic rows appended after round 2: one scan per drained
   window, each statement planned once per table version, the rounds on
   an unchanged version answered from the cache, every answer bitwise
   equal to a local ``Session`` run, an in-place edit of one answer
   reaching no other; a living ``linregr_grouped`` view (G = 64)
   registered with the server, answered after the append by a delta fold
   through ``segment_linregr`` whose fold state equals a full rescan
   bitwise; a star join of the table (1% dangling foreign keys) with a
   100,000-row dimension: two joined statements in one batch share one
   resolution and one fact-side sort, ``linregr_joined`` equals gathering
   the attribute by hand (fold states bitwise), ``on_missing="error"``
   names the dangling count; each member of the joined batch runs its
   own segment kernel (``segment_linregr``, ``segment_countmin``) over
   the shared layout.  Each kernel is held against its plain version at
   every shape the phase gives it (the appended table, the delta, the
   joined layout).  Each number is printed beside the card's name and
   power limit; only the main-path steps' launches (the view's build and
   delta answer, the rounds, the joined batch, ``linregr_joined``) count
   in the kernels line, by step under ``launches_by_shape``;
i. then, from pinned host copies of section h's first 10,000,000 rows
   (``x``, ``y``, ``item``: 6.48 GB), section e's blobs and section f's
   label, the stream engine: the copy bound (one pass host -> device
   alone, pinned and pageable, GB/s beside the PCIe link); one
   ``Session`` of three stream statements (linregr, Count-Min, FM) over
   one iterator of 1,048,576-row blocks (a ragged tail of 562,816 rows):
   one scan, ``xtx`` and ``countmin`` once per block, results bitwise
   equal to the resident batch, peak device memory within one
   transition's plus two blocks; the device's busy share and the H2D
   time that overlaps a kernel (torch.profiler); ``profile_stream``
   against ``profile``; producers that reuse one numpy buffer or one
   pinned tensor; ``xtx`` and ``countmin`` at the block shapes against
   their plain versions; ``logregr_stream`` and a k-means ``fit_stream``
   in 1,000,000-row blocks against the resident fits at that block size
   (equal rounds, k-means bitwise, ``kmeans_assign`` launches equal);
   each stream statement's seconds, GB/s and share of the pinned copy
   rate beside the resident statement's seconds;
j. then the measured calibration on the card:
   ``repro_torch.launch.calibrate`` in-process over rows {2^20, 2^22,
   10,000,000} x groups {8, 64, 1024}, segment blocks 64 to 4096, 3
   reps, through ``xtx``, ``segment_linregr``, ``countmin`` and
   ``segment_countmin`` (K = 8, Count-Min 4 x 128), each bucket's
   measured best block printed beside the heuristic's; under that
   calibration ``explain()`` of ``linregr_grouped`` reads ``[measured
   cuda@...]``, ``segment_block_size`` returns the measured best, and
   ``linregr_grouped`` on section h's dyadic 10M x 160 table (G = 64)
   folds bitwise as under the heuristic block, timed under both, and
   once as the planner runs it under the calibration; the four kernels
   bitwise against their plain versions on dyadic data (``xtx`` and
   ``countmin`` at 10^7 rows, the segment kernels at 2^20 rows, every
   group count and block size).  The masked cells above 64 groups are
   timed over 64 group passes and scaled.  Each bucket's grouped method
   (segment or masked) under the heuristic and under the calibration is
   printed beside the measured seconds, and which ones changed.  Then the methods of MADlib's Table 1 that
   the tenth slice ports, at full size on tables made on the card from
   the seed, each statement's first and repeated seconds printed:
   ``naive_bayes_fit`` (10 classes) on that table, its fold state
   bitwise a float64 fold, and ``naive_bayes_grouped`` (each group
   bitwise its solo fit); ``quantiles`` of a Zipf and a Gaussian column
   (histograms equal to ``torch.bincount``, each quantile within
   range/bins of ``torch.quantile``) and ``quantiles_grouped`` (one
   sort); ``decision_tree_fit`` on 10M x 32 blobs (depth 4, 32 bins;
   split counts sum to rows x features at every level, the tree on a
   1,000,000-row prefix equal on the card and the CPU); ``svd_power``
   and ``svd_randomized`` (k = 10) of a 10M x 160 matrix with a decaying
   spectrum against the float64 Gram's singular values; ``lda_fit`` on
   100,000 documents x 4,096 words (20 topics, 5 rounds: the bound rises
   every round; the E-step on 2,000 documents against the CPU);
   ``apriori`` on 10M x 32 transactions with planted rules (supports
   equal to direct counts); ``approx_match`` over 1,000,000 strings
   (the index bitwise the CPU's on a 10,000-string prefix, the planted
   near-duplicate ranked first);
k. then the convex layer at the main width (section k's docstring), and
   ``xtx`` at K = 1 to 320 on 10^7 dyadic rows: the path ``xtx_xty``
   takes (the narrow kernel up to ``K_NARROW``, the wide one past it)
   and the other path where it exists, both bitwise the plain version
   and bitwise symmetric, timed beside ``torch.matmul(x.T, x)`` and the
   bound; a K = 10 view 4 bytes off 16 on both paths; at K = 8 on
   Gaussian data the narrow kernel no farther from a float64 sum than
   the plain version;
g. then, with the analytics tables dropped, the LM serving path:
   the flash_attention kernels against their plain version, each call
   held to the kernel the wrapper must pick (f32 at the reference's test
   shapes and a ragged S through the FFMA kernel; bf16 at every D of the
   repo's configs, at section l's layer shapes and at qwen3-8b's layer
   shape through the tensor-core
   kernel, bf16 with D % 8 != 0 through the FFMA kernel; causality in
   both); the prefill forward of qwen3-8b at full width and depth (bf16,
   weights drawn on the card from a seed, 2 x 4096 tokens) through the
   tensor-core kernel, one launch per layer, against the
   ``use_flash=False`` path; the f32 forward at full depth through the
   FFMA kernel; two full-width layers in f32, where the two agree within
   1e-3 and teacher-forced decode reproduces the forward;
   ``serve("qwen3-8b", reduced=False)``; the kernel's timing at
   (2, 32, 8, 4096, 128) and at prefill_32k's (1, 32, 8, 32768, 128)
   beside its bound, the FFMA kernel on the same inputs, the plain
   version and scaled_dot_product_attention;
l. then, with section g's models freed, the other LM families at full
   width and depth in bf16, weights drawn on the card from a seed:
   moonshot-v1-16b-a3b (MoE, 48 layers, 28.1 B parameters),
   recurrentgemma-2b (RG-LRU hybrid), qwen2-vl-2b (256 stub patch
   embeddings of a 16 x 16 grid, 3,840 tokens, M-RoPE positions),
   hubert-xlarge ((2, 4096, 1280) frame embeddings, non-causal) and
   xlstm-350m: each a prefill of (2, 4096) with its time and tokens/s;
   the flash families with one tensor-core launch per attention layer
   (48, 28, 48) against ``use_flash=False`` (the MoE also bit for bit
   against a second forward, and on its first layer, with its agreement
   by depth printed); teacher-forced decode against forward over 64
   tokens for the hybrid, xLSTM and vlm, in bf16 and in f32;
   ``serve(arch, reduced=False)`` for each decoder; one layer of the
   MoE, RG-LRU and sLSTM timed alone; the kernel at the three flash
   families' layer shapes (D = 80 non-causal among them) beside its
   bound, its plain version and scaled_dot_product_attention.  dbrx-132b
   (263 GB of bf16) does not fit one card and is not run;
m. then, with section l's models freed, LM training: the flash_attention
   backward (bf16: the tensor-core kernels of
   ``csrc/flash_attention_bwd_tc.cu``; f32: the FFMA kernels of
   ``csrc/flash_attention_bwd.cu``; the path of each shape printed and
   checked by the counters) and the forward kernel against their plain
   versions at stablelm-1.6b's, qwen3-8b's and hubert-xlarge's layer
   shapes, a ragged S at D = 16 and stablelm's layer at launch.train's
   8 x 128, in f32 and bf16: the forward's log-sum-exp against the plain
   ``logsumexp`` and its output bitwise the output without it, a second
   backward call bitwise the first, timed beside its bound, the plain
   version and scaled_dot_product_attention's backward; stablelm-1.6b at
   full width and depth in bf16 (weights from a seed, f32 AdamW
   moments): the flash path against ``use_flash=False`` on one
   micro-batch (loss, per-leaf gradient cosine), then 4 steps of
   ``make_train_step(grad_accum=4)`` on 8 x 4096 tokens a step from
   ``TokenStream`` through ``make_lm_batches`` (the main path: step
   seconds, tokens/s, peak memory, loss, grad norm and lr, 96 backward
   launches a step, all on the tensor cores, and 192 forward flash
   launches under remat), the same check at the weights the steps
   left, and the same 4 steps from the same weights with
   ``use_flash=False`` (the losses side by side); two f32 layers at full
   width against ``use_flash=False``; ``python -m
   repro_torch.launch.train --arch
   stablelm-1.6b --full --steps 4`` in-process (its corpus profile through
   ``countmin``); a checkpoint round trip and a resume at the reduced
   config under ``build/``;
n. then, with section m's model freed, the sharded engine on one card:
   section h's dyadic 10M x 160 table (``x``, ``y``, a Zipf ``item``,
   64 groups ``g``) and section e's blobs, made on the card from the
   seed and distributed over meshes of 1, 8 and 24 segments of
   ``cuda:0`` (24 after ``pad_to(10_000_008)``, with its mask):
   ``linregr`` and ``linregr_grouped`` (fold states), one ``Session``
   batch of profile, linregr, Count-Min and FM (one planned scan,
   sharded where the cost model picks it: at 8 and 24 segments), the
   grouped Count-Min and FM, and ``kmeans_fit`` (k = 64, from k-means++
   seeds) through the sharded engines; each fold state bitwise the
   local engine's on the same table, k-means with equal rounds and
   within section e's tolerance or the fit's own (at most 0.1% of the
   rows assigned apart, SSE within 1e-5), each kernel launched once per
   segment per pass; xtx, countmin and kmeans_assign against their plain
   versions on segment 1's views (4 mod 16 bytes in); seconds of each
   statement on both engines beside the card's name and power limit;
o. then, with section n's tables freed, the LM's distribution on meshes
   whose positions all are ``cuda:0``: stablelm-1.6b at full width and
   depth (bf16, f32 AdamW) through ``jit_train_step`` over (data, model)
   = (2, 2), each data shard folding 2 micro-batches of (2, 4096), against
   the unsharded ``grad_accum=4`` step (loss within 1e-6 relative, every
   gradient element within 1e-5 of its leaf's max, beside the readings of
   two planted merge faults; bitwise on a repeat; the flash launches a
   step section m's), 3 steps timed (seconds, tokens/s, peak);
   ``compressed_psum`` of the two shards' gradients (every leaf's int8
   mean within 3 scales of the f32 mean; int8 bytes against f32); GPipe
   of the trained weights' 24 blocks in 4 stages over pod = 4 with 8
   micro-batches of (1, 4096), bitwise the sequential run, beside
   ``bubble_fraction(4, 8)``; section m's ``launch.train --full`` run,
   which went through the one-shard mesh of this card, bitwise the
   launcher with the plain step; split-K decode attention at qwen3-8b's
   decode shape (B = 4, 32 on 8 heads of 128, a 4,096-position bf16 cache
   over model = 4, ragged positions) within 1e-5 of the unsharded softmax
   in f32, timed beside it; the caches' shardings from
   ``decode_state_axes`` split their positions as split-K's shards do,
   and 16 decode steps of qwen3-8b under the mesh, bitwise the plain
   decode;
   moonshot-v1-16b-a3b's all-to-all MoE over model = 4: at depth 2 in f32
   with capacity_factor = E / k within 1e-4 of the gather MoE with nothing
   dropped, at full depth in bf16 its forward timed beside the gather
   MoE's, both ``drop_frac`` printed, bitwise on a repeat;
p. then, with section o's models freed, the dry run
   (``repro_torch.launch.dryrun``, meta tensors, no card): p1 one cell
   per (family, kind) on the 16 x 16 and 2 x 16 x 16 production meshes
   (fits, GB a device, dominant roofline term, trace seconds;
   xlstm-350m's train and prefill cells, minutes of sLSTM steps on meta,
   are left to ``--all``); p2 stablelm-1.6b's train step (8 x 4096, 4
   micro-batches) and p3 qwen3-8b's prefill at (2, 4096) on a
   one-position mesh, the dry run held against the same step on the
   card: argument bytes against ``memory_allocated`` of the real state
   and batch (within 1%), the meta dot flops equal to the op counter's
   count of one real step (the flash kernels record their cost; the
   kernels' costs equal too), temp bytes against
   ``max_memory_allocated`` less the arguments (within 10%); MFU from a
   step timed without the counter, beside the card's name and power
   limit.

The last line is ``{"ok": true, "device": {...}}``.  Imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20121208
N_MAIN, K_MAIN, G_MAIN = 10_000_000, 160, 64
ZIPF_S, ZIPF_KEYS = 1.1, 1_000_000
# k-means: 10M points in D = 32 around 64 true centers (coordinates
# N(0, CENTER_SD^2), unit noise), fit with k = 64; grouped: G_MAIN groups,
# k = 8 each; the two-pass variant on the first N_TWO_PASS rows
D_KM, K_KM, K_KM_GROUPED, CENTER_SD = 32, 64, 8, 10.0
N_TWO_PASS = 1_000_000
KM_MAX_ITERS = 50
# the convergence test of the card's fits: MADlib's kmeans default
# min_frac_reassigned = 0.001 (stop once at most 0.1% of the rows move)
KM_REASSIGN_TOL = 1e-3
# Gaussian kmeans_assign: a row that the kernel assigns elsewhere than
# the exact (float64) nearest centroid must be a near tie, its distance
# within NEAR_TIE_RTOL of |x|^2 + max |c|^2 of the best one's
NEAR_TIE_RTOL = 1e-5
# section n: the segments' 10-round k-means fit sums its f32 centroid sums
# in another order than the local fit, and near-tie rows drift apart over
# the rounds (778 and 784 of 10,000,000 rows assigned apart under the two
# fits' centroids at 8 and 24 segments on the H100): at most this many
KM_SHARD_ROWS_APART = 2_000
# IRLS in f32 against the same IRLS in float64, coefficients
IRLS_RTOL, IRLS_ATOL = 1e-3, 1e-4
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# the kernels whose bound counts f32 operations (TFLOP/s printed for them)
F32_OPS_KERNELS = ("xtx", "segment_linregr", "kmeans_assign")
# Integer instructions per SM per clock on compute capability 9.0, by the
# pipe that issues them.  The CUDA C++ Programming Guide's arithmetic
# instruction throughput table gives 64 for 32-bit integer add, shift,
# logical ops and multiply-add alike.  Nsight Compute's pipe names put
# IMAD on the FMA pipe and shifts, logical ops and selects on the ALU
# pipe, so the two run side by side.  The four schedulers of an SM issue
# at most one warp instruction each per clock: 128 lanes over all pipes.
# Times the SM count and the maximum SM clock from nvidia-smi.
PIPE_LANES_PER_SM = {"alu": 64, "fma": 64}
ISSUE_LANES_PER_SM = 128
# Instructions per valid row and hash that each function needs, by pipe,
# as the kernels' SASS has them (cuobjdump -sass; phase 2 prints the
# opcode mix).  The hash fmix32(x * p + p) is 3 IMAD (fma: the multiply-
# add and two multiplies), 3 SHF and 3 LOP3 (alu: shifts and xors).
# Count-Min at a power-of-two width folds `% width` (an AND) into the last
# LOP3; its increment is a shared or global atomic, not a lane op, and is
# not counted.  FM adds -h (an IMAD.MOV, fma), h & -h (LOP3), the fallback
# select (SEL) and the OR into the bitmap (LOP3).
PIPE_OPS_PER_HASH = {"countmin": {"alu": 6, "fma": 3},
                     "segment_countmin": {"alu": 6, "fma": 3},
                     "segment_fm": {"alu": 9, "fma": 4}}
SASS_OPS = ("IMAD", "IADD3", "SHF", "LOP3", "SEL", "ISETP", "ATOMS", "REDG",
            "REDUX", "MUFU", "I2F", "F2I", "FLO", "BREV")
# Gaussian data: the kernel sums in another order than cuBLAS or the
# block loop, so the two differ by the f32 rounding of sums over up to
# 1e7 rows.  Both are held against a float64 sum of the same inputs: the
# kernel's max error may exceed neither twice the plain version's nor
# GAUSS_RTOL * max|float64 sum|, whichever is larger.
GAUSS_RTOL = 1e-5
# profile's f32 sums and sums of squares against float64 sums: within
# PROFILE_RTOL of the float64 sum of the terms' absolute values.
PROFILE_RTOL = 1e-5
# g. the LM path: qwen3-8b at full width and depth, prefill of (2, 4096)
# tokens (train_4k's sequence length); the flash_attention kernel at its
# layer shape (B, Hq, Hk, S, D) and at prefill_32k's sequence length
LM_ARCH, LM_BATCH, LM_SEQ = "qwen3-8b", 2, 4096
FLASH_MAIN = (LM_BATCH, 32, 8, LM_SEQ, 128)
FLASH_LONG = (1, 32, 8, 32768, 128)
PEAK_BF16_FLOPS = 989e12   # H100 SXM, bf16 dense tensor cores
# f32 checks at the reference's test shapes (tests/test_kernels.py) and a
# ragged S.  Kernel and plain version sum the same f32 products in other
# orders and take the same exp: on unit-normal inputs their outputs (of
# magnitude about 1) differ by a few f32 ulps, far below 1e-4.
FLASH_F32_SHAPES = [(1, 2, 1, 128, 64, True), (2, 4, 2, 256, 64, True),
                    (1, 8, 1, 128, 128, False), (1, 2, 2, 64, 32, True),
                    (1, 4, 4, 128, 64, True), (2, 4, 2, 1000, 128, True)]
FLASH_F32_ATOL = 1e-4
# bf16 beside the main shape: every D of the repo's configs (16 reduced,
# 64, 80, 96, 128) with ragged S and GQA through the tensor-core kernel,
# and a D % 8 != 0 that the wrapper sends to the FFMA kernel by rule; then
# section l's layer shapes (FAMILY_FLASH) and a ragged non-causal D = 80
FLASH_BF16_SHAPES = [(1, 4, 1, 1, 16, True, "tc"),
                     (3, 6, 2, 77, 64, True, "tc"),
                     (2, 8, 2, 300, 96, False, "tc"),
                     (1, 4, 2, 1000, 128, True, "tc"),
                     (3, 6, 2, 300, 128, False, "tc"),
                     (1, 4, 2, 77, 20, True, "ffma"),
                     (3, 16, 16, 333, 80, False, "tc"),
                     (2, 16, 16, 4096, 128, True, "tc"),
                     (2, 12, 2, 4096, 128, True, "tc"),
                     (2, 16, 16, 4096, 80, False, "tc")]
# bf16: both compute in f32 from the same bf16 inputs and round the output
# to bf16 once, so they may differ by one bf16 step (8 significant bits):
# 2^-7 x max |plain|.  The same limit holds row by row (max over D of each
# row (b, h, s), bf16_row_ratio): the late causal rows average over
# thousands of keys and lie far below the first rows' values, which set
# the overall max |plain|.
FLASH_BF16_RTOL = 2.0 ** -7
# The bf16 forward, flash against use_flash=False (attention_chunked, which
# rounds the pre-scaled q and p to bf16 where the kernel keeps f32) and
# against the same forward with the kernel's plain version in its place.
# The logits are bf16 over 151,936 tokens of a random model: at about 7% of
# positions the top two are equal in bf16 and at about 19% within one bf16
# step, so any difference in summation order flips the argmax there (at
# this seed on an H100 the kernel against its own plain version agrees on
# 93.4% of positions).  So top-1 tokens must agree on >= TOP1_AGREE of the
# positions whose top two logits (of the path compared with) lie more than
# TOP1_GAP_STEPS bf16 steps apart, the overall share is printed, and the
# logits differ by at most LOGIT_STEPS bf16 steps at the largest logit (the
# paths' roundings differ in every layer and reach the logits through 36
# bf16 residual adds).  In f32, at full depth, top-1 must agree on >=
# TOP1_AGREE of all positions and the logits within 1e-3 of the largest.
TOP1_AGREE, TOP1_GAP_STEPS, LOGIT_STEPS = 0.99, 4, 16
# teacher-forced decode against forward on the 2-layer f32 model: positions
DECODE_CHECK_LEN = 32
# l. the other LM families at full width and depth, bf16: a prefill of
# (2, 4096) each (vlm: 256 patch embeddings of a 16 x 16 grid and 3,840
# tokens; audio: frame embeddings), the flash families' layer shapes
# (B, Hq, Hk, S, D, causal), and teacher-forced decode against forward
# over FAMILY_DECODE_LEN tokens for the families without MoE routing
# The MoE's top-6 of 64 experts turns a one-step bf16 difference in a
# router input into another expert for a few tokens, and such a token's
# FFN output moves by a whole expert's share (the reference's expert init
# scales by E^-0.5, E = 64, so the experts' outputs dominate the residual
# stream).  The flips compound over the layers: at full depth the logits
# of the flash path and of use_flash=False are unrelated, as are those of
# the flash path and of the kernel's plain version in its place (and a
# second forward is bitwise the first).  So the MoE's flash path is held
# against use_flash=False on the model's first MOE_CHECK_DEPTH layers:
# top-1 on >= TOP1_AGREE of the decided positions and a mean |dlogit| of
# at most MOE_MEAN_STEPS bf16 steps at the largest logit (no max: a
# flipped token's logits move by up to their own scale); the agreement at
# MOE_DEPTHS and at full depth is printed.
MOE_CHECK_DEPTH, MOE_MEAN_STEPS = 1, 1
MOE_DEPTHS = (1, 2, 4, 8, 16)
# Teacher-forced decode runs each matmul on one token where the forward
# runs it on 64, so the two round bf16 products in other places, by up
# to one bf16 step (2^-8) an op.  Hybrid and vlm stay within section g's
# rule.  The xLSTM's exponential gates and normalisers amplify such steps
# over its 24 layers: its logits differ by about 2 steps on average and
# up to about 40 (full width, on the card and the CPU alike; top-1 on
# 93-95% of the decided positions over four seeds), so it is held to
# top-1 on >= SSM_DECODE_TOP1 of them and a mean of at most
# SSM_DECODE_MEAN_STEPS steps.  All three are also held in f32 at full
# width and depth: decode within 1e-3 of the largest forward logit
# (section g's f32 rule).
SSM_DECODE_TOP1, SSM_DECODE_MEAN_STEPS = 0.9, 4
FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "recurrentgemma-2b", "qwen2-vl-2b",
                "hubert-xlarge", "xlstm-350m")
VLM_GRID = 16
FAMILY_DECODE_LEN = 64
FAMILY_FLASH = {"moonshot-v1-16b-a3b": (LM_BATCH, 16, 16, LM_SEQ, 128, True),
                "qwen2-vl-2b": (LM_BATCH, 12, 2, LM_SEQ, 128, True),
                "hubert-xlarge": (LM_BATCH, 16, 16, LM_SEQ, 80, False)}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi(query: str = "name,power.limit", units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}", "-i", "0"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def dyadic(torch, gen, shape, dev):
    """Values in {-1/8, 0, 1/8}: every partial sum of up to 1e7 products
    is a multiple of 1/64 below 2^18 in magnitude, exact in f32, so any
    summation order gives the same bits."""
    return torch.randint(-1, 2, shape, generator=gen, dtype=torch.int8,
                         device=dev).float() / 8


def zipf_items(torch, gen, n, dev):
    """(n,) int32 keys in [0, ZIPF_KEYS), P(k) proportional to
    (k + 1)^-ZIPF_S: uniform draws through the cumulative weights."""
    w = torch.arange(1, ZIPF_KEYS + 1, dtype=torch.float64,
                     device=dev) ** -ZIPF_S
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=dev)
    keys = torch.searchsorted(cdf, u).clamp_(max=ZIPF_KEYS - 1)
    return keys.to(torch.int32)


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, fn, reps: int, flush) -> float:
    """Event time of each call alone with the L2 cold: ``flush`` (larger
    than the 50 MB L2) is written before each call, then the stream
    sleeps for about 0.1 ms while the host enqueues the call, so neither
    the host's launch nor a previous call's lines in the L2 show in the
    time between the events around the call."""
    fn()
    total = 0.0
    for i in range(reps):
        flush.fill_(float(i))
        torch.cuda._sleep(200_000)  # about 0.1 ms: the host enqueues fn
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def alone_ms(torch, fn, reps: int) -> float:
    """Event time of each call alone: the stream sleeps for about 0.5 ms
    while the host enqueues the call, so the host's time per call does
    not show (the L2 keeps what the previous call left)."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_call_us(torch, fn, reps: int = 50) -> float:
    """Host microseconds a call takes to return (the card not waited
    for), over ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(torch, fn, reps: int, kernels: tuple[str, ...]):
    """Device time per call of the CUDA kernels whose names contain one of
    ``kernels``, from torch.profiler's CUDA activity; None when the
    profiler records no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages()
                   if any(k in e.key for k in kernels))
    return total_us / reps / 1e3 if total_us > 0 else None


def max_err(torch, got: dict, want: dict) -> tuple[float, float]:
    """(max |got - want| over every leaf, max |want|)."""
    err = max(float((got[k].double() - want[k].double()).abs().max())
              for k in want)
    scale = max(float(want[k].abs().max()) for k in want)
    return err, scale


def gauss_check(torch, what: str, got: dict, plain: dict,
                exact: dict) -> float:
    """Hold the kernel (``got``) and its plain version against a float64
    sum; returns max |kernel - plain|."""
    err_k, scale = max_err(torch, got, exact)
    err_p, _ = max_err(torch, plain, exact)
    limit = max(2.0 * err_p, GAUSS_RTOL * scale)
    require(err_k <= limit,
            f"{what} gaussian: kernel error {err_k} vs float64 exceeds "
            f"{limit} (plain version's error {err_p})")
    diff = max_err(torch, got, plain)[0]
    print(f"[kernels] {what} gaussian: max error vs float64 kernel "
          f"{err_k:.3e}, plain {err_p:.3e} (max |sum| {scale:.3e}); "
          f"kernel vs plain {diff:.3e}")
    return diff


def km_gauss_check(torch, what: str, x, c, m, got, plain) -> float:
    """Hold the kmeans_assign kernel (``got``) and its plain version on
    Gaussian data against a float64 computation: every row's assigned
    centroid is the nearest or a near tie (NEAR_TIE_RTOL); ``mind`` and
    the sums, each against float64 from its own assignment, err no more
    than twice the plain version or GAUSS_RTOL of the largest term;
    counts exact.  Returns max |kernel - plain| over ``mind`` where the
    two assign alike (and over the sums when they assign every row
    alike)."""
    c64 = c.double()
    cc = (c64 * c64).sum(1)
    ak, ap = got[0].long(), plain[0].long()
    gap = {"kernel": 0.0, "plain": 0.0}
    mind64 = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    scale = 0.0
    for r0 in range(0, x.shape[0], 1_000_000):
        x64 = x[r0:r0 + 1_000_000].double()
        xx = (x64 * x64).sum(1)
        d2 = xx[:, None] - 2.0 * (x64 @ c64.T) + cc[None, :]
        best = d2.amin(1)
        terms = xx + cc.max()
        scale = max(scale, float(terms.max()))
        for name, a in (("kernel", ak), ("plain", ap)):
            g = (d2.gather(1, a[r0:r0 + 1_000_000, None])[:, 0] - best) / terms
            gap[name] = max(gap[name], float(g.max()))
        mind64[r0:r0 + 1_000_000] = best.clamp(min=0.0)
        del x64, d2
    mind64 *= m.double()
    require(gap["kernel"] <= NEAR_TIE_RTOL,
            f"{what} gaussian: a row assigned {gap['kernel']:.3e} (relative)"
            " off its nearest centroid")
    err = {}
    for name, out, a in (("kernel", got, ak), ("plain", plain, ap)):
        sums64 = torch.zeros(c.shape, dtype=torch.float64, device=x.device)
        sums64.index_add_(0, a, x.double() * m.double()[:, None])
        cnt64 = torch.zeros(c.shape[0], dtype=torch.float64, device=x.device)
        cnt64.index_add_(0, a, m.double())
        require(torch.equal(out[3].double(), cnt64),
                f"{what} gaussian: {name} counts not exact")
        scale = max(scale, float(sums64.abs().max()))
        err[name] = max(float((out[1].double() - mind64).abs().max()),
                        float((out[2].double() - sums64).abs().max()))
        del sums64
    limit = max(2.0 * err["plain"], GAUSS_RTOL * scale)
    require(err["kernel"] <= limit,
            f"{what} gaussian: kernel error {err['kernel']} vs float64 "
            f"exceeds {limit} (plain version's error {err['plain']})")
    same = ak == ap
    flips = int((~same).sum())
    diff = float((got[1] - plain[1]).abs()[same].max())
    if flips == 0:
        diff = max(diff, float((got[2] - plain[2]).abs().max()))
    print(f"[kernels] {what} gaussian: {flips} rows assigned apart from the "
          f"plain version (near ties: the kernel's worst row "
          f"{gap['kernel']:.2e}, the plain's {gap['plain']:.2e} of "
          f"|x|^2 + max|c|^2 from the nearest); max error vs float64 kernel "
          f"{err['kernel']:.3e}, plain {err['plain']:.3e} (scale "
          f"{scale:.3e}); kernel vs plain {diff:.3e}")
    return diff


def km_round_check(torch, what: str, x, c, assign, got: dict,
                   want: dict) -> dict:
    """Hold one Lloyd round's fold state from the segments (``got``)
    against the local engine's (``want``), both assigning every row of
    ``x`` to the centroids ``c``; ``assign`` is kmeans_assign's own
    assignment of the whole column.  The counts of each may differ from
    that assignment's by no more than the near-tie rows (the float64
    second-nearest centroid within NEAR_TIE_RTOL of |x|^2 + max |c|^2 of
    the nearest).  The sums and the SSE are each held to float64 sums
    over that assignment, so that only f32 summation rounding remains, by
    km_gauss_check's rule: the segments' error may exceed neither twice
    the local engine's nor GAUSS_RTOL of the largest float64 term (the
    sums also by 2 max|x| for each row assigned apart)."""
    c64 = c.double()
    cc = (c64 * c64).sum(1)
    a = assign.long()
    sums64 = torch.zeros(c.shape, dtype=torch.float64, device=x.device)
    sums64.index_add_(0, a, x.double())
    cnt64 = torch.bincount(a, minlength=c.shape[0]).double()
    sse64, near = 0.0, 0
    for r0 in range(0, x.shape[0], 1_000_000):
        x64 = x[r0:r0 + 1_000_000].double()
        xx = (x64 * x64).sum(1)
        d2 = xx[:, None] - 2.0 * (x64 @ c64.T) + cc[None, :]
        two = d2.topk(2, dim=1, largest=False).values
        near += int((two[:, 1] - two[:, 0]
                     <= NEAR_TIE_RTOL * (xx + cc.max())).sum())
        sse64 += float(d2.gather(1, a[r0:r0 + 1_000_000, None])
                       .clamp(min=0.0).sum())
        del x64, d2, two
    apart = {name: int((st["counts"].double() - cnt64).abs().sum()) // 2
             for name, st in (("segments", got), ("local", want))}
    require(max(apart.values()) <= near, f"{what}: rows assigned apart "
            f"from kmeans_assign's own assignment {apart}, {near} near ties")
    err = {name: (float((st["sums"].double() - sums64).abs().max()),
                  abs(float(st["sse"]) - sse64))
           for name, st in (("segments", got), ("local", want))}
    limit = (max(2.0 * err["local"][0], GAUSS_RTOL
                 * float(sums64.abs().max()))
             + 2.0 * apart["segments"] * float(x.abs().max()),
             max(2.0 * err["local"][1], GAUSS_RTOL * sse64))
    require(err["segments"][0] <= limit[0], f"{what}: sums err "
            f"{err['segments'][0]} vs float64, limit {limit[0]} (local "
            f"{err['local'][0]})")
    require(err["segments"][1] <= limit[1], f"{what}: SSE err "
            f"{err['segments'][1]} vs float64, limit {limit[1]} (local "
            f"{err['local'][1]})")
    return {"rows_apart": apart["segments"],
            "rows_apart_local": apart["local"], "near_ties": near,
            "sums_err": err["segments"][0], "sums_err_local": err["local"][0],
            "sums_limit": limit[0], "sse_err": err["segments"][1],
            "sse_err_local": err["local"][1]}


def bitwise(torch, what: str, got, want) -> float:
    """Require ``got`` equal to ``want`` bit for bit; returns
    max |got - want| (0.0 when they are)."""
    torch.cuda.synchronize()
    require(got.shape == want.shape, f"{what}: shapes differ")
    err = float((got.double() - want.double()).abs().max())
    require(torch.equal(got, want), f"{what}: not bitwise equal (max err "
            f"{err})")
    return err


class Counters:
    """The wrappers' launch counters: zeroed just before each
    main-path run, read just after it, and summed over those runs only
    (launches made to check or time a kernel are never read)."""

    def __init__(self, mods):
        self.where = {name: (mod, f"{name}_launches")
                      for name, mod in mods.items()}
        self.total = dict.fromkeys(mods, 0)

    def zero(self) -> None:
        for mod, attr in self.where.values():
            setattr(mod, attr, 0)

    def read(self) -> dict:
        got = self.peek()
        for name, n in got.items():
            self.total[name] += n
        return got

    def peek(self) -> dict:
        """The counters as they stand, added to no total."""
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.where.items()}


def int_ops_seconds(name: str, row_hashes: float, sms: int,
                    clock_hz: float) -> float:
    """Least time of the integer work of ``row_hashes`` (valid rows times
    hashes): the slowest pipe, or the issue rate over all of them."""
    ops = PIPE_OPS_PER_HASH[name]
    times = [row_hashes * n / (PIPE_LANES_PER_SM[pipe] * sms * clock_hz)
             for pipe, n in ops.items()]
    times.append(row_hashes * sum(ops.values())
                 / (ISSUE_LANES_PER_SM * sms * clock_hz))
    return max(times)


def sass_mix(cuobjdump: Path, obj: Path) -> dict[str, dict[str, int]]:
    """For each kernel in ``obj``, how many of its SASS instructions have
    each opcode of SASS_OPS (every path of the kernel, not per row)."""
    out = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                         capture_output=True, text=True, check=True).stdout
    mix: dict[str, dict[str, int]] = {}
    counts = None
    for line in out.splitlines():
        if "Function :" in line:
            counts = mix.setdefault(line.split(":", 1)[1].strip(),
                                    dict.fromkeys(SASS_OPS, 0))
        elif counts is not None and line.lstrip().startswith("/*") \
                and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            op = words[0].split(".")[0] if words else ""
            if op in counts:
                counts[op] += 1
    return mix


def timed(torch, fn):
    """(result, host seconds) of ``fn()`` ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ptxas_for(lines: list[str], key: str) -> list[str]:
    """ptxas' lines (registers, shared memory, spills) for the entries
    whose mangled names contain ``key``."""
    out, keep = [], False
    for line in lines:
        if "Compiling entry" in line:
            keep = key in line
            if keep:
                out.append(line)
        elif keep:
            out.append(line)
    return out


def flash_bound_ms(b, hq, hk, s, d, causal=True) -> tuple[float, float]:
    """(operations ms, bytes ms) of attention at (B, Hq, Hk, S, D) in
    bf16: the kernel package's ``forward_cost`` (4 B Hq D P operations
    over the P unmasked pairs; q and o, k and v each read or written once,
    2 bytes an element), the count that the dry run and the op counter
    read too, over the bf16 tensor-core peak and the memory rate."""
    from repro_torch.kernels.flash_attention.ops import forward_cost
    ops, nbytes = forward_cost(b, hq, hk, s, d, causal, 2)
    return ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bf16_row_ratio(torch, got, want) -> float:
    """The worst row (b, h, s): max |got - want| along D over max |want|
    along D (0 where both are 0)."""
    want = want.float()
    err_ = (got.float() - want).abs().amax(-1)
    scale_ = want.abs().amax(-1)
    ratio = torch.where(err_ == 0, torch.zeros_like(err_), err_ / scale_)
    return float(ratio.max())


def lm_section(torch, dev, counters, errs) -> dict:
    """Section g, the LM serving path at qwen3-8b's full width: the
    flash_attention kernel against its plain version, the prefill forward
    through it (every layer), decode through ``serve``, and the kernel's
    timing.  Returns the kernel's row."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    # the bf16 checks beside the main shape draw from a generator of their
    # own, so that the main path's inputs and weights stay
    gen_bf16 = torch.Generator(device=dev)
    gen_bf16.manual_seed(SEED + 15)

    def qkv(b, hq, hk, s, d, dtype=torch.float32, g=gen):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d))]

    # the kernel against its plain version: f32 at the reference's test
    # shapes and a ragged S; bf16 at qwen3-8b's layer shape; causality
    def path_launches():
        return (fa_ops.flash_attention_tc_launches,
                fa_ops.flash_attention_ffma_launches)

    def through(kernel, fn):
        """fn() once; require that it launched ``kernel`` ("tc" or
        "ffma") once and the other kernel never."""
        tc0, ffma0 = path_launches()
        out_ = fn()
        tc1, ffma1 = path_launches()
        want_ = (1, 0) if kernel == "tc" else (0, 1)
        require((tc1 - tc0, ffma1 - ffma0) == want_,
                f"flash_attention: want one {kernel} launch, got tc "
                f"{tc1 - tc0}, ffma {ffma1 - ffma0}")
        return out_

    err = 0.0
    for b, hq, hk, s, d, causal in FLASH_F32_SHAPES:
        q, k, v = qkv(b, hq, hk, s, d)
        got = through("ffma", lambda: fa_ops.flash_attention(
            q, k, v, causal=causal))
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        require(e <= FLASH_F32_ATOL,
                f"flash_attention f32 {(b, hq, hk, s, d, causal)}: "
                f"max |kernel - plain| {e} > {FLASH_F32_ATOL}")
        err = max(err, e)
        print(f"[lm] flash_attention f32 (B, Hq, Hk, S, D) = "
              f"{(b, hq, hk, s, d)}, causal {causal}, FFMA kernel: max "
              f"|kernel - plain| {e:.3e}")
    # bf16 through the tensor-core kernel: every D of the repo's configs,
    # a ragged S, GQA, causal or not; and bf16 with D % 8 != 0 (FFMA)
    for b, hq, hk, s, d, causal, kernel in FLASH_BF16_SHAPES:
        q, k, v = qkv(b, hq, hk, s, d, torch.bfloat16, gen_bf16)
        got = through(kernel, lambda: fa_ops.flash_attention(
            q, k, v, causal=causal))
        want = flash_attention_ref(q, k, v, causal=causal)
        e = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        require(e <= FLASH_BF16_RTOL * scale, f"flash_attention bf16 "
                f"{(b, hq, hk, s, d, causal)}: max |kernel - plain| {e} > "
                f"2^-7 x {scale}")
        row = bf16_row_ratio(torch, got, want)
        require(row <= FLASH_BF16_RTOL, f"flash_attention bf16 "
                f"{(b, hq, hk, s, d, causal)}: a row's max |kernel - plain| "
                f"is {row} of its max |plain| > 2^-7")
        print(f"[lm] flash_attention bf16 (B, Hq, Hk, S, D) = "
              f"{(b, hq, hk, s, d)}, causal {causal}, {kernel} kernel: max "
              f"|kernel - plain| {e:.3e} (max |plain| {scale:.3e}); worst "
              f"row {row:.3e} of its max |plain|")
        err = max(err, e)
    q, k, v = qkv(*FLASH_MAIN, torch.bfloat16)
    got = through("tc", lambda: fa_ops.flash_attention(q, k, v))
    want = flash_attention_ref(q, k, v)
    e = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    require(e <= FLASH_BF16_RTOL * scale, f"flash_attention bf16 "
            f"{FLASH_MAIN}: max |kernel - plain| {e} > 2^-7 x {scale}")
    row = bf16_row_ratio(torch, got, want)
    require(row <= FLASH_BF16_RTOL, f"flash_attention bf16 {FLASH_MAIN}: "
            f"a row's max |kernel - plain| is {row} of its max |plain| "
            f"> 2^-7")
    del want
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v)]
    require(torch.equal(through("tc", lambda: fa_ops.flash_attention(
        *strided)), got),
            "flash_attention: (B, S, H, D) strides change the result")
    print(f"[lm] flash_attention bf16 {FLASH_MAIN}: max |kernel - plain| "
          f"{e:.3e} (max |plain| {scale:.3e}; limit 2^-7 of it); worst row "
          f"{row:.3e} of its own max |plain| (limit 2^-7); the same bits "
          f"from (B, S, H, D) storage through its strides")
    err = max(err, e)
    del q, k, v, got, strided
    q, k, v = qkv(1, 2, 1, 64, 32)
    base = fa_ops.flash_attention(q, k, v)
    k[:, :, 40:] += 10.0
    v[:, :, 40:] += 10.0
    pert = fa_ops.flash_attention(q, k, v)
    require(torch.equal(base[:, :, :40], pert[:, :, :40])
            and float((base[:, :, 41:] - pert[:, :, 41:]).abs().max())
            > 1e-3, "flash_attention: causality")
    q, k, v = qkv(1, 2, 1, 200, 128, torch.bfloat16, gen_bf16)
    base = through("tc", lambda: fa_ops.flash_attention(q, k, v))
    k[:, :, 40:] += 10.0
    v[:, :, 40:] += 10.0
    pert = fa_ops.flash_attention(q, k, v)
    require(torch.equal(base[:, :, :40], pert[:, :, :40])
            and float((base[:, :, 41:].float() - pert[:, :, 41:].float())
                      .abs().max()) > 1e-3,
            "flash_attention: causality (bf16, tensor cores)")
    print("[lm] flash_attention causality, f32 (FFMA) and bf16 (tensor "
          "cores): keys and values from position 40 on moved, outputs "
          "before 40 bitwise the same")
    errs["flash_attention"] = err
    torch.cuda.empty_cache()

    # the FFMA kernel on the same bf16 inputs, through its C entry (the
    # wrapper sends bf16 to the tensor cores): the earlier design, timed
    # in the same run
    from repro_torch.kernels import _build

    def ffma(q, k, v):
        o = torch.empty_like(q)
        b, hq, s, d = q.shape
        _build.check("flash_attention", _build.lib().madlib_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, 1,
            b, hq, k.shape[1], s, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], 1.0 / d ** 0.5, 1,
            torch.cuda.current_stream().cuda_stream))
        return o

    # timing, before the forward's profile: the main path's layer shape
    # and prefill_32k's sequence
    out = {}
    for shape, reps in ((FLASH_MAIN, 20), (FLASH_LONG, 3)):
        q, k, v = qkv(*shape, torch.bfloat16)
        t_ops, t_bytes = flash_bound_ms(*shape)
        ms = cuda_ms(torch, lambda: fa_ops.flash_attention(q, k, v), reps)
        dev_ms = device_ms(torch, lambda: fa_ops.flash_attention(q, k, v),
                           1, ("flash_attention_tc",))
        ffma_ms = cuda_ms(torch, lambda: ffma(q, k, v),
                          5 if shape == FLASH_MAIN else 1)
        plain_ms = (cuda_ms(torch, lambda: flash_attention_ref(q, k, v), 2)
                    if shape == FLASH_MAIN else None)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps)
        ms2 = cuda_ms(torch, lambda: fa_ops.flash_attention(q, k, v), reps)
        tflops = t_ops * PEAK_BF16_FLOPS / 1e12 / ms
        out[shape] = {"ms": ms, "ms_again": ms2, "device_ms": dev_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "ffma_ms": ffma_ms, "ops_ms": t_ops,
                      "bytes_ms": t_bytes, "tflops": tflops}
        plain_txt = (f"{plain_ms:.3f} ms" if plain_ms is not None else
                     "not run (its (S, S) f32 scores take "
                     f"{4.0 * shape[0] * shape[1] * shape[3] ** 2 / 1e9:.0f}"
                     " GB)")
        print(f"[timing] flash_attention {shape} bf16 causal, tensor-core "
              f"kernel: {ms:.4f} ms (CUDA events; {ms2:.4f} ms again after "
              f"the others), device {dev_ms} ms; {tflops:.1f} TFLOP/s, "
              f"{max(t_ops, t_bytes) / ms:.1%} of the bound "
              f"{max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f}, bytes "
              f"{t_bytes:.4f}); FFMA kernel on the same inputs "
              f"{ffma_ms:.3f} ms; plain {plain_txt}; "
              f"scaled_dot_product_attention {lib_ms:.4f} ms; {nvidia_smi()}")
        del q, k, v
    torch.cuda.empty_cache()

    # the prefill forward at full width and depth, bf16, random weights
    cfg = get_config(LM_ARCH)
    model, s_init = timed(torch, lambda: M.init_model(cfg, generator=gen,
                                                      device=dev))
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                         device=dev)
    print(f"[lm] {LM_ARCH}: {sum(p.numel() for p in model.parameters())} "
          f"parameters ({cfg.dtype}) drawn on the card in {s_init:.2f} s; "
          f"tokens ({LM_BATCH}, {LM_SEQ})")
    counters.zero()
    (logits, _), s_first = timed(torch, lambda: M.forward(model, toks))
    launched = counters.read()
    require(launched["flash_attention"] == cfg.n_layers
            and launched["flash_attention_tc"] == cfg.n_layers
            and launched["flash_attention_ffma"] == 0,
            f"forward: flash_attention launches {launched['flash_attention']}"
            f" (tensor cores {launched['flash_attention_tc']}, FFMA "
            f"{launched['flash_attention_ffma']}), want {cfg.n_layers} on "
            "the tensor cores (one per layer)")
    print(f"[lm] forward, bf16: {launched['flash_attention_tc']} of "
          f"{launched['flash_attention']} flash_attention launches on the "
          "tensor-core kernel, 0 on the FFMA kernel")
    require(logits.shape == (LM_BATCH, LM_SEQ, cfg.vocab)
            and bool(torch.isfinite(logits).all()), "forward: logits")
    (plain, _), s_plain = timed(torch, lambda: M.forward(
        model, toks, use_flash=False))
    # the same forward with the kernel's plain version in its place
    entry = registry.get("flash_attention")
    registry._REGISTRY["flash_attention"] = dataclasses.replace(
        entry, cuda=entry.ref)
    try:
        ref_logits, _ = M.forward(model, toks)
    finally:
        registry._REGISTRY["flash_attention"] = entry
    fails: list[str] = []
    for name, other in (("use_flash=False (chunked)", plain),
                        ("the kernel's plain version", ref_logits)):
        logits_agree(torch, f"forward, bf16: flash vs {name}", logits,
                     other, fails, tag="lm")
    require(not fails, "; ".join(fails))
    del logits, plain, ref_logits

    def fwd():
        return M.forward(model, toks)[0]

    ms = cuda_ms(torch, fwd, 3)
    flash_dev = device_ms(torch, fwd, 1, ("flash_attention",))
    share = "not measured" if flash_dev is None else f"{flash_dev / ms:.1%}"
    by_events = cfg.n_layers * out[FLASH_MAIN]["ms"]
    print(f"[lm] forward ({LM_BATCH} x {LM_SEQ} tokens, {cfg.n_layers} "
          f"layers): first {s_first:.3f} s, use_flash=False {s_plain:.3f} s "
          f"(host clock, synchronized); repeated {ms:.2f} ms (CUDA events), "
          f"{LM_BATCH * LM_SEQ / ms * 1e3:.0f} prefill tokens/s; "
          f"flash_attention device time {flash_dev} ms per forward "
          f"(torch.profiler), {share} of it; {cfg.n_layers} x the timed "
          f"launch = {by_events:.1f} ms, {by_events / ms:.1%}")
    del model
    torch.cuda.empty_cache()

    # f32 at full depth: flash against use_flash=False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = M.init_model(cfg32, generator=gen, device=dev)
    ffma0 = fa_ops.flash_attention_ffma_launches
    logits, _ = M.forward(model, toks)
    require(fa_ops.flash_attention_ffma_launches - ffma0 == cfg32.n_layers,
            "f32 forward: not one FFMA flash_attention launch per layer")
    plain, _ = M.forward(model, toks, use_flash=False)
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    d32 = max(float((a - b).abs().max())
              for a, b in zip(logits.split(512, 1), plain.split(512, 1)))
    top = float(plain.abs().max())
    print(f"[lm] forward, f32, {cfg32.n_layers} layers: flash vs "
          f"use_flash=False top-1 agree on {agree:.4%} of positions, max "
          f"|dlogit| {d32:.3e} (max |logit| {top:.3f}, limit 1e-3 of it)")
    require(agree >= TOP1_AGREE and d32 <= 1e-3 * top,
            f"f32 forward: agreement {agree}, max |dlogit| {d32}")
    del model, logits, plain
    torch.cuda.empty_cache()

    # two layers at full width in f32: flash against use_flash=False, and
    # teacher-forced decode against the flash forward
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = M.init_model(cfg2, generator=gen, device=dev)
    logits, _ = M.forward(model, toks)
    plain, _ = M.forward(model, toks, use_flash=False)
    d32 = max(float((a - b).abs().max())
              for a, b in zip(logits.split(512, 1), plain.split(512, 1)))
    top = float(plain.abs().max())
    require(d32 <= 1e-3 * top, f"f32 forward: flash vs use_flash=False "
            f"differ by {d32} (max |logit| {top})")
    del logits, plain
    dec, fwd32 = decode_and_forward(torch, M, model,
                                    toks[:, :DECODE_CHECK_LEN], dev)
    d_dec = float((dec - fwd32).abs().max())
    require(torch.allclose(dec, fwd32, rtol=2e-3, atol=2e-4),
            f"f32 decode vs forward: max diff {d_dec}")
    print(f"[lm] {cfg2.n_layers} layers at full width, f32: flash vs "
          f"use_flash=False max |dlogit| {d32:.3e} (max |logit| {top:.3f}, "
          f"limit 1e-3 of it); teacher-forced decode_step vs forward over "
          f"{DECODE_CHECK_LEN} positions max diff {d_dec:.3e} (rtol 2e-3, "
          "atol 2e-4)")
    del model, fwd32, dec, toks
    torch.cuda.empty_cache()

    # decode at full width through serve (the JAX defaults)
    counters.zero()
    (gen_toks, timing), s_serve = timed(torch, lambda: serve(
        LM_ARCH, reduced=False, seed=SEED))
    launched = counters.read()
    require(tuple(gen_toks.shape) == (4, 32) and int(gen_toks.min()) >= 0
            and int(gen_toks.max()) < cfg.vocab, "serve: tokens")
    require(launched["flash_attention"] == 0, "serve: decode launched flash")
    print(f"[lm] serve({LM_ARCH!r}, reduced=False): batch 4, prompt 16, "
          f"generate 32: prefill {timing['prefill_s']:.3f} s "
          f"({timing['prefill_tok_s']:.1f} tok/s), decode "
          f"{timing['decode_tok_s']:.1f} tok/s; {s_serve:.2f} s in all, "
          "with the model's draw")
    torch.cuda.empty_cache()

    main = out[FLASH_MAIN]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_tc.cu",
            "ffma_source": "src/repro_torch/csrc/flash_attention.cu",
            "ffma_ms": main["ffma_ms"], "tflops": main["tflops"],
            "launches_tc": counters.total["flash_attention_tc"],
            "launches_ffma": counters.total["flash_attention_ffma"],
            "g_launches": counters.total["flash_attention"],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:29",
            "launches": counters.total["flash_attention"],
            "max_abs_err": errs["flash_attention"], "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": max(main["ops_ms"], main["bytes_ms"]),
            "bound_by": ("operations" if main["ops_ms"] >= main["bytes_ms"]
                         else "bytes"),
            "library_ms": main["library_ms"], "launches_per_call": 1,
            "device_ms": main["device_ms"], "ops_ms": main["ops_ms"],
            "bytes_ms": main["bytes_ms"], "shape": list(FLASH_MAIN),
            "prefill_32k": {"shape": list(FLASH_LONG), **out[FLASH_LONG]}}


def logits_agree(torch, what, got, want, fails, top1=TOP1_AGREE,
                 max_steps=LOGIT_STEPS, mean_steps=None,
                 tag="families") -> dict:
    """Hold bf16 logits ``got`` against ``want``; by default as section g
    holds its forward: top-1 agreement on >= ``top1`` of the positions
    whose top two logits (of ``want``) lie more than TOP1_GAP_STEPS bf16
    steps apart, and max |dlogit| <= ``max_steps`` bf16 steps at the
    largest logit; with ``mean_steps``, the mean |dlogit| bounded so
    too (a bound of None is not applied).  A miss is printed and
    appended to ``fails``; with ``fails=None`` the agreement is printed
    and not held."""
    import math

    want = want.to(got.dtype)
    top2 = torch.topk(want, 2, dim=-1).values.float()
    gap = top2[..., 0] - top2[..., 1]
    step = 2.0 ** (torch.floor(torch.log2(top2[..., 0].abs())) - 7)
    decided = gap > TOP1_GAP_STEPS * step
    top = float(want.abs().max())
    limit = LOGIT_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    same = got.argmax(-1) == want.argmax(-1)
    agree = float(same.float().mean())
    agree_dec = (float(same[decided].float().mean()) if bool(decided.any())
                 else 1.0)
    diffs = [(a.float() - b.float()).abs()
             for a, b in zip(got.split(256, 1), want.split(256, 1))]
    d_logit = max(float(d.max()) for d in diffs)
    d_mean = sum(float(d.sum()) for d in diffs) / want.numel()
    step_top = limit / LOGIT_STEPS
    ok = (agree_dec >= top1
          and (max_steps is None or d_logit <= max_steps * step_top)
          and (mean_steps is None or d_mean <= mean_steps * step_top))
    rule = ", ".join([f"top-1 {top1:.0%}"]
                     + ([f"max {max_steps} bf16 steps there "
                         f"({max_steps * step_top:.4f})"]
                        if max_steps is not None else [])
                     + ([f"mean {mean_steps} bf16 steps there "
                         f"({mean_steps * step_top:.4f})"]
                        if mean_steps is not None else []))
    print(f"[{tag}] {what}: top-1 agree on {agree:.4%} of "
          f"{same.numel()} positions, {agree_dec:.4%} of the "
          f"{int(decided.sum())} whose top two lie over {TOP1_GAP_STEPS} "
          f"steps apart; max |dlogit| {d_logit:.4f}, mean {d_mean:.5f} (max "
          f"|logit| {top:.3f}; limits: {rule}): "
          f"{'not held' if fails is None else 'ok' if ok else 'FAILED'}")
    if fails is not None and not ok:
        fails.append(f"{what}: top-1 {agree_dec}, max |dlogit| {d_logit}, "
                     f"mean {d_mean}")
    return {"top1": agree, "top1_decided": agree_dec,
            "max_dlogit": d_logit, "mean_dlogit": d_mean,
            "bf16_step": step_top, "ok": ok}


def decode_and_forward(torch, M, model, toks, dev):
    """(teacher-forced decode logits, forward logits) over ``toks``."""
    fw, _ = M.forward(model, toks)
    state = M.init_decode_state(model.cfg, toks.shape[0], toks.shape[1],
                                device=dev)
    steps = []
    for t in range(toks.shape[1]):
        lg, state = M.decode_step(model, state, toks[:, t:t + 1], t)
        steps.append(lg)
    return torch.stack(steps, 1), fw


def moe_by_depth(torch, registry, model, fwd, arch, fails) -> dict:
    """The MoE forward on its first d layers (d in MOE_DEPTHS), flash
    against use_flash=False and against the kernel's plain version in
    its place; held at MOE_CHECK_DEPTH (see MOE_MEAN_STEPS), printed at
    the others."""
    import dataclasses

    entry = registry.get("flash_attention")
    full = model.blocks
    out = {}
    try:
        for depth in MOE_DEPTHS:
            model.blocks = torch.nn.ModuleList(list(full)[:depth])
            held = fails if depth == MOE_CHECK_DEPTH else None
            a = fwd()[0]
            out[depth] = logits_agree(
                torch, f"{arch} first {depth} layers, flash vs "
                "use_flash=False", a, fwd(False)[0], held, max_steps=None,
                mean_steps=MOE_MEAN_STEPS)
            registry._REGISTRY["flash_attention"] = dataclasses.replace(
                entry, cuda=entry.ref)
            try:
                logits_agree(torch, f"{arch} first {depth} layers, flash vs "
                             "the kernel's plain version", a, fwd()[0], held,
                             max_steps=None, mean_steps=MOE_MEAN_STEPS)
            finally:
                registry._REGISTRY["flash_attention"] = entry
            del a
    finally:
        model.blocks = full
    return out


def mrope_positions(torch, b, grid, n_text, dev):
    """(3, b, grid^2 + n_text): a grid x grid patch image at (t = 0, h,
    w), then text whose t = h = w count on from the grid's largest
    position (Qwen2-VL's rule; the JAX package has none to port)."""
    hh, ww = torch.meshgrid(torch.arange(grid, device=dev),
                            torch.arange(grid, device=dev), indexing="ij")
    img = torch.stack([torch.zeros_like(hh).ravel(), hh.ravel(), ww.ravel()])
    text = (torch.arange(n_text, device=dev) + grid).expand(3, n_text)
    return torch.cat([img, text], 1)[:, None].expand(3, b, -1)


def family_breakdown(torch, dev, gen, smi) -> dict:
    """One layer of each family's own module at its full-width prefill
    shape, random weights (the init's scales), timed alone by CUDA
    events: the MoE FFN of moonshot-v1-16b-a3b against its three expert
    matmuls at capacity (the rest is routing, dispatch and combine), the
    RG-LRU of recurrentgemma-2b against its scan, and the sLSTM of
    xlstm-350m (its time loop).  These set the speed items that wait for
    a benchmark."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE, rglru as RG, xlstm as XL

    def drawn(module):
        for name, p in module.named_parameters():
            init, scale = module.INIT[name]
            if init != "normal":
                p.fill_(1.0 if init == "ones" else 0.0)
                continue
            scale = p.shape[0] ** -0.5 if scale is None else scale
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * scale)
        return module

    bf16 = torch.bfloat16
    out = {}
    cfg = get_config("moonshot-v1-16b-a3b")
    moe = drawn(MOE.MoE(cfg, bf16, dev))
    n = LM_BATCH * LM_SEQ
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=dev).to(bf16)
    cap = MOE._capacity(n, cfg)
    xe = torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen,
                     device=dev).to(bf16)
    moe_ms = cuda_ms(torch, lambda: MOE.run_moe(moe, cfg, x), 5)
    bmm_ms = cuda_ms(torch, lambda: torch.bmm(torch.nn.functional.silu(
        torch.bmm(xe, moe.w_gate)) * torch.bmm(xe, moe.w_up), moe.w_down), 5)
    out["moe_layer_ms"], out["moe_experts_ms"] = moe_ms, bmm_ms
    del moe, x, xe
    cfg = get_config("recurrentgemma-2b")
    rg = drawn(RG.RGLRU(cfg, bf16, dev))
    x = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(bf16)
    log_a, u = RG._gates(rg, cfg, x)
    rg_ms = cuda_ms(torch, lambda: RG.run_rglru(rg, cfg, x), 5)
    scan_ms = cuda_ms(torch, lambda: RG._scan(log_a, u), 5)
    out["rglru_layer_ms"], out["rglru_scan_ms"] = rg_ms, scan_ms
    del rg, x, log_a, u
    cfg = get_config("xlstm-350m")
    sl = drawn(XL.SLSTM(cfg, bf16, dev))
    x = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(bf16)
    sl_ms = cuda_ms(torch, lambda: XL.run_slstm(sl, cfg, x), 1)
    out["slstm_layer_ms"] = sl_ms
    del sl, x
    torch.cuda.empty_cache()
    print(f"[breakdown] one layer at ({LM_BATCH}, {LM_SEQ}), bf16, CUDA "
          f"events: MoE FFN (moonshot-v1-16b-a3b, capacity {cap}) "
          f"{moe_ms:.3f} ms, of which the three expert matmuls "
          f"{bmm_ms:.3f} ms (routing, dispatch and combine "
          f"{moe_ms - bmm_ms:.3f} ms); RG-LRU (recurrentgemma-2b) "
          f"{rg_ms:.3f} ms, of which the scan {scan_ms:.3f} ms; sLSTM "
          f"(xlstm-350m, {LM_SEQ} steps) {sl_ms:.1f} ms; {smi}")
    return out


def families_section(torch, dev, counters, smi) -> dict:
    """Section l: the other LM families at full width and depth, bf16,
    weights drawn on the card from a seed.  Each architecture's prefill
    at (2, 4096) (its first call on the host clock, then CUDA events),
    through the flash kernel once per attention layer without a window
    (every one on the tensor cores), against ``use_flash=False`` (the
    MoE on its first layer: :func:`moe_by_depth`); teacher-forced decode
    against forward for hybrid, ssm and vlm, in bf16 and f32;
    ``serve(arch, reduced=False)`` for the decoder families; one layer
    of each recurrent or MoE module alone; then the kernel at the flash
    families' layer shapes beside its bound, its plain version and
    scaled_dot_product_attention.  Every check is made before the first
    miss ends the section.  Returns the numbers by arch, the breakdown,
    the kernel's timing by shape and the launches by arch."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.config import layer_kinds

    t_section = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 22)
    fails: list[str] = []
    summary: dict = {"archs": {}, "kernel": {}}
    launches: dict = {}
    b, s = LM_BATCH, LM_SEQ
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        row: dict = {}
        torch.cuda.reset_peak_memory_stats()
        model, s_init = timed(torch, lambda: M.init_model(
            cfg, generator=gen, device=dev))
        n_params = sum(p.numel() for p in model.parameters())
        inputs: dict = {}
        if cfg.family == "audio":
            inputs["embeddings"] = torch.randn(
                (b, s, cfg.d_model), generator=gen, device=dev)
        elif cfg.family == "vlm":
            n_vis = VLM_GRID * VLM_GRID
            inputs["embeddings"] = torch.randn(
                (b, n_vis, cfg.d_model), generator=gen, device=dev)
            inputs["tokens"] = torch.randint(
                0, cfg.vocab, (b, s - n_vis), generator=gen, device=dev)
            inputs["mrope_positions"] = mrope_positions(
                torch, b, VLM_GRID, s - n_vis, dev)
        else:
            inputs["tokens"] = torch.randint(0, cfg.vocab, (b, s),
                                             generator=gen, device=dev)
        n_flash = sum(k == "attn" for k in layer_kinds(cfg))
        print(f"[families] {arch} ({cfg.family}, {cfg.n_layers} layers, d "
              f"{cfg.d_model}): {n_params} parameters ({cfg.dtype}) drawn "
              f"on the card in {s_init:.2f} s; inputs "
              + ", ".join(f"{k} {tuple(v.shape)}" for k, v in inputs.items()))

        def fwd(use_flash=True):
            return M.forward(model, inputs.get("tokens"), use_flash=use_flash,
                             **{k: v for k, v in inputs.items()
                                if k != "tokens"})

        counters.zero()
        (logits, aux), s_first = timed(torch, fwd)
        launched = counters.read()
        launches[arch] = launched["flash_attention"]
        require(launched["flash_attention"] == n_flash
                and launched["flash_attention_tc"] == n_flash
                and launched["flash_attention_ffma"] == 0,
                f"{arch} forward: flash_attention launches "
                f"{launched['flash_attention']} (tensor cores "
                f"{launched['flash_attention_tc']}, FFMA "
                f"{launched['flash_attention_ffma']}), want {n_flash} on "
                "the tensor cores")
        require(logits.shape == (b, s, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"{arch} forward: logits {tuple(logits.shape)} or not finite")
        require(set(aux) == ({"aux_loss", "drop_frac"} if cfg.is_moe
                             else set())
                and all(bool(torch.isfinite(v)) for v in aux.values()),
                f"{arch} forward: aux {aux}")
        # the sLSTM's time loop (12 x 4,096 eager steps) is host bound
        # and takes seconds: its first call is its time
        if cfg.family == "ssm":
            ms, clock = s_first * 1e3, "the first call"
        else:
            ms, clock = cuda_ms(torch, lambda: fwd()[0], 3, warm=0), \
                "repeated, CUDA events, 3 reps"
        row.update(params=n_params, init_s=s_init, first_s=s_first,
                   forward_ms=ms, prefill_tok_s=b * s / ms * 1e3,
                   flash_launches=launched["flash_attention"],
                   aux={k: float(v) for k, v in aux.items()})
        print(f"[families] {arch} forward ({b} x {s} tokens): first "
              f"{s_first:.3f} s (host clock, synchronized); {ms:.2f} ms "
              f"({clock}), "
              f"{b * s / ms * 1e3:.0f} prefill tokens/s; "
              f"{launched['flash_attention_tc']} flash_attention launches "
              f"on the tensor cores (want {n_flash}); aux "
              f"{row['aux']}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {smi}")
        if n_flash:
            before = counters.peek()["flash_attention"]
            (plain, _), s_plain = timed(torch, lambda: fwd(False))
            require(counters.peek()["flash_attention"] == before,
                    f"{arch}: use_flash=False launched flash_attention")
            row["plain_first_s"] = s_plain
            row["vs_plain"] = logits_agree(
                torch, f"{arch} forward, flash vs use_flash=False", logits,
                plain, None if cfg.is_moe else fails)
            del plain
        if cfg.is_moe:
            require(torch.equal(fwd()[0], logits),
                    f"{arch}: two forwards differ (the MoE combine must be "
                    "deterministic)")
            print(f"[families] {arch}: a second forward gives the same "
                  "logits bit for bit")
            row["vs_plain_by_depth"] = moe_by_depth(
                torch, registry, model, fwd, arch, fails)
        del logits
        if cfg.family in ("hybrid", "ssm", "vlm"):
            toks = torch.randint(0, cfg.vocab, (b, FAMILY_DECODE_LEN),
                                 generator=gen, device=dev)
            rule = ({"top1": SSM_DECODE_TOP1, "max_steps": None,
                     "mean_steps": SSM_DECODE_MEAN_STEPS}
                    if cfg.family == "ssm" else {})
            row["decode_vs_forward"] = logits_agree(
                torch, f"{arch} teacher-forced decode vs forward over "
                f"{FAMILY_DECODE_LEN} tokens", *decode_and_forward(
                    torch, M, model, toks, dev), fails, **rule)
            del model
            torch.cuda.empty_cache()
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            model = M.init_model(cfg32, generator=gen, device=dev)
            dec, fw = decode_and_forward(torch, M, model, toks, dev)
            d32 = float((dec - fw).abs().max())
            top = float(fw.abs().max())
            row["decode_vs_forward_f32"] = d32 / top
            print(f"[families] {arch} in f32 (full width and depth): "
                  f"teacher-forced decode vs forward over "
                  f"{FAMILY_DECODE_LEN} tokens max |dlogit| {d32:.3e} (max "
                  f"|logit| {top:.3f}, limit 1e-3 of it)")
            if d32 > 1e-3 * top:
                fails.append(f"{arch} f32 decode vs forward: {d32}")
            del dec, fw
        del model, inputs
        torch.cuda.empty_cache()
        if cfg.family != "audio":
            counters.zero()
            (gen_toks, timing), s_serve = timed(torch, lambda: serve(
                arch, reduced=False, seed=SEED))
            launched = counters.read()
            require(tuple(gen_toks.shape) == (4, 32)
                    and int(gen_toks.min()) >= 0
                    and int(gen_toks.max()) < cfg.vocab,
                    f"{arch} serve: tokens")
            require(launched["flash_attention"] == 0,
                    f"{arch} serve: decode launched flash_attention")
            row.update(serve_s=s_serve, decode_tok_s=timing["decode_tok_s"],
                       serve_prefill_tok_s=timing["prefill_tok_s"])
            print(f"[families] serve({arch!r}, reduced=False): batch 4, "
                  f"prompt 16, generate 32: prefill "
                  f"{timing['prefill_s']:.3f} s "
                  f"({timing['prefill_tok_s']:.1f} tok/s), decode "
                  f"{timing['decode_tok_s']:.1f} tok/s; {s_serve:.2f} s "
                  f"in all, with the model's draw; {smi}")
            torch.cuda.empty_cache()
        summary["archs"][arch] = row

    summary["breakdown"] = family_breakdown(torch, dev, gen, smi)

    # the kernel at the flash families' layer shapes: bound, plain version,
    # scaled_dot_product_attention
    for arch, (fb, hq, hk, fs, d, causal) in FAMILY_FLASH.items():
        q, k, v = [torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((fb, hq, fs, d), (fb, hk, fs, d),
                                          (fb, hk, fs, d))]
        t_ops, t_bytes = flash_bound_ms(fb, hq, hk, fs, d, causal)
        padded = flash_bound_ms(fb, hq, hk, fs, 128, causal)[0]
        ms = cuda_ms(torch, lambda: fa_ops.flash_attention(
            q, k, v, causal=causal), 20)
        plain_ms = cuda_ms(torch, lambda: flash_attention_ref(
            q, k, v, causal=causal), 2)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20)
        ms2 = cuda_ms(torch, lambda: fa_ops.flash_attention(
            q, k, v, causal=causal), 20)
        shape = (fb, hq, hk, fs, d)
        summary["kernel"][arch] = {
            "shape": list(shape), "causal": causal, "ms": ms,
            "ms_again": ms2, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
            "bytes_ms": t_bytes, "ops_ms_at_d128": padded,
            "launches_per_forward": launches[arch]}
        print(f"[timing] flash_attention {shape} bf16 "
              f"{'causal' if causal else 'non-causal'} ({arch}), "
              f"tensor-core kernel: {ms:.4f} ms (CUDA events; {ms2:.4f} ms "
              f"again), {max(t_ops, t_bytes) / ms:.1%} of the bound "
              f"{max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f}, bytes "
              f"{t_bytes:.4f}; operations at D = 128 {padded:.4f}); plain "
              f"{plain_ms:.3f} ms; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms; {smi}")
        del q, k, v
        torch.cuda.empty_cache()
    summary["launches"] = launches
    summary["seconds"] = time.perf_counter() - t_section
    print(json.dumps({"families_section": summary}))
    print(f"[families] section l took {summary['seconds']:.1f} s")
    require(not fails, "section l: " + "; ".join(fails))
    return summary


# ---------------------------------------------------------------------------
# m. LM training at full width: stablelm-1.6b (the reference training
# driver's default arch) in bf16 at train_4k's sequence, 8 sequences a step
# in 4 micro-batches of (2, 4096); the backward kernel at the training
# shape and beside it.
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 8, 4, 4
# (B, Hq, Hk, S, D, causal): stablelm's layer, qwen3-8b's GQA, hubert's
# non-causal D = 80, a ragged S at D = 16 and stablelm's layer at
# launch.train's defaults (8 sequences of 128), each in f32 and bf16.  The
# forward kernel is held at each of them too: the train steps and the
# driver launch it at the first and the last.
BWD_SHAPES = ((LM_BATCH, 32, 32, LM_SEQ, 64, True),
              (LM_BATCH, 32, 8, LM_SEQ, 128, True),
              (LM_BATCH, 16, 16, LM_SEQ, 80, False),
              (LM_BATCH, 8, 2, 1000, 16, True),
              (TRAIN_BATCH, 32, 32, 128, 64, True))
# The backward kernel against its plain version: both compute in f32 from
# the same inputs and sum over up to S products in other orders, so in f32
# they differ by a few ulps of the largest entry (held within BWD_F32_REL
# of max |plain| per output); in bf16 both round dq, dk and dv once, so
# they may differ by one bf16 step: 2^-7 x max |plain|.
BWD_F32_REL = 1e-4
BWD_BF16_REL = 2.0 ** -7
# The forward's log-sum-exp (the backward's input) against torch.logsumexp
# of the plain version's f32 logits: both sum exponentials of the same f32
# scores in other orders (the tensor cores' in base 2), within LSE_REL of
# max(1, |lse|) per row.
LSE_REL = 2e-5
# The flash path against use_flash=False in bf16, at full width and depth,
# on step 1's first micro-batch: attention_chunked rounds the pre-scaled q
# and p to bf16 where the kernels keep f32, and the two differ by about a
# bf16 step in each layer's attention output.  The loss is a mean over
# 8,192 positions of such differences carried to the logits, so it may
# move by a fraction of one bf16 step of itself (held within
# TRAIN_LOSS_REL); each gradient leaf is a sum of per-position products
# that each carry a few bf16 steps of error, so the two leaves point the
# same way: their cosine similarity is held to TRAIN_COS_MIN.
TRAIN_LOSS_REL = 2.0 ** -7
TRAIN_COS_MIN = 0.99
# In f32, at two full-width layers: the two paths sum the same f32
# products in other orders (section g's f32 rule), every gradient within
# TRAIN_F32_REL of its leaf's max |use_flash=False|.
TRAIN_F32_REL = 1e-3
TRAIN_F32_LAYERS = 2
# the schedule of the full-width steps: warmup 1, cosine to TRAIN_STEPS
TRAIN_LR = 3e-4
TRAIN_INIT_SEED = SEED + 230


def bwd_bound_ms(b, hq, hk, s, d, causal, elt_bytes, peak):
    """(operations ms, bytes ms) of the attention backward: the kernel
    package's ``backward_cost`` (its five products are 2.5 x the forward's
    operations; q, k, v, o, dO read once and dq, dk, dv written once,
    ``elt_bytes`` an element) over ``peak`` and the memory rate."""
    from repro_torch.kernels.flash_attention.ops import backward_cost
    ops, nbytes = backward_cost(b, hq, hk, s, d, causal, elt_bytes)
    return ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def sdpa_bwd_ms(torch, F, q, k, v, do, causal: bool, reps: int) -> float:
    """CUDA-event ms of the backward of scaled_dot_product_attention on
    the same inputs, its forward outside the timed region."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                       enable_gqa=True)
    return cuda_ms(torch, lambda: torch.autograd.grad(
        o, (qs, ks, vs), do, retain_graph=True), reps)


def leaf_cosines(torch, got, want) -> list[float]:
    """The cosine similarity of each pair of gradient leaves, in f32."""
    out = []
    for a, b in zip(got, want):
        a, b = a.float().reshape(-1), b.float().reshape(-1)
        norms = torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)
        out.append(float(torch.dot(a, b) / norms.clamp(min=1e-30)))
    return out


def train_section(torch, dev, counters, errs, smi) -> dict:
    """Section m, LM training on the card: the backward kernel against its
    plain version at BWD_SHAPES in f32 and bf16 (and a second call bitwise
    the first), timed beside its bound, the plain version and SDPA's
    backward, and the forward kernel against its plain version on the
    same inputs; stablelm-1.6b at full width and depth in bf16 against
    ``use_flash=False`` on one micro-batch (loss, per-leaf gradient cosine),
    TRAIN_STEPS steps of ``make_train_step(grad_accum=TRAIN_ACCUM)`` on
    batches of TRAIN_BATCH x LM_SEQ from ``TokenStream`` (the main path:
    counters zeroed before and read after), the micro-batch check again at
    the trained weights, the same steps with ``use_flash=False`` (losses
    compared), two f32 layers against
    ``use_flash=False``; ``launch.train --full --steps 4`` in-process (its
    corpus profile through ``countmin``), and a checkpoint round trip and
    resume at the reduced config under ``build/``.  Every check is made
    before the first miss ends the section.  Returns the backward kernel's
    row and the launches by step."""
    import dataclasses
    import functools
    import math
    import shutil
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import TokenStream, make_lm_batches
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed.sharding import as_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref, flash_attention_ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state, make_train_step

    t_section = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    fails: list[str] = []
    out: dict = {"kernel": {}, "steps": []}

    # -- the backward kernel against its plain version ----------------------
    for shape in BWD_SHAPES:
        b, hq, hk, s, d, causal = shape
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            # (B, S, H, D) storage seen through transpose(1, 2), as the
            # model's projections give them
            q, k, v, do = [torch.randn((b, s, h, d), generator=gen,
                                       device=dev).to(dtype).transpose(1, 2)
                           for h in (hq, hk, hk, hq)]
            # the forward kernel on these inputs (tensor cores in bf16, FFMA
            # in f32, as in the model) against its plain version, to
            # section g's limits
            path = "ffma" if dtype == torch.float32 else "tc"
            tc0 = fa_ops.flash_attention_tc_launches
            ffma0 = fa_ops.flash_attention_ffma_launches
            o, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                            return_lse=True)
            ran = (fa_ops.flash_attention_tc_launches - tc0,
                   fa_ops.flash_attention_ffma_launches - ffma0)
            # the output without lse: the same bits
            same_fwd = torch.equal(o, fa_ops.flash_attention(
                q, k, v, causal=causal))
            o_plain, lse_plain = flash_attention_ref(q, k, v, causal=causal,
                                                     return_lse=True)
            e_lse = float(((lse - lse_plain).abs()
                           / lse_plain.abs().clamp(min=1.0)).max())
            del lse_plain
            e_fwd = float((o.float() - o_plain.float()).abs().max())
            s_fwd = float(o_plain.float().abs().max())
            if dtype == torch.float32:
                row_fwd = None
                fwd_ok = e_fwd <= FLASH_F32_ATOL
            else:
                row_fwd = bf16_row_ratio(torch, o, o_plain)
                fwd_ok = (e_fwd <= FLASH_BF16_RTOL * s_fwd
                          and row_fwd <= FLASH_BF16_RTOL)
            del o_plain
            errs["flash_attention"] = max(errs["flash_attention"], e_fwd)
            print(f"[train] flash_attention (forward) {tuple(shape[:5])} "
                  f"{name} {'causal' if causal else 'non-causal'}, {path} "
                  f"kernel: max |kernel - plain| {e_fwd:.3e} (max |plain| "
                  f"{s_fwd:.3e}"
                  + ("" if row_fwd is None else
                     f"; worst row {row_fwd:.3e} of its max |plain|")
                  + f"); lse within {e_lse:.3e} of max(1, |plain "
                  f"logsumexp|) (limit {LSE_REL:.0e}); output without lse "
                  f"bitwise {same_fwd}")
            if ran != ((0, 1) if path == "ffma" else (1, 0)):
                fails.append(f"flash_attention {shape} {name}: launches "
                             f"(tc, ffma) {ran}, want one on {path}")
            if not (e_lse <= LSE_REL and same_fwd):
                fails.append(f"flash_attention {shape} {name}: lse within "
                             f"{e_lse} of the plain logsumexp (limit "
                             f"{LSE_REL}); output without lse bitwise "
                             f"{same_fwd}")
            if not fwd_ok:
                fails.append(f"flash_attention {shape} {name}: max |kernel "
                             f"- plain| {e_fwd} (max |plain| {s_fwd}, worst "
                             f"row {row_fwd})")
            bwd0 = (fa_ops.flash_attention_bwd_tc_launches,
                    fa_ops.flash_attention_bwd_ffma_launches)
            got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                             causal=causal)
            ran_bwd = (fa_ops.flash_attention_bwd_tc_launches - bwd0[0],
                       fa_ops.flash_attention_bwd_ffma_launches - bwd0[1])
            again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse,
                                               causal=causal)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            rel = BWD_F32_REL if dtype == torch.float32 else BWD_BF16_REL
            errs_k = [float((x.float() - y.float()).abs().max())
                      for x, y in zip(got, want)]
            scales = [float(y.float().abs().max()) for y in want]
            ok = all(e <= rel * sc for e, sc in zip(errs_k, scales))
            del got, want
            torch.cuda.empty_cache()
            ms = cuda_ms(torch, lambda: fa_ops.flash_attention_bwd(
                q, k, v, o, do, lse, causal=causal), 3)
            elt = 4 if dtype == torch.float32 else 2
            peak = PEAK_F32_FLOPS if dtype == torch.float32 \
                else PEAK_BF16_FLOPS
            t_ops, t_bytes = bwd_bound_ms(b, hq, hk, s, d, causal, elt, peak)
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            lib_ms = sdpa_bwd_ms(torch, F, q, k, v, do, causal, 3)
            out["kernel"][f"{tuple(shape)} {name}"] = {
                "shape": list(shape[:5]), "causal": causal, "dtype": name,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by, "ops_ms": t_ops,
                "bytes_ms": t_bytes, "max_abs_err": max(errs_k),
                "rel_err": [e / sc for e, sc in zip(errs_k, scales)],
                "bitwise_repeat": same, "forward_max_abs_err": e_fwd,
                "forward_lse_rel_err": e_lse, "path": path}
            print(f"[train] flash_attention_bwd {tuple(shape[:5])} {name} "
                  f"{'causal' if causal else 'non-causal'}: {path} "
                  f"backward (launches tc, ffma {ran_bwd}): kernel "
                  f"{ms:.3f} ms (CUDA events), bound {bound:.4f} ms ({by}; "
                  f"{bound / ms:.2%} of it), plain {plain_ms:.2f} ms, SDPA "
                  f"backward {lib_ms:.4f} ms; max |err| dq/dk/dv "
                  + "/".join(f"{e:.3e}" for e in errs_k)
                  + " against max |plain| "
                  + "/".join(f"{sc:.3e}" for sc in scales)
                  + f" (limit {rel:.1e} of it); second call bitwise "
                  f"{same}; {smi}")
            if ran_bwd != ((0, 1) if path == "ffma" else (1, 0)):
                fails.append(f"flash_attention_bwd {shape} {name}: launches "
                             f"(tc, ffma) {ran_bwd}, want one on {path}")
            if not ok:
                fails.append(f"flash_attention_bwd {shape} {name}: errors "
                             f"{errs_k} exceed {rel} x {scales}")
            if not same:
                fails.append(f"flash_attention_bwd {shape} {name}: a second "
                             "call differs from the first")
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    main_key = f"{tuple(BWD_SHAPES[0])} bf16"
    errs["flash_attention_bwd"] = out["kernel"][main_key]["max_abs_err"]

    # -- stablelm-1.6b at full width and depth, bf16 --------------------------
    cfg = get_config(TRAIN_ARCH)

    def fresh_state():
        """The train state drawn from TRAIN_INIT_SEED: the same weights
        each call."""
        g = torch.Generator(device=dev)
        g.manual_seed(TRAIN_INIT_SEED)
        return init_train_state(cfg, generator=g, device=dev)

    def lm_batches():
        return make_lm_batches(TokenStream(
            vocab=cfg.vocab, seq_len=LM_SEQ, batch=TRAIN_BATCH, seed=SEED),
            device=dev)

    def steps_fn():
        return make_train_step(cfg, base_lr=TRAIN_LR, warmup=1,
                               total_steps=TRAIN_STEPS,
                               grad_accum=TRAIN_ACCUM)

    def flash_vs_plain(model, batch, what):
        """Loss and gradient of ``batch``'s first micro-batch through the
        flash kernels and through ``use_flash=False``: the loss within
        TRAIN_LOSS_REL, each leaf's cosine at least TRAIN_COS_MIN."""
        mb = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
        leaves = list(model.parameters())
        names = [n for n, _ in model.named_parameters()]

        def loss_grads(use_flash):
            total, _ = M.train_loss(model, mb, use_flash=use_flash)
            return float(total.detach()), torch.autograd.grad(total, leaves)

        (l_fl, g_fl), s_fl = timed(torch, lambda: loss_grads(True))
        (l_pl, g_pl), s_pl = timed(torch, lambda: loss_grads(False))
        cos = leaf_cosines(torch, g_fl, g_pl)
        del g_fl, g_pl
        torch.cuda.empty_cache()
        i_min = min(range(len(cos)), key=cos.__getitem__)
        d_loss = abs(l_fl - l_pl)
        print(f"[train] flash vs use_flash=False {what}, bf16, micro-batch "
              f"({TRAIN_BATCH // TRAIN_ACCUM}, {LM_SEQ}): loss {l_fl:.6f} vs "
              f"{l_pl:.6f} (|diff| {d_loss:.3e}, limit "
              f"{TRAIN_LOSS_REL * abs(l_pl):.3e}); gradient cosine per leaf: "
              f"min {cos[i_min]:.6f} ({names[i_min]}), mean "
              f"{sum(cos) / len(cos):.6f} over {len(cos)} leaves (floor "
              f"{TRAIN_COS_MIN}); loss and gradient {s_fl:.2f} s (flash) vs "
              f"{s_pl:.2f} s (chunked), host clock")
        if not (math.isfinite(l_fl) and d_loss <= TRAIN_LOSS_REL * abs(l_pl)):
            fails.append(f"train flash vs use_flash=False {what}: loss {l_fl} "
                         f"vs {l_pl}")
        if not cos[i_min] >= TRAIN_COS_MIN:
            fails.append(f"train flash vs use_flash=False {what}: gradient "
                         f"cosine {cos[i_min]} at {names[i_min]}")
        return {"loss": [l_fl, l_pl], "min_cos": cos[i_min],
                "min_cos_leaf": names[i_min], "seconds": [s_fl, s_pl]}

    torch.cuda.reset_peak_memory_stats()
    state, s_init = timed(torch, fresh_state)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[train] {TRAIN_ARCH}: {n_params} parameters ({cfg.dtype}, remat "
          f"{cfg.remat}) and f32 AdamW moments on the card in {s_init:.2f} s")
    batches = lm_batches()
    first = next(batches)
    # the flash path against use_flash=False on step 1's first micro-batch
    out["flash_vs_plain"] = flash_vs_plain(state.model, first, "at init")

    # the main path: TRAIN_STEPS steps of TRAIN_ACCUM micro-batches
    step_fn = steps_fn()
    tokens = TRAIN_BATCH * LM_SEQ
    want_bwd = cfg.n_layers * TRAIN_ACCUM
    want_fwd = want_bwd * (2 if cfg.remat else 1)
    batch = first
    counters.zero()
    for i in range(TRAIN_STEPS):
        if i:
            batch = next(batches)
        before = counters.peek()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = step_fn(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in counters.peek().items()}
        rec = {"seconds": sec, "tokens_s": tokens / sec,
               "loss": float(mets["loss"]),
               "grad_norm": float(mets["grad_norm"]), "lr": float(mets["lr"]),
               "flash_fwd": got["flash_attention"],
               "flash_fwd_tc": got["flash_attention_tc"],
               "flash_bwd": got["flash_attention_bwd"],
               "flash_bwd_tc": got["flash_attention_bwd_tc"],
               "flash_bwd_ffma": got["flash_attention_bwd_ffma"]}
        out["steps"].append(rec)
        print(f"[train] step {i}: {sec:.3f} s ({rec['tokens_s']:.0f} tokens/s,"
              f" host clock, synchronized); loss {rec['loss']:.6f}, "
              f"grad_norm {rec['grad_norm']:.6f}, lr {rec['lr']:.3e}; flash "
              f"forward {rec['flash_fwd']} ({rec['flash_fwd_tc']} on tensor "
              f"cores), backward {rec['flash_bwd']} "
              f"({rec['flash_bwd_tc']} on tensor cores, "
              f"{rec['flash_bwd_ffma']} FFMA)")
        if not (math.isfinite(rec["loss"])
                and math.isfinite(rec["grad_norm"])):
            fails.append(f"train step {i}: loss {rec['loss']}, grad_norm "
                         f"{rec['grad_norm']}")
        if (rec["flash_bwd"], rec["flash_bwd_tc"], rec["flash_bwd_ffma"],
                rec["flash_fwd"], rec["flash_fwd_tc"]) != (
                want_bwd, want_bwd, 0, want_fwd, want_fwd):
            fails.append(f"train step {i}: flash launches forward "
                         f"{rec['flash_fwd']} (tc {rec['flash_fwd_tc']}), "
                         f"backward {rec['flash_bwd']} (tc "
                         f"{rec['flash_bwd_tc']}, ffma "
                         f"{rec['flash_bwd_ffma']}); want {want_fwd} and "
                         f"{want_bwd}, all on the tensor cores")
    launched = counters.read()
    batches.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    later = out["steps"][1:] or out["steps"]
    mean_s = sum(r["seconds"] for r in later) / len(later)
    out["train"] = {"arch": TRAIN_ARCH, "params": n_params,
                    "batch": [TRAIN_BATCH, LM_SEQ],
                    "grad_accum": TRAIN_ACCUM, "step_s": mean_s,
                    "tokens_s": tokens / mean_s, "peak_gb": peak_gb,
                    "launches": {k: launched[k] for k in (
                        "flash_attention", "flash_attention_tc",
                        "flash_attention_bwd", "flash_attention_bwd_tc",
                        "flash_attention_bwd_ffma")}}
    print(f"[train] {TRAIN_ARCH} bf16, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {LM_SEQ} tokens ({TRAIN_ACCUM} micro-batches): "
          f"{mean_s:.3f} s a step after the first ({tokens / mean_s:.0f} "
          f"tokens/s), peak {peak_gb:.2f} GB (max_memory_allocated); "
          f"{smi}")
    # the gradient once the weights have left their init: the last step's
    # batch at the weights the steps left
    out["flash_vs_plain_trained"] = flash_vs_plain(
        state.model, batch, f"after {TRAIN_STEPS} steps")
    del state, step_fn, batch, first, mets
    gc.collect()
    torch.cuda.empty_cache()

    # the witness of the loss's course: the same steps from the same
    # weights on the same batches with every attention on use_flash=False
    # (attention_chunked under autograd, no flash kernel).  Steps 0 and 1
    # see the initial weights (step 0's lr is 0), so their losses are held
    # within TRAIN_LOSS_REL as at init; after the first update the two runs'
    # weights part where AdamW's first step, lr sign(g), meets a gradient
    # within bf16 rounding of zero, so later losses are reported side by
    # side, not held.
    state, step_fn, batches = fresh_state(), steps_fn(), lm_batches()
    before = counters.peek()
    plain_losses = []
    with mock.patch.object(M, "train_loss", functools.partial(
            M.train_loss, use_flash=False)):
        for i in range(TRAIN_STEPS):
            state, mets = step_fn(state, next(batches))
            plain_losses.append(float(mets["loss"]))
    batches.close()
    flash_ran = {k: v - before[k] for k, v in counters.peek().items()
                 if k.startswith("flash") and v != before[k]}
    flash_losses = [r["loss"] for r in out["steps"]]
    out["plain_steps"] = {"loss": plain_losses, "flash_loss": flash_losses}
    print(f"[train] the same {TRAIN_STEPS} steps with use_flash=False: "
          f"losses {[round(x, 6) for x in plain_losses]} against the flash "
          f"path's {[round(x, 6) for x in flash_losses]}; flash launches "
          f"{flash_ran or 0}")
    if not (all(map(math.isfinite, plain_losses)) and not flash_ran
            and all(abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in
                    zip(flash_losses[:2], plain_losses[:2]))):
        fails.append(f"train use_flash=False steps: losses {plain_losses} "
                     f"against {flash_losses}, flash launches {flash_ran}")
    del state, step_fn, mets
    gc.collect()
    torch.cuda.empty_cache()

    # two f32 layers at full width: flash (FFMA forward, backward kernel)
    # against use_flash=False (attention_chunked in f32)
    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                                dtype="float32")
    model = M.init_model(cfg32, generator=gen, device=dev)
    model.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                         device=dev)
    mb = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
          "mask": torch.ones(toks.shape, device=dev)}
    params32 = list(model.parameters())
    grads = []
    for use_flash in (True, False):
        total, _ = M.train_loss(model, mb, use_flash=use_flash)
        grads.append(torch.autograd.grad(total, params32))
    rel32 = [float((a - b).abs().max()) / float(b.abs().max())
             for a, b in zip(*grads)]
    print(f"[train] {TRAIN_F32_LAYERS} f32 layers at full width: flash "
          f"against use_flash=False, max |dgrad| / max |grad| per leaf at "
          f"most {max(rel32):.3e} (limit {TRAIN_F32_REL})")
    out["f32_max_rel"] = max(rel32)
    if not max(rel32) <= TRAIN_F32_REL:
        fails.append(f"train f32 layers: gradients differ by {max(rel32)} "
                     "of their max")
    del model, grads, params32, mb, toks
    gc.collect()
    torch.cuda.empty_cache()

    # the driver as a user runs it: the reference's defaults (batch 8, seq
    # 128), the corpus profile on
    meshes = []
    real_jit = launch_train.jit_train_step

    def spy(step, st, axes, spec, m, rules=None):
        meshes.append([str(d) for d in m.devices.flat])
        return real_jit(step, st, axes, spec, m, rules)

    counters.zero()
    with mock.patch.object(launch_train, "jit_train_step", spy):
        losses, s_drv = timed(torch, lambda: launch_train.main(
            ["--arch", TRAIN_ARCH, "--full", "--steps", "4"]))
    drv = counters.read()
    out["driver"] = {"losses": losses, "seconds": s_drv, "meshes": meshes,
                     "launches": {k: drv[k] for k in (
                         "countmin", "flash_attention",
                         "flash_attention_bwd", "flash_attention_bwd_tc")}}
    print(f"[train] launch.train --arch {TRAIN_ARCH} --full --steps 4: "
          f"losses {[round(x, 4) for x in losses]}, {s_drv:.2f} s; launches "
          f"countmin {drv['countmin']}, flash forward "
          f"{drv['flash_attention']}, backward {drv['flash_attention_bwd']} "
          f"({drv['flash_attention_bwd_tc']} on tensor cores); mesh "
          f"{meshes}")
    if not (len(losses) == 4 and all(map(math.isfinite, losses))
            and meshes == [[str(as_device(dev))]]
            and drv["countmin"] == 2
            and drv["flash_attention_bwd"] == 4 * cfg.n_layers
            and drv["flash_attention_bwd_tc"] == 4 * cfg.n_layers):
        fails.append(f"launch.train: losses {losses}, launches {drv}")
    gc.collect()
    torch.cuda.empty_cache()

    # a checkpoint round trip and a resume at the reduced config, in build/
    d = ROOT / "build" / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    rcfg = reduced_config(TRAIN_ARCH)
    src = init_train_state(rcfg, generator=gen, device=dev)
    dst = init_train_state(rcfg, generator=gen, device=dev)
    ckpt.save(str(d), src, 3)
    ckpt.restore(str(d), dst)
    flat_src, flat_dst = ckpt._flatten(src), ckpt._flatten(dst)
    round_trip = all(torch.equal(flat_src[k], flat_dst[k]) for k in flat_src)
    shutil.rmtree(d)
    kw = dict(batch=2, seq=32, ckpt_dir=str(d), base_lr=1e-3,
              profile_data=False, log_every=100)
    l1 = launch_train.train(TRAIN_ARCH, steps=6, ckpt_every=3, **kw)
    l2 = launch_train.train(TRAIN_ARCH, steps=9, resume=True, **kw)
    resumed = ckpt.latest_step(str(d))
    shutil.rmtree(d)
    print(f"[train] checkpoint at the reduced config: restore bitwise "
          f"{round_trip}; resume from step 6 ran {len(l2)} steps to "
          f"{resumed}, first loss {l2[0]:.4f} against {l1[0]:.4f} at step 0")
    if not (round_trip and len(l1) == 6 and len(l2) == 3 and resumed == 9
            and l2[0] < l1[0]):
        fails.append(f"checkpoint: round trip {round_trip}, losses {l1} then "
                     f"{l2}, latest step {resumed}")
    del src, dst, flat_src, flat_dst
    gc.collect()
    torch.cuda.empty_cache()

    k_main = out["kernel"][main_key]
    steps_key = (f"m {TRAIN_ARCH} train steps {tuple(BWD_SHAPES[0][:5])} "
                 "causal")
    drv_key = "m launch.train --full (8, 32, 32, 128, 64) causal"
    out["row"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
        "ffma_source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "launches_tc": launched["flash_attention_bwd_tc"]
        + drv["flash_attention_bwd_tc"],
        "launches_ffma": launched["flash_attention_bwd_ffma"]
        + drv["flash_attention_bwd_ffma"],
        "replaces": "src/repro/models/layers.py:170",
        "launches": launched["flash_attention_bwd"]
        + drv["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"], "ms": k_main["ms"],
        "plain_ms": k_main["plain_ms"], "bound_ms": k_main["bound_ms"],
        "bound_by": k_main["bound_by"], "library_ms": k_main["library_ms"],
        "shape": k_main["shape"], "ops_ms": k_main["ops_ms"],
        "bytes_ms": k_main["bytes_ms"],
        "bound_share": k_main["bound_ms"] / k_main["ms"],
        "launches_by_shape": {steps_key: launched["flash_attention_bwd"],
                              drv_key: drv["flash_attention_bwd"]},
        "shapes": out["kernel"]}
    out["flash_launches"] = {
        steps_key + " (forward twice under remat)": launched[
            "flash_attention"],
        drv_key: drv["flash_attention"]}
    out["countmin_launches"] = {"m launch.train corpus_profile":
                                drv["countmin"]}
    out["seconds"] = time.perf_counter() - t_section
    print(json.dumps({"train_section": {k: v for k, v in out.items()
                                        if k != "row"}}))
    print(f"[train] section m took {out['seconds']:.1f} s")
    require(not fails, "section m: " + "; ".join(fails))
    return out


# h. the analytics server: sessions on threads against one server, on a
# dyadic 10M x 160 table with the main path's Zipf items
SERVER_SESSIONS, SERVER_ROUNDS = 8, 4
SERVER_APPEND = 100_000            # 1% of the rows, after round 2
DIM_ROWS, DIM_KEY_SPACE = 100_000, 2 ** 24


def tree_equal(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def server_section(torch, dev, counters, errs, item, smi) -> dict:
    """The analytics server at full width: 8 analyst sessions on threads,
    one ``AnalyticsServer(drain="thread")``, 4 rounds of profile, linregr,
    Count-Min and FM with an append after round 2; a living
    ``linregr_grouped`` view brought current by a delta fold; a star join
    (10M-row fact, 100,000-row dimension).  Each main-path step (the
    view's build, each round, the view's delta answer, the joined batch,
    ``linregr_joined``) runs between a zero and a read of the launch
    counters; the checks run outside them, and hold every kernel at the
    shapes this phase gives it against its plain version (``errs``).
    Returns the main-path launches by step and pinned host copies of the
    table's first ``n`` rows (``x``, ``y``, ``item``) for section i."""
    import threading
    from repro_torch.core import (
        AnalyticsServer, GroupedScanAgg, Join, JoinedGroupedScanAgg,
        Session, Table, execute, materialize, run_grouped, run_local,
        trace_execution)
    from repro_torch.methods.linregr import (
        LinregrAggregate, linregr_joined)
    from repro_torch.methods.sketches import CountMinAggregate
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    n = item.shape[0]
    td = Table({"x": dyadic(torch, gen, (n, K_MAIN), dev),
                "y": dyadic(torch, gen, (n,), dev), "item": item,
                "g": torch.randint(0, G_MAIN, (n,), generator=gen,
                                   dtype=torch.int32, device=dev)})
    torch.cuda.synchronize()
    steps: dict[str, dict[str, int]] = {}

    def main_step(label, fn):
        """``fn()`` on the main path, its launches kept under ``label``."""
        counters.zero()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = {k: v for k, v in counters.read().items() if v}
        return out

    def hold(name, what, kernel, plain):
        """A kernel's fold state against its plain version's on the same
        inputs, bitwise (dyadic values, integer counts)."""
        torch.cuda.synchronize()
        got, want = tree_leaves(kernel), tree_leaves(plain)
        require(len(got) == len(want), f"{name} {what}: states differ")
        err = max(bitwise(torch, f"{name} {what}", a, b)
                  for a, b in zip(got, want))
        errs[name] = max(errs[name], err)
        print(f"[server] {name} {what}: bitwise equal to the plain version")

    def mix(sess):
        return [sess.profile(td), sess.linregr(td, use_kernel=True),
                sess.scan(CountMinAggregate(use_kernel=True), td,
                          columns=("item",), label="countmin"),
                sess.fm_distinct_count(td)]

    def grouped_node():
        return GroupedScanAgg(LinregrAggregate(use_kernel=True), td, "g",
                              G_MAIN, columns={"x": "x", "y": "y"})

    torch.cuda.reset_peak_memory_stats()
    srv = AnalyticsServer(drain="thread", window_timeout=0.05)
    try:
        view, s_view = timed(torch, lambda: main_step(
            f"view build ({n}, {K_MAIN}), G {G_MAIN}",
            lambda: Session(server=srv).materialize(grouped_node())))
        print(f"[server] living view linregr_grouped (G = {G_MAIN}) built "
              f"by a full fold: {s_view:.3f} s (host clock, synchronized); "
              f"{smi}")
        sessions = [Session(server=srv) for _ in range(SERVER_SESSIONS)]
        answers: dict = {}
        local = {}
        for rnd in range(1, SERVER_ROUNDS + 1):
            if rnd == 3:
                rows = {"x": dyadic(torch, gen, (SERVER_APPEND, K_MAIN), dev),
                        "y": dyadic(torch, gen, (SERVER_APPEND,), dev),
                        "item": item[:SERVER_APPEND].flip(0).contiguous(),
                        "g": torch.randint(0, G_MAIN, (SERVER_APPEND,),
                                           generator=gen, dtype=torch.int32,
                                           device=dev)}
                evicted = srv.stats["evicted"]
                _, s_app = timed(torch, lambda: td.append(rows))
                require(srv.stats["evicted"] - evicted == 4,
                        f"append evicted {srv.stats['evicted'] - evicted} "
                        "cache entries, want 4")
                print(f"[server] append of {SERVER_APPEND} dyadic rows: "
                      f"{s_app:.3f} s, table version {td.version}, 4 cache "
                      f"entries evicted; {smi}")
            errors: list = []

            def analyst(i):
                try:
                    hs = mix(sessions[i])
                    for h in hs:
                        if hasattr(h, "wait") and not h.wait(120):
                            raise RuntimeError("the drainer never fired")
                    answers[i] = [h.result(timeout=120) for h in hs]
                except Exception as e:  # reported on the main thread
                    errors.append(e)

            def serve_round():
                threads = [threading.Thread(target=analyst, args=(i,),
                                            daemon=True)
                           for i in range(SERVER_SESSIONS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(300)
                return threads

            with trace_execution() as tr:
                threads, s_round = timed(torch, lambda: main_step(
                    f"round {rnd} ({td.n_rows}, {K_MAIN})", serve_round))
            require(not errors and not any(th.is_alive() for th in threads),
                    f"server round {rnd}: {errors}")
            adm = [e.detail for e in tr.admissions]
            summ = tr.summary()
            planned = sum(a["planned"] for a in adm)
            require(all(a["passes"] <= 1 for a in adm)
                    and len(tr.scans) == sum(a["passes"] for a in adm),
                    f"server round {rnd}: windows {adm}, scans "
                    f"{len(tr.scans)}: a window took more than one scan")
            # a fresh version plans each of the 4 statements once, in one
            # scan per window that planned any; the rounds on an unchanged
            # version are answered from the cache
            fresh = rnd in (1, 3)
            require((len(tr.scans) >= 1 if fresh else len(tr.scans) == 0)
                    and planned == (4 if fresh else 0),
                    f"server round {rnd}: {len(tr.scans)} scans, {planned} "
                    "statements planned")
            require(summ.get("deduped", 0) + len(tr.cache_hits) == 28 + (
                0 if fresh else 4), f"server round {rnd}: dedup "
                f"{summ.get('deduped', 0)}, cache hits {len(tr.cache_hits)}")
            require(all(e.detail["table_version"] == td.version
                        for e in tr.cache_hits),
                    f"server round {rnd}: a stale cache entry answered")
            engines = {e.engine for e in tr.kernels}
            require(engines <= {"cuda"}, f"server round {rnd}: kernel "
                    f"engines {engines}")
            print(f"[server] round {rnd}: {SERVER_SESSIONS} sessions x 4 = "
                  f"{4 * SERVER_SESSIONS} statements, {len(adm)} windows, "
                  f"{len(tr.scans)} scans, deduped {summ.get('deduped', 0)}, "
                  f"cache hits {len(tr.cache_hits)}, scans saved "
                  f"{summ.get('scans_saved', 0)}; {s_round:.3f} s to the "
                  f"last answer (host clock, synchronized); {smi}")
            if td.version not in local:
                sess = Session()
                hs = mix(sess)
                sess.run()
                local[td.version] = [h.result() for h in hs]
                # xtx and countmin at this version's shape, on the
                # window's inputs
                shape = f"({td.n_rows}, {K_MAIN})"
                hold("xtx", shape, run_local(
                    LinregrAggregate(use_kernel="cuda"), td,
                    finalize=False), run_local(
                    LinregrAggregate(use_kernel="ref"), td, finalize=False))
                hold("countmin", f"({td.n_rows},)", run_local(
                    CountMinAggregate(use_kernel="cuda"), td,
                    finalize=False), run_local(
                    CountMinAggregate(use_kernel="ref"), td, finalize=False))
            for i in range(SERVER_SESSIONS):
                for j, (got, want) in enumerate(zip(answers[i],
                                                    local[td.version])):
                    require(tree_equal(torch, got, want),
                            f"server round {rnd}: session {i} statement {j} "
                            "differs from a local Session run")
        # an in-place edit of one answer reaches no other answer
        answers[0][1].coef.add_(1.0)
        answers[0][2].zero_()
        with trace_execution() as tr:
            again = mix(Session(server=srv))
            again = [h.result(timeout=120) for h in again]
        require(len(tr.scans) == 0 and len(tr.cache_hits) == 4,
                "server: the repeat after the edit was not answered from "
                "the cache")
        for got in (answers[1], again):
            for j, want in enumerate(local[td.version]):
                require(tree_equal(torch, got[j], want),
                        f"server: statement {j} changed after another "
                        "handle's answer was edited in place")

        # the living view: the grouped statement answered by a delta fold
        with trace_execution() as tr:
            h, s_delta = timed(torch, lambda: main_step(
                f"view delta ({SERVER_APPEND}, {K_MAIN}), G {G_MAIN}",
                lambda: Session(server=srv).statement(
                    grouped_node()).result(timeout=120)))
        hits = [(e.detail["source"], e.detail["refresh"])
                for e in tr.cache_hits]
        require(hits == [("view", "delta")] and len(tr.scans) == 0
                and len(tr.deltas) == 1,
                f"server: living view answer {hits}, scans {len(tr.scans)}")

        # segment_linregr on the delta's rows at the delta's block size
        # (core/materialize.py: about one block per group)
        delta = Table({k: v[n:] for k, v in td.columns.items()})
        bs = max(64, min(4096, 1 << (-(-SERVER_APPEND // G_MAIN)
                                     - 1).bit_length()))
        hold("segment_linregr",
             f"delta ({SERVER_APPEND}, {K_MAIN}), G {G_MAIN}, block {bs}",
             *(run_grouped(LinregrAggregate(use_kernel=impl), delta, "g",
                           G_MAIN, block_size=bs, finalize=False)
               for impl in ("cuda", "ref")))
        del delta

        # one full rescan, timed to the same point: fold and final
        def rescan():
            r = materialize(grouped_node())
            return r, r.result(refresh=False)

        (rescan_h, want), s_rescan = timed(torch, rescan)
        _, s_final = timed(torch, lambda: view.fused.final_grouped(
            view._state))
        require(tree_equal(torch, view._state, rescan_h._state),
                "server: the delta-refreshed view's fold state differs "
                "from a full rescan")
        require(tree_equal(torch, h, want),
                "server: the view's answer differs from the rescan's")
        print(f"[server] living view after the append: the grouped "
              f"statement answered by refresh 'delta' ({SERVER_APPEND} "
              f"rows folded) in {s_delta:.3f} s against a full rescan "
              f"{s_rescan:.3f} s, both with the final ({s_final:.3f} s "
              f"alone: batched eigh over ({G_MAIN}, {K_MAIN}, {K_MAIN})); "
              f"fold state bitwise equal to the rescan; {smi}")
        del view, rescan_h, h, want
    finally:
        srv.close()

    # the star join: a 100,000-row dimension with unique shuffled keys
    nf = td.n_rows
    keys = (torch.randperm(DIM_KEY_SPACE, generator=gen, device=dev)[
        :DIM_ROWS] + 1).to(torch.int32)
    attr = torch.randint(0, G_MAIN, (DIM_ROWS,), generator=gen,
                         dtype=torch.int32, device=dev)
    dim = Table({"key": keys, "attr": attr})
    rows = torch.randint(0, DIM_ROWS, (nf,), generator=gen, device=dev)
    dangling = torch.rand((nf,), generator=gen, device=dev) < 0.01
    fk = torch.where(dangling, torch.full_like(keys[rows], -1), keys[rows])
    n_dangling = int(dangling.sum())
    fact = Table(dict(td.columns, fk=fk))
    join = (lambda missing="drop": Join(fact, dim, "fk", "key", "attr",
                                        on_missing=missing))
    sess = Session()
    hj = sess.joined_grouped_scan(LinregrAggregate(use_kernel=True), join(),
                                  columns={"x": "x", "y": "y"})
    hc = sess.joined_grouped_scan(CountMinAggregate(use_kernel=True), join(),
                                  columns=("item",))
    kept = nf - n_dangling
    with trace_execution() as tr:
        _, s_batch = timed(torch, lambda: main_step(
            f"join batch ({kept}, {K_MAIN}), G {G_MAIN}", sess.run))
    by_table = tr.summary().get("sorts_by_table", {})
    require(len(tr.joins) == 1 and len(tr.scans) == 1 and len(tr.sorts) == 2
            and by_table.get(id(dim)) == 1,
            f"star join batch: {len(tr.joins)} resolutions, "
            f"{len(tr.scans)} scans, sorts {by_table}")
    require(sorted((e.detail["name"], e.engine) for e in tr.kernels)
            == [("segment_countmin", "cuda"), ("segment_linregr", "cuda")],
            "star join batch: each member's segment kernel did not run "
            "once through cuda")
    with trace_execution() as tr:
        got, s_join = timed(torch, lambda: main_step(
            f"linregr_joined ({kept}, {K_MAIN}), G {G_MAIN}",
            lambda: linregr_joined(fact, dim, fact_key="fk", dim_key="key",
                                   attr_col="attr", on_missing="drop",
                                   use_kernel=True)))
    require(len(tr.joins) == 0 and len(tr.sorts) == 0,
            "linregr_joined did not reuse the batch's resolution and sort")
    # one resolution alone: a fresh fact table object misses the memo
    # (the dimension's sort is memoized)
    res, s_resolve = timed(torch, lambda: Join(
        Table(dict(fact.columns)), dim, "fk", "key", "attr",
        on_missing="drop").resolve())
    require(res.dangling == n_dangling,
            f"star join: {res.dangling} dangling, want {n_dangling}")
    # the attribute gathered onto the fact rows by hand
    lut = torch.full((DIM_KEY_SPACE + 2,), -1, dtype=torch.int32, device=dev)
    lut[keys.long()] = attr
    gids = torch.where(fk >= 0, lut[fk.clamp(min=0).long()],
                       torch.full_like(fk, -1))
    require(torch.equal(res.table[res.gid_col], gids),
            "star join: resolved gids differ from the gathered ones")
    del res, lut
    # the joined layout's kernels against their plain versions, and its
    # fold states against the gathered GROUP BY's
    resolved = join().resolve()
    jview = resolved.table.group_by(resolved.gid_col, G_MAIN)
    st_join = run_grouped(LinregrAggregate(use_kernel="cuda"),
                          jview.select("x", "y"), finalize=False)
    hold("segment_linregr", f"joined ({kept}, {K_MAIN}), G {G_MAIN}",
         st_join, run_grouped(LinregrAggregate(use_kernel="ref"),
                              jview.select("x", "y"), finalize=False))
    cm_join = run_grouped(CountMinAggregate(use_kernel="cuda"),
                          jview.select("item"), finalize=False)
    hold("segment_countmin", f"joined ({kept},), G {G_MAIN}", cm_join,
         run_grouped(CountMinAggregate(use_kernel="ref"),
                     jview.select("item"), finalize=False))
    del jview, resolved
    manual = Table({"x": fact["x"], "y": fact["y"], "g": gids})
    st_manual = run_grouped(LinregrAggregate(use_kernel=True),
                            manual.group_by("g", G_MAIN), finalize=False)
    require(tree_equal(torch, st_join, st_manual),
            "star join: fold states differ from the gathered GROUP BY")
    want = LinregrAggregate().final_grouped(st_manual)
    require(tree_equal(torch, got, want) and tree_equal(torch, hj.result(),
                                                        want),
            "star join: linregr_joined differs from the gathered GROUP BY")
    require(torch.equal(hc.result(),
                        CountMinAggregate().final_grouped(cm_join)),
            "star join: the batch's grouped Count-Min differs from its "
            "kernel's fold")
    try:
        execute(JoinedGroupedScanAgg(LinregrAggregate(use_kernel=True),
                                     join("error"), columns=("x", "y")))
        raised = ""
    except ValueError as e:
        raised = str(e)
    require(f"{n_dangling} of {nf}" in raised,
            f"star join on_missing='error' did not name the dangling "
            f"count: {raised!r}")
    launched: dict[str, int] = {}
    for got_step in steps.values():
        for name, k in got_step.items():
            launched[name] = launched.get(name, 0) + k
    for name in ("xtx", "countmin", "segment_linregr", "segment_countmin",
                 "column_stats"):
        require(launched.get(name, 0) > 0, f"server phase: {name} launched "
                f"{launched.get(name, 0)} times on the main path")
    print(f"[server] star join {nf} x {DIM_ROWS} rows ({n_dangling} "
          f"dangling): the batch of two joined statements {s_batch:.3f} s "
          f"(1 resolution, 2 sorts, 1 scan, each member through its "
          f"segment kernel); linregr_joined again {s_join:.3f} s; one "
          f"resolution alone {s_resolve:.3f} s (host clock, synchronized); "
          f"fold states bitwise equal to the gathered GROUP BY; "
          f"on_missing='error' names {n_dangling}; {smi}")
    print(f"[server] main-path launches by step: {json.dumps(steps)}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")
    # section i's table: pinned host copies of the first n rows
    host = {k: pinned_copy(torch, td[k][:n]) for k in ("x", "y", "item")}
    return steps, host


# i. the stream engine: the section h table's first N_MAIN rows, section
# e's blobs and section f's label, held in pinned host memory and folded
# by run_stream in blocks: B_SCAN for the scans (nine full blocks and a
# ragged tail of 562,816 rows), B_FIT for the fits (ten equal blocks, the
# blocks that the resident fit folds at block_size=B_FIT)
B_SCAN, B_FIT = 1_048_576, 1_000_000
# logregr_stream against the resident blocked fit: both fold the same
# blocks through cuBLAS, so their coefficients may differ by at most
# this much relative to the largest coefficient
STREAM_LR_RTOL = 1e-6


def pinned_copy(torch, t):
    """A pinned host copy of ``t``."""
    out = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def host_blocks(cols: dict, bs: int):
    """Row blocks of ``bs`` rows (the last one ragged) of host columns:
    views, no copy."""
    n = next(iter(cols.values())).shape[0]
    return ({k: v[i:i + bs] for k, v in cols.items()}
            for i in range(0, n, bs))


def h2d_seconds(torch, dev, cols: dict, bs: int) -> float:
    """CUDA-event seconds to copy every column of ``cols`` (host
    tensors, pinned or pageable) to the card in blocks of ``bs`` rows,
    one stream, into reused device buffers."""
    dst = {k: torch.empty((bs,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=dev) for k, v in cols.items()}

    def copy_all():
        for blk in host_blocks(cols, bs):
            for k, v in blk.items():
                dst[k][:v.shape[0]].copy_(v, non_blocking=True)

    return cuda_ms(torch, copy_all, 1) / 1e3


def interval_union(ivs):
    """Merged [start, end) intervals of ``ivs``."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def interval_length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def overlap_length(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


def device_busy(torch, fn) -> dict:
    """``fn()`` under torch.profiler: its host seconds, the kernels' busy
    share of them, the H2D copies' busy share, the share of the H2D time
    that overlaps a kernel (None when the profiler records no device
    activity), and the host's waits on the card (CUDA runtime
    synchronize calls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, h2d, waits = [], [], 0
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            waits += e.name in HOST_WAITS
            continue
        if getattr(e, "is_user_annotation", False):
            # a record_function range (the program's madlib:: spans),
            # which the profiler also puts on the device's timeline: no
            # device work of its own
            continue
        iv = (e.time_range.start, e.time_range.end)   # microseconds
        if "Memcpy HtoD" in e.name:
            h2d.append(iv)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kern.append(iv)
    out = {"wall": wall, "kernels": None, "h2d": None, "overlap": None,
           "waits": waits}
    if kern and h2d:
        k, c = interval_union(kern), interval_union(h2d)
        out.update(kernels=interval_length(k) / (wall * 1e6),
                   h2d=interval_length(c) / (wall * 1e6),
                   overlap=overlap_length(c, k) / interval_length(c))
    return out


def wait_sites(torch, fn, top: int = 4) -> str:
    """``fn()`` under torch.profiler with Python stacks: the host's waits
    on the card (CUDA synchronize calls) counted by the op that made them
    and the innermost frame of the port's code above it."""
    from collections import Counter
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # verbose: the events keep their Python stacks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True,
                 experimental_config=_ExperimentalConfig(verbose=True)
                 ) as prof:
        fn()
    sites = Counter()
    for e in prof.events():
        if e.name not in HOST_WAITS:
            continue
        op, p = e.cpu_parent, e
        while p is not None and not p.stack:
            p = p.cpu_parent
        frames = [] if p is None else [f for f in p.stack
                                       if "repro_torch" in f]
        where = (frames[0].split("src/")[-1] if frames
                 else "no frame of the port")
        sites[f"{e.name} in {op.name if op else '-'} at {where}"] += 1
    return "; ".join(f"{n} x {site}" for site, n in sites.most_common(top)
                     ) or "none"


def busy_text(b: dict) -> str:
    if b["kernels"] is None:
        return ("not measured (no device activity in the trace); "
                f"{b['waits']} host waits on the card")
    return (f"kernels busy {b['kernels']:.1%} of {b['wall']:.4f} s, H2D "
            f"copies busy {b['h2d']:.1%}, {b['overlap']:.1%} of the H2D "
            f"time overlaps a kernel, {b['waits']} host waits on the card "
            "(CUDA synchronize calls)")


def stream_section(torch, dev, counters, errs, host, seeds, smi) -> dict:
    """The stream engine at the main path's width, with the table in
    pinned host memory (``host``: ``x``, ``y``, ``item``, the blobs
    ``bx`` and the label ``yl``): the copy bound; one Session of three
    stream statements over one iterator against the resident batch; a
    streamed profile; a k-means ``fit_stream`` from ``seeds`` and
    ``logregr_stream`` against the resident fits at ``block_size=B_FIT``;
    producers that reuse one buffer; the kernels at the block shapes
    against their plain versions.  Each main-path step (the stream batch,
    ``profile_stream``, the two stream fits) runs between a zero and a
    read of the launch counters.  Returns their launches by step."""
    import numpy as np
    from repro_torch.core import (
        FusedAggregate, Session, Table, fit, fit_stream, run_local,
        run_stream, trace_execution)
    from repro_torch.kernels.countmin import ops as cm_ops
    from repro_torch.kernels.countmin.ref import countmin_block_ref
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.kmeans_assign.ref import assign_and_reduce_ref
    from repro_torch.kernels.xtx import ops as xtx_ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref
    from repro_torch.methods.kmeans import KMeansAggregate, KMeansTask
    from repro_torch.methods.linregr import LinregrAggregate
    from repro_torch.methods.logregr import logregr, logregr_stream
    from repro_torch.methods.profile import profile, profile_stream
    from repro_torch.methods.sketches import CountMinAggregate, FMAggregate

    t_section = time.perf_counter()
    n = host["y"].shape[0]
    scan = {k: host[k] for k in ("x", "y", "item")}
    nb_scan, tail = -(-n // B_SCAN), n % B_SCAN
    nb_fit = -(-n // B_FIT)
    scan_bytes = sum(v.numel() * v.element_size() for v in scan.values())
    km_bytes = host["bx"].numel() * host["bx"].element_size()
    lr_bytes = (host["x"].numel() * host["x"].element_size()
                + host["yl"].numel() * host["yl"].element_size())
    steps: dict[str, dict[str, int]] = {}

    def main_step(label, fn):
        counters.zero()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = {k: v for k, v in counters.read().items() if v}
        return out

    # the copy bound: one pass's bytes host -> device alone
    link = nvidia_smi("pcie.link.gen.current,pcie.link.width.current,"
                      "pcie.link.gen.max,pcie.link.width.max", units=False)
    pageable = {k: v.clone() for k, v in scan.items()}
    require(not any(v.is_pinned() for v in pageable.values()),
            "copy bound: the pageable copy is pinned")
    s_pin = h2d_seconds(torch, dev, scan, B_SCAN)
    s_page = h2d_seconds(torch, dev, pageable, B_SCAN)
    del pageable
    pin_rate = scan_bytes / s_pin
    print(f"[stream] PCIe link (gen, width, max gen, max width): {link}; "
          f"one pass = {scan_bytes / 1e9:.4f} GB (x, y, item) copied "
          f"host -> device alone in blocks of {B_SCAN} rows: pinned "
          f"{s_pin:.4f} s = {pin_rate / 1e9:.3f} GB/s, pageable "
          f"{s_page:.4f} s = {scan_bytes / s_page / 1e9:.3f} GB/s (CUDA "
          f"events); {smi}")

    # three stream statements over one iterator, against the resident
    # batch of the same statements
    td = Table({k: v.to(dev) for k, v in scan.items()})

    def resident_batch():
        sess = Session()
        hs = [sess.linregr(td, use_kernel=True),
              sess.scan(CountMinAggregate(use_kernel=True), td,
                        columns=("item",), label="countmin"),
              sess.fm_distinct_count(td)]
        sess.run()
        return [h.result() for h in hs]

    def stream_batch(blocks):
        sess = Session()
        hs = [sess.stream_scan(LinregrAggregate(use_kernel=True), blocks,
                               columns=("x", "y"), label="linregr",
                               device=dev),
              sess.stream_scan(CountMinAggregate(use_kernel=True), blocks,
                               columns=("item",), label="countmin",
                               device=dev),
              sess.stream_scan(FMAggregate(), blocks, columns=("item",),
                               label="fm_distinct", device=dev)]
        sess.run()
        return [h.result() for h in hs]

    want, s_res = timed(torch, resident_batch)
    want, s_res2 = timed(torch, resident_batch)
    secs = []
    for rep in range(2):
        label = (f"stream batch, {('first', 'again')[rep]} ({n}, "
                 f"{K_MAIN}) in {nb_scan} blocks of {B_SCAN}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with trace_execution() as tr:
            got, s = timed(torch, lambda: main_step(
                label, lambda: stream_batch(host_blocks(scan, B_SCAN))))
        peak = torch.cuda.max_memory_allocated() - base
        secs.append(s)
        launched = steps[label]
        require(len(tr.scans) == 1 and tr.scans[0].engine == "stream",
                f"stream batch: scans {[e.engine for e in tr.scans]}")
        require(launched.get("xtx") == nb_scan
                and launched.get("countmin") == nb_scan,
                f"stream batch: launches {launched}, want xtx and countmin "
                f"{nb_scan} each (one per block)")
        require(tree_equal(torch, got, want), "stream batch: results differ "
                "from the resident batch")
    # the peak against one transition on one resident block
    blk = {k: v[:B_SCAN] for k, v in td.columns.items()}
    ones = torch.ones((B_SCAN,), dtype=torch.bool, device=dev)
    fused = FusedAggregate([LinregrAggregate(use_kernel=True),
                            CountMinAggregate(use_kernel=True),
                            FMAggregate()])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = fused.transition(fused.init(blk), blk, ones)
    torch.cuda.synchronize()
    t_peak = torch.cuda.max_memory_allocated() - base
    del st, blk, ones
    blk_bytes = B_SCAN * (sum(v.element_size() * v[0].numel()
                              for v in scan.values()) + 1)
    require(peak <= t_peak + 2 * blk_bytes,
            f"stream batch: peak {peak} B above the baseline exceeds one "
            f"transition's {t_peak} B plus two blocks' {2 * blk_bytes} B")
    prof_s = busy_text(device_busy(
        torch, lambda: stream_batch(host_blocks(scan, B_SCAN))))
    prof_s += "; host waits by site: " + wait_sites(
        torch, lambda: stream_batch(host_blocks(scan, B_SCAN)))
    print(f"[stream] batch of 3 stream statements (linregr, countmin, "
          f"fm_distinct) over one iterator of pinned blocks: first "
          f"{secs[0]:.4f} s, again {secs[1]:.4f} s (host clock, "
          f"synchronized) = {scan_bytes / secs[1] / 1e9:.3f} GB/s, "
          f"{scan_bytes / secs[1] / pin_rate:.1%} of the pinned copy rate; "
          f"the resident batch {s_res:.4f} s, again {s_res2:.4f} s; 1 scan, "
          f"launches {steps[label]}; results bitwise equal to the resident "
          f"batch; peak {peak / 1e9:.4f} GB above the baseline (one "
          f"transition on a resident block {t_peak / 1e9:.4f} GB, one "
          f"block {blk_bytes / 1e9:.4f} GB); torch.profiler: {prof_s}; "
          f"{smi}")

    # profile_stream against profile of the resident table
    label = f"profile_stream ({n}, {K_MAIN}) in {nb_scan} blocks of {B_SCAN}"
    pst, s_ps = timed(torch, lambda: main_step(label, lambda: profile_stream(
        host_blocks(scan, B_SCAN), distinct_counts=True, device=dev)))
    pres, s_pr = timed(torch, lambda: profile(td, distinct_counts=True))
    ps_busy = busy_text(device_busy(torch, lambda: profile_stream(
        host_blocks(scan, B_SCAN), distinct_counts=True, device=dev)))
    ps_busy += "; host waits by site: " + wait_sites(
        torch, lambda: profile_stream(host_blocks(scan, B_SCAN),
                                      distinct_counts=True, device=dev))
    require(set(pst) == set(pres), "profile_stream: columns differ")
    inexact = []
    for col, fields in pres.items():
        require(set(pst[col]) == set(fields), f"profile_stream {col}: keys")
        for key, v in fields.items():
            if torch.equal(pst[col][key], v):
                continue
            # the Zipf keys' sums and squares pass 2^24: not exact in f32,
            # so they are held against float64 sums instead
            require(col == "item" and key in ("sum", "sumsq", "mean", "std"),
                    f"profile_stream {col}.{key}: not bitwise equal to "
                    "profile")
            inexact.append(key)
    if inexact:
        it64 = td["item"].double()
        for key, exact in (("sum", it64.sum()), ("sumsq", (it64 ** 2).sum())):
            for name, res in (("stream", pst), ("resident", pres)):
                err = abs(float(res["item"][key]) - float(exact))
                require(err <= PROFILE_RTOL * float(exact),
                        f"profile {name} item.{key}: {err} off float64")
        d_mean = abs(float(pst["item"]["mean"] - pres["item"]["mean"]))
        require(d_mean <= PROFILE_RTOL * abs(float(pres["item"]["mean"])),
                f"profile_stream item.mean differs by {d_mean}")
    print(f"[stream] profile_stream (distinct counts) over the pinned "
          f"blocks: {s_ps:.4f} s (host clock, synchronized) = "
          f"{scan_bytes / s_ps / 1e9:.3f} GB/s, "
          f"{scan_bytes / s_ps / pin_rate:.1%} of the pinned copy rate; "
          f"profile of the resident table {s_pr:.4f} s; every field "
          f"bitwise equal to profile's"
          + (f" but item's {sorted(set(inexact))} (within {PROFILE_RTOL} "
             "of the float64 sums)" if inexact else "")
          + f"; launches {steps[label]}; torch.profiler: {ps_busy}; {smi}")

    # producers that reuse one buffer: the states of the batch
    def reusing(pinned_buf: bool):
        bufs = {k: (torch.empty((B_SCAN,) + tuple(v.shape[1:]),
                                dtype=v.dtype, pin_memory=True) if pinned_buf
                    else np.empty((B_SCAN,) + tuple(v.shape[1:]),
                                  dtype=v.numpy().dtype))
                for k, v in scan.items()}
        for blk in host_blocks(scan, B_SCAN):
            m = blk["y"].shape[0]
            for k, v in blk.items():
                if pinned_buf:
                    bufs[k][:m].copy_(v)
                else:
                    bufs[k][:m] = v.numpy()
            yield {k: b[:m] for k, b in bufs.items()}

    for pinned_buf in (False, True):
        kind = "one pinned tensor" if pinned_buf else "one numpy buffer"
        got, s = timed(torch, lambda: stream_batch(reusing(pinned_buf)))
        require(tree_equal(torch, got, want), f"stream batch from a producer "
                f"reusing {kind}: results differ from the resident batch")
        print(f"[stream] batch from a producer reusing {kind} (a host copy "
              f"into it per block): {s:.4f} s (host clock, synchronized) = "
              f"{scan_bytes / s / 1e9:.3f} GB/s; results bitwise equal; "
              f"{smi}")
    del got, want

    # the kernels at the block shapes against their plain versions
    for rows in (B_SCAN, tail):
        xs, ys = td["x"][n - rows:], td["y"][n - rows:]
        it, ones = td["item"][n - rows:], torch.ones(
            (rows,), dtype=torch.bool, device=dev)
        got, ref = xtx_ops.xtx_xty(xs, ys), xtx_xty_ref(xs, ys)
        errs["xtx"] = max(errs["xtx"], *(bitwise(
            torch, f"xtx ({rows}, {K_MAIN}) stream block", a, b)
            for a, b in zip(got, ref)))
        errs["countmin"] = max(errs["countmin"], bitwise(
            torch, f"countmin ({rows},) stream block",
            cm_ops.countmin_block(it, ones, 4, 1024),
            countmin_block_ref(it, ones, 4, 1024)))
        print(f"[stream] xtx ({rows}, {K_MAIN}) and countmin ({rows},) at a "
              "stream block's shape: bitwise equal to the plain versions")
    del xs, ys, it, ones

    # logregr_stream against the resident logregr at block_size=B_FIT
    yl = host["yl"].to(dev)
    lr_cols = {"x": host["x"], "y": host["yl"]}
    res, s_res = timed(torch, lambda: logregr(Table({"x": td["x"], "y": yl}),
                                              block_size=B_FIT))
    label = f"logregr_stream ({n}, {K_MAIN}) in {nb_fit} blocks of {B_FIT}"
    with trace_execution() as tr:
        got, s = timed(torch, lambda: main_step(label, lambda: logregr_stream(
            lambda: host_blocks(lr_cols, B_FIT), device=dev)))
    rel = float((got.coef - res.coef).abs().max() / res.coef.abs().max())
    require(got.n_iters == res.n_iters and got.converged == res.converged
            and got.converged, f"logregr_stream: rounds {got.n_iters} "
            f"(converged {got.converged}) vs resident {res.n_iters} "
            f"({res.converged})")
    require(rel <= STREAM_LR_RTOL, f"logregr_stream: coef differ by {rel} "
            "of the largest (relative)")
    require(len(tr.scans) == got.n_iters
            and {e.engine for e in tr.scans} == {"stream"},
            "logregr_stream: one stream scan per round")
    print(f"[stream] logregr_stream over x and the label in {nb_fit} pinned "
          f"blocks: {s:.4f} s, {got.n_iters} rounds, {s / got.n_iters:.4f} "
          f"s per round = {lr_bytes / (s / got.n_iters) / 1e9:.3f} GB/s, "
          f"{lr_bytes / (s / got.n_iters) / pin_rate:.1%} of the pinned copy "
          f"rate; resident logregr (block_size={B_FIT}) {s_res:.4f} s, "
          f"{s_res / res.n_iters:.4f} s per round; equal rounds and "
          f"convergence, coef max difference {rel:.3e} of the largest "
          f"(limit {STREAM_LR_RTOL}); {smi}")
    del yl, td, res, got
    torch.cuda.empty_cache()

    # fit_stream of k-means from the k-means++ seeds against the
    # resident fit at block_size=B_FIT
    bx = host["bx"].to(dev)
    tol = KM_REASSIGN_TOL + 0.5 / n
    before = counters.peek()
    res, s_res = timed(torch, lambda: fit(
        KMeansTask(seeds, use_kernel=True), Table({"x": bx}),
        max_iters=KM_MAX_ITERS, tol=tol, block_size=B_FIT))
    res_launches = counters.peek()["kmeans_assign"] - before["kmeans_assign"]
    label = f"fit_stream kmeans ({n}, {D_KM}, {K_KM}) in {nb_fit} blocks of " \
            f"{B_FIT}"
    km_cols = {"x": host["bx"]}
    with trace_execution() as tr:
        got, s = timed(torch, lambda: main_step(label, lambda: fit_stream(
            KMeansTask(seeds, use_kernel=True),
            lambda: host_blocks(km_cols, B_FIT), max_iters=KM_MAX_ITERS,
            tol=tol, device=dev)))
    launched = steps[label].get("kmeans_assign", 0)
    require(got.converged and got.n_iters == res.n_iters,
            f"fit_stream kmeans: rounds {got.n_iters} vs {res.n_iters}")
    require(tree_equal(torch, got.state, res.state)
            and tree_equal(torch, got.trace, res.trace),
            "fit_stream kmeans: centroids or sse differ from the resident "
            "fit")
    require(launched == res_launches == 2 * nb_fit * got.n_iters,
            f"fit_stream kmeans: kmeans_assign launches {launched}, the "
            f"resident fit {res_launches}, want {2 * nb_fit * got.n_iters}")
    cents, prev = got.state["cents"], got.state["prev"]
    out_s = run_stream(KMeansAggregate(cents, prev, use_kernel=True),
                       host_blocks(km_cols, B_FIT), device=dev)
    out_r = run_local(KMeansAggregate(cents, prev, use_kernel=True),
                      Table({"x": bx}), block_size=B_FIT)
    require(tree_equal(torch, out_s, out_r), "k-means pass: centroids, "
            "counts or sse of the stream differ from the resident fold")
    ones = torch.ones((B_FIT,), device=dev)
    errs["kmeans_assign"] = max(errs["kmeans_assign"], km_gauss_check(
        torch, f"kmeans_assign ({B_FIT}, {D_KM}, {K_KM}) stream block",
        bx[:B_FIT], cents, ones,
        km_ops.assign_and_reduce(bx[:B_FIT], cents, ones),
        assign_and_reduce_ref(bx[:B_FIT], cents, ones)))
    print(f"[stream] fit_stream kmeans (k = {K_KM}) from the k-means++ seeds "
          f"over {nb_fit} pinned blocks: {s:.4f} s, {got.n_iters} rounds, "
          f"{s / got.n_iters * 1e3:.2f} ms per round = "
          f"{km_bytes / (s / got.n_iters) / 1e9:.3f} GB/s, "
          f"{km_bytes / (s / got.n_iters) / pin_rate:.1%} of the pinned copy "
          f"rate; the resident fit (block_size={B_FIT}) {s_res:.4f} s, "
          f"{s_res / res.n_iters * 1e3:.2f} ms per round; rounds, centroids, "
          f"sse and counts bitwise equal; kmeans_assign launches {launched} "
          f"(resident {res_launches}); fit events "
          f"{[e.engine for e in tr.fits]}; {smi}")
    del bx, res, got, out_s, out_r, ones
    torch.cuda.empty_cache()
    print(f"[stream] main-path launches by step: {json.dumps(steps)}; "
          f"section i took {time.perf_counter() - t_section:.1f} s")
    return steps


# ---------------------------------------------------------------------------
# j. the measured calibration on the card, then the one-pass and EM methods
# of MADlib's Table 1 at full size, on tables made on the card from the seed.
# ---------------------------------------------------------------------------

CAL_ROWS = (1 << 20, 1 << 22, 10_000_000)
CAL_GROUPS = (8, 64, 1024)
CAL_BLOCKS = (64, 128, 256, 512, 1024, 2048, 4096)
CAL_REPS = 3
# masked cells time at most this many group passes and scale by groups /
# this (a masked pass scans the whole table once per group): measured in
# full, the G = 1024 cells took 27 of the sweep's 88 s on one H100
CAL_MASKED_GROUPS_MAX = 64
NB_CLASSES = 10
Q_BINS, QS = 4096, (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
DT_DEPTH, DT_BINS, DT_CLASSES, DT_PREFIX = 4, 32, 4, 1_000_000
# a decaying spectrum built as tests/test_methods.py builds it, (u * s) v^T:
# the top SVD_K singular values 10 * 0.95^i, then a floor of 1.0, so the
# power iteration converges in a few rounds and the f32 sums' rounding,
# relative to the largest eigenvalue of A^T A, stays well below SVD_RTOL
# at the k-th
SVD_K, SVD_TOP, SVD_DECAY, SVD_BLOCK = 10, 10.0, 0.95, 1_000_000
SVD_RTOL = 1e-4
LDA_DOCS, LDA_VOCAB, LDA_TOPICS, LDA_LEN = 100_000, 4096, 20, 200
LDA_ROUNDS, LDA_BLOCK, LDA_CHECK_DOCS = 5, 4096, 2000
# the E-step on the card against the CPU: f32 digamma, exp and logsumexp
# differ in the last ulps and the sums run in other orders
LDA_RTOL, LDA_ATOL_SHARE = 1e-4, 1e-6
AR_ROWS, AR_ITEMS, AR_P, AR_BLOCK = 10_000_000, 32, 0.15, 1_000_000
SM_ROWS, SM_WIDTH, SM_BUCKETS, SM_PREFIX = 1_000_000, 64, 512, 10_000
SM_QUERY = "the quick brown fox jumps over the lazy dog"


def methods_section(torch, dev, counters, errs, smi) -> dict:
    """Section j: the calibration harness on the card and what it
    changes; then each method of the slice at full size, with its first
    and repeated seconds.  The harness run and the grouped OLS statement
    under both blocks run between a zero and a read of the launch
    counters; the kernels are then held at the sweep's shapes against
    their plain versions (``errs``).  Returns the launches by step."""
    import numpy as np
    from repro_torch.core import (
        GroupedScanAgg, Session, Table, calibration, execute, run_grouped,
        run_local, trace_execution)
    from repro_torch.core.aggregates import segment_block_size
    from repro_torch.core.plan import select_grouped_method
    from repro_torch.kernels.countmin import ops as cm_ops
    from repro_torch.kernels.countmin.ref import countmin_block_ref
    from repro_torch.kernels.segment_fold import ops as sf_ops
    from repro_torch.kernels.segment_fold.ref import (
        segment_countmin_ref, segment_linregr_ref)
    from repro_torch.kernels.xtx import ops as xtx_ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref
    from repro_torch.launch.calibrate import calibrate
    from repro_torch.methods import (
        assoc_rules, decision_tree, lda, naive_bayes, quantiles,
        string_match, svd)
    from repro_torch.methods.linregr import LinregrAggregate, linregr_grouped
    from repro_torch.tree import tree_leaves

    t_section = time.perf_counter()
    steps: dict[str, dict[str, int]] = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)

    def main_step(label, fn):
        counters.zero()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = {k: v for k, v in counters.read().items() if v}
        return out

    t_part = [time.perf_counter()]

    def part_done(what):
        now = time.perf_counter()
        print(f"[methods] {what}: {now - t_part[0]:.1f} s of section j")
        t_part[0] = now

    def twice(what, fn):
        """``fn()`` run twice: the first result and both host seconds."""
        out, first = timed(torch, fn)
        _, again = timed(torch, fn)
        print(f"[methods] {what}: first {first:.4f} s, repeated "
              f"{again:.4f} s; {smi}")
        return out

    # -- the calibration sweep ---------------------------------------------
    out = str(ROOT / "build" / "calibration" / "cuda.json")
    t0 = time.perf_counter()
    cal, path = main_step("calibration sweep", lambda: calibrate(
        CAL_ROWS, CAL_GROUPS, CAL_REPS, CAL_BLOCKS, device=dev, out=out,
        masked_groups_max=CAL_MASKED_GROUPS_MAX,
        log=lambda s: print(f"[calib]{s}")))
    s_sweep = time.perf_counter() - t0
    launched = steps["calibration sweep"]
    for name in ("xtx", "segment_linregr", "countmin", "segment_countmin"):
        require(launched.get(name, 0) > 0,
                f"calibration sweep: {name} never launched")
    print(f"[calib] sweep of {len(CAL_ROWS)} x {len(CAL_GROUPS)} buckets, "
          f"blocks {list(CAL_BLOCKS)}, reps {CAL_REPS}: {s_sweep:.1f} s, "
          f"launches {launched}; {smi}")
    print(json.dumps({"calibration_blocks": [
        {k: e[k] for k in ("rows", "groups", "block", "heuristic_block",
                           "sweep")} for e in cal.grouped_block],
        "device": smi}))
    for e in cal.grouped_block:
        print(f"[calib] rows={e['rows']} groups={e['groups']}: measured best "
              f"block {e['block']} ({e['sweep'][str(e['block'])] * 1e3:.3f} "
              f"ms), heuristic block {e['heuristic_block']} ("
              + (f"{e['sweep'][str(e['heuristic_block'])] * 1e3:.3f} ms"
                 if str(e["heuristic_block"]) in e["sweep"] else "not swept")
              + ")")
    # the grouped method (segment or masked) the planner picks per bucket
    # and aggregate class, under the heuristic and under this calibration,
    # whose xtx cells now time the narrow kernel at K = 8
    methods = []
    for rows_b in CAL_ROWS:
        for groups_b in CAL_GROUPS:
            for cls in ("xtx", "sketch"):
                heur_m = select_grouped_method(rows_b, groups_b,
                                               segment_ok=True,
                                               agg_cls=cls)[0]
                with calibration.use(path):
                    meas_m, costs, source = select_grouped_method(
                        rows_b, groups_b, segment_ok=True, agg_cls=cls)
                require(source["kind"] == "measured", f"the calibration "
                        f"does not cover {cls} at {rows_b} x {groups_b}")
                e = {"rows": rows_b, "groups": groups_b, "class": cls,
                     "heuristic": heur_m, "measured": meas_m,
                     "seconds": costs, "changed": heur_m != meas_m}
                methods.append(e)
                print(f"[calib] rows={rows_b} groups={groups_b} {cls}: "
                      f"heuristic {heur_m}, calibrated {meas_m}"
                      + (" (changed)" if e["changed"] else "") + "; "
                      + ", ".join(f"{m} {v * 1e3:.3f} ms"
                                  for m, v in costs.items()))
    print(json.dumps({"calibration_methods": methods,
                      "changed": [[e["rows"], e["groups"], e["class"]]
                                  for e in methods if e["changed"]],
                      "device": smi}))
    require(calibration.current() is None,
            "a calibration is active before any was activated")

    # -- under the calibration: section h's dyadic table, G = G_MAIN --------
    gh = torch.Generator(device=dev)
    gh.manual_seed(SEED + 18)                  # section h's draws, in order
    n = N_MAIN
    td = Table({"x": dyadic(torch, gh, (n, K_MAIN), dev),
                "y": dyadic(torch, gh, (n,), dev)})
    td = Table(dict(td.columns, g=torch.randint(
        0, G_MAIN, (n,), generator=gh, dtype=torch.int32, device=dev)))
    heur = segment_block_size(n, G_MAIN)
    sess = Session()
    sess.grouped_scan(LinregrAggregate(use_kernel=True), td, "g", G_MAIN,
                      columns=("x", "y"), label="linregr_grouped")
    require("[heuristic]" in sess.explain(), "explain measured with no "
            "calibration active")
    with calibration.use(path):
        text = sess.explain()
        meas = segment_block_size(n, G_MAIN)
    print("[calib] explain under the calibration:\n" + text)
    require("[measured cuda@" in text,
            "explain() of linregr_grouped does not read [measured cuda@...]")
    require(meas == cal.grouped_block_size(n, G_MAIN),
            f"segment_block_size {meas} is not the measured best "
            f"{cal.grouped_block_size(n, G_MAIN)}")
    def under(cal_path, fn):
        """``fn()`` with the calibration at ``cal_path`` active (None:
        none, the heuristics)."""
        if cal_path is None:
            return fn()
        with calibration.use(cal_path):
            return fn()

    def segment_stmt():
        return execute(GroupedScanAgg(
            LinregrAggregate(use_kernel=True), td, "g", G_MAIN,
            columns=("x", "y"), method="segment", label="linregr_grouped"))

    states, secs, results = {}, {}, {}
    for label, p in (("heuristic", None), ("measured", path)):
        states[label] = under(p, lambda: run_grouped(
            LinregrAggregate(use_kernel=True), td, "g", G_MAIN,
            method="segment", finalize=False))
        _, first = timed(torch, lambda: main_step(
            f"linregr_grouped ({n}, {K_MAIN}), segment, {label} block",
            lambda: under(p, segment_stmt)))
        results[label], again = timed(torch, lambda: under(p, segment_stmt))
        secs[label] = (first, again)
    for a, b in zip(tree_leaves(states["heuristic"]),
                    tree_leaves(states["measured"])):
        bitwise(torch, "linregr_grouped fold state, measured vs heuristic "
                "block", a, b)
    print(f"[calib] linregr_grouped ({n} x {K_MAIN}, G = {G_MAIN}), segment "
          f"layout: heuristic block {heur}: first {secs['heuristic'][0]:.4f} "
          f"s, repeated {secs['heuristic'][1]:.4f} s; measured block {meas}: "
          f"first {secs['measured'][0]:.4f} s, repeated "
          f"{secs['measured'][1]:.4f} s; fold states bitwise equal; {smi}")
    # the statement as the planner runs it under the calibration: the
    # method explain named, bitwise the segment statement's answer
    chosen = text.split("grouped-scan [", 1)[1].split("]", 1)[0]
    planned, s_planned = timed(torch, lambda: main_step(
        f"linregr_grouped ({n}, {K_MAIN}), as planned under the calibration",
        lambda: under(path, lambda: linregr_grouped(td, "g", G_MAIN,
                                                    use_kernel=True))))
    for a, b in zip(tree_leaves(planned), tree_leaves(results["measured"])):
        bitwise(torch, f"linregr_grouped planned ({chosen}) vs segment", a, b)
    print(f"[calib] linregr_grouped as planned under the calibration: "
          f"{chosen}, {s_planned:.4f} s, answer bitwise the segment "
          f"statement's; {smi}")
    print(json.dumps({"calibrated_statement": {
        "statement": "linregr_grouped", "rows": n, "k": K_MAIN,
        "groups": G_MAIN, "heuristic_block": heur, "measured_block": meas,
        "heuristic_s": list(secs["heuristic"]),
        "measured_s": list(secs["measured"]), "planned_method": chosen,
        "planned_s": s_planned, "device": smi}}))
    del sess, states, results, planned

    # -- the kernels at the sweep's shapes against their plain versions:
    # xtx and countmin at the largest bucket, the segment kernels at the
    # smallest (their plain versions loop over blocks on the host)
    nk = CAL_ROWS[-1]
    xk = dyadic(torch, gen, (nk, 8), dev)
    yk = dyadic(torch, gen, (nk,), dev)
    ik = torch.randint(0, 10_000, (nk,), generator=gen, dtype=torch.int32,
                       device=dev)
    ones = torch.ones((nk,), dtype=torch.bool, device=dev)
    got, want = xtx_ops.xtx_xty(xk, yk), xtx_xty_ref(xk, yk)
    errs["xtx"] = max(errs["xtx"], *(bitwise(
        torch, f"xtx ({nk}, 8)", a, b) for a, b in zip(got, want)))
    errs["countmin"] = max(errs["countmin"], bitwise(
        torch, f"countmin ({nk},) 4 x 128", cm_ops.countmin_block(
            ik, ones, 4, 128), countmin_block_ref(ik, ones, 4, 128)))
    ns = CAL_ROWS[0]
    for groups in CAL_GROUPS:
        w = 1.0 / torch.arange(1, groups + 1, dtype=torch.float64,
                               device=dev)
        gk = torch.searchsorted(torch.cumsum(w, 0) / w.sum(), torch.rand(
            (ns,), generator=gen, dtype=torch.float64, device=dev)
        ).clamp_(max=groups - 1).to(torch.int32)
        view = Table({"x": xk[:ns], "y": yk[:ns], "item": ik[:ns],
                      "g": gk}).group_by("g", groups)
        for block in CAL_BLOCKS:
            cols, valid, bgids = view.aligned_blocks(block)
            args = (cols["x"], cols["y"], valid, bgids)
            got = sf_ops.segment_linregr(*args, num_groups=groups)
            want = segment_linregr_ref(*args, num_groups=groups)
            errs["segment_linregr"] = max(errs["segment_linregr"], *(
                bitwise(torch, f"segment_linregr K 8 block {block} G "
                        f"{groups}", got[q], want[q]) for q in want))
            sk = (cols["item"], valid, bgids)
            errs["segment_countmin"] = max(errs["segment_countmin"], bitwise(
                torch, f"segment_countmin 4 x 128 block {block} G {groups}",
                sf_ops.segment_countmin(*sk, depth=4, width=128,
                                        num_groups=groups),
                segment_countmin_ref(*sk, depth=4, width=128,
                                     num_groups=groups)))
            del cols, valid, bgids, args, got, want
        del view, gk
    print(f"[calib] xtx and countmin at ({nk}, 8) and 4 x 128, "
          f"segment_linregr (K = 8) and segment_countmin (4 x 128) at "
          f"({ns} rows) x groups {list(CAL_GROUPS)} x blocks "
          f"{list(CAL_BLOCKS)}: bitwise "
          "equal to the plain versions (dyadic data)")
    del xk, yk, ik, ones
    part_done("the calibration, its statement and kernel checks")
    gc.collect()
    torch.cuda.empty_cache()

    # -- naive Bayes on section h's table, 10 classes -----------------------
    label = torch.randint(0, NB_CLASSES, (n,), generator=gen,
                          dtype=torch.int32, device=dev)
    tnb = Table({"x": td["x"], "y": label, "g": td["g"]})
    model = twice(f"naive_bayes_fit ({n} x {K_MAIN}, {NB_CLASSES} classes)",
                  lambda: naive_bayes.naive_bayes_fit(tnb, NB_CLASSES))
    agg = naive_bayes.NaiveBayesAggregate(NB_CLASSES)
    state = run_local(agg, tnb.select("x", "y"), finalize=False)
    ref = {"count": torch.zeros(NB_CLASSES, dtype=torch.float64, device=dev),
           "sum": torch.zeros((NB_CLASSES, K_MAIN), dtype=torch.float64,
                              device=dev)}
    ref["sumsq"] = ref["sum"].clone()
    for r0 in range(0, n, 1_000_000):
        x64 = td["x"][r0:r0 + 1_000_000].double()
        oh = torch.nn.functional.one_hot(
            label[r0:r0 + 1_000_000].long(), NB_CLASSES).double()
        ref["count"] += oh.sum(0)
        ref["sum"] += oh.T @ x64
        ref["sumsq"] += oh.T @ (x64 * x64)
    for k in ref:
        require(torch.equal(state[k].double(), ref[k]),
                f"naive_bayes fold state {k} differs from the float64 fold")
    for a, b in zip(tree_leaves(model), tree_leaves(agg.final(state))):
        bitwise(torch, "naive_bayes_fit model vs final(fold state)", a, b)
    print("[methods] naive_bayes_fit: fold state bitwise equal to a float64 "
          "fold (dyadic x)")
    grouped = twice(f"naive_bayes_grouped (G = {G_MAIN})",
                    lambda: naive_bayes.naive_bayes_grouped(
                        tnb, "g", NB_CLASSES, G_MAIN))
    for i in range(G_MAIN):
        sel = td["g"] == i
        solo = naive_bayes.naive_bayes_fit(Table(
            {"x": td["x"][sel], "y": label[sel]}), NB_CLASSES)
        for f in ("log_prior", "mean", "var"):
            bitwise(torch, f"naive_bayes_grouped group {i} {f}",
                    getattr(grouped, f)[i], getattr(solo, f))
    print(f"[methods] naive_bayes_grouped: each of {G_MAIN} groups bitwise "
          "equal to the solo fit on its rows")
    del tnb, model, state, ref, grouped, td, label
    part_done("naive Bayes")
    gc.collect()
    torch.cuda.empty_cache()

    # -- quantiles on a Zipf item column and a Gaussian column --------------
    tq = Table({"item": zipf_items(torch, gen, n, dev),
                "gauss": torch.randn((n,), generator=gen, device=dev),
                "g": torch.randint(0, G_MAIN, (n,), generator=gen,
                                   dtype=torch.int32, device=dev)})
    for col in ("item", "gauss"):
        v = tq[col].float()
        est = twice(f"quantiles({col}, {Q_BINS} bins, {n} rows)",
                    lambda: quantiles.quantiles(tq, list(QS), value_col=col,
                                                bins=Q_BINS))
        lo, hi = float(v.min()), float(v.max())
        hist = run_local(quantiles.HistogramAggregate(lo, hi, Q_BINS, col),
                         tq)
        f = (v - lo) * quantiles.range_scale(lo, hi, Q_BINS)
        count = torch.bincount(quantiles.bin_index(f, Q_BINS),
                               minlength=Q_BINS).float()
        bitwise(torch, f"quantiles {col} histogram vs torch.bincount", hist,
                count)
        exact = torch.quantile(v, torch.tensor(QS, device=dev))
        width = (hi - lo) / Q_BINS
        gap = float((est - exact).abs().max())
        require(gap <= width, f"quantiles {col}: {gap} from torch.quantile, "
                f"more than range/bins = {width}")
        print(f"[methods] quantiles {col}: histogram equal to torch.bincount;"
              f" max |estimate - torch.quantile| {gap:.4g} <= range/bins "
              f"{width:.4g}")
    with trace_execution() as tr:
        qg = twice(f"quantiles_grouped(gauss, G = {G_MAIN})",
                   lambda: quantiles.quantiles_grouped(
                       tq, "g", list(QS), num_groups=G_MAIN,
                       value_col="gauss", bins=Q_BINS))
    require(len(tr.sorts) == 2, f"quantiles_grouped: {len(tr.sorts)} sorts "
            "in two runs, want one each")
    require(qg.shape == (G_MAIN, len(QS)) and bool(torch.isfinite(qg).all()),
            "quantiles_grouped: not finite of the expected shape")
    print("[methods] quantiles_grouped: one sort per statement (trace)")
    del tq, v, hist, f, count, qg
    part_done("quantiles")
    gc.collect()
    torch.cuda.empty_cache()

    # -- a decision tree on section e's blobs, class = blob id mod 4 --------
    centers = torch.randn((K_KM, D_KM), generator=gen, device=dev) * CENTER_SD
    lab = torch.randint(0, K_KM, (n,), generator=gen, device=dev)
    tdt = Table({"x": centers[lab] + torch.randn((n, D_KM), generator=gen,
                                                 device=dev),
                 "y": (lab % DT_CLASSES).to(torch.int32)})
    del lab
    tree = twice(f"decision_tree_fit ({n} x {D_KM}, depth {DT_DEPTH}, "
                 f"{DT_BINS} bins)", lambda: decision_tree.decision_tree_fit(
                     tdt, num_classes=DT_CLASSES, max_depth=DT_DEPTH,
                     n_bins=DT_BINS))
    x = tdt["x"]
    lo, hi = x.amin(0), x.amax(0) + 1e-6
    for level in range(DT_DEPTH + 1):
        st = run_local(decision_tree.SplitStatsAggregate(
            tree, level, lo, hi, DT_BINS, DT_CLASSES), tdt)
        require(float(st.sum()) == n * D_KM,
                f"decision tree level {level}: split counts sum to "
                f"{float(st.sum())}, want {n * D_KM}")
    pred = decision_tree.decision_tree_predict(tree, x)
    acc = float((pred == tdt["y"]).float().mean())
    pre = Table({k: v[:DT_PREFIX] for k, v in tdt.columns.items()})
    card = decision_tree.decision_tree_fit(
        pre, num_classes=DT_CLASSES, max_depth=DT_DEPTH, n_bins=DT_BINS)
    cpu = decision_tree.decision_tree_fit(
        Table({k: v.cpu() for k, v in pre.columns.items()}),
        num_classes=DT_CLASSES, max_depth=DT_DEPTH, n_bins=DT_BINS)
    for f in ("feature", "threshold", "leaf_class"):
        require(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)),
                f"decision tree on {DT_PREFIX} rows: {f} differs between "
                "the card and the CPU")
    print(f"[methods] decision_tree_fit: split counts sum to rows x features "
          f"at every level; training accuracy {acc:.4f}; the tree on the "
          f"first {DT_PREFIX} rows equal on the card and the CPU")
    del tdt, x, pred, pre, card, cpu, centers
    part_done("the decision tree")
    gc.collect()
    torch.cuda.empty_cache()

    # -- SVD of a 10M x 160 matrix with a decaying spectrum ----------------
    u, _ = torch.linalg.qr(torch.randn((n, K_MAIN), generator=gen,
                                       device=dev))
    v, _ = torch.linalg.qr(torch.randn((K_MAIN, K_MAIN), generator=gen,
                                       device=dev))
    s_true = torch.ones(K_MAIN, device=dev)
    s_true[:SVD_K] = SVD_TOP * SVD_DECAY ** torch.arange(
        SVD_K, dtype=torch.float32, device=dev)
    ta = Table({"a": (u * s_true) @ v.T})
    del u, v
    gram = torch.zeros((K_MAIN, K_MAIN), dtype=torch.float64, device=dev)
    for r0 in range(0, n, 1_000_000):
        a64 = ta["a"][r0:r0 + 1_000_000].double()
        gram += a64.T @ a64
    want = torch.sqrt(torch.linalg.svdvals(gram)[:SVD_K])
    for name, fn in (("svd_power", svd.svd_power),
                     ("svd_randomized", svd.svd_randomized)):
        sing, _ = twice(f"{name} ({n} x {K_MAIN}, k = {SVD_K}, blocks of "
                        f"{SVD_BLOCK})", lambda fn=fn: fn(
                            ta, SVD_K, seed=SEED, block_size=SVD_BLOCK))
        rel = float(((sing.double() - want) / want).abs().max())
        require(rel <= SVD_RTOL, f"{name}: singular values {rel:.3e} "
                f"(relative) from the float64 Gram's, over {SVD_RTOL}")
        print(f"[methods] {name}: singular values within {rel:.3e} "
              f"(relative) of svdvals of the float64 Gram")
    del ta, gram
    part_done("SVD")
    gc.collect()
    torch.cuda.empty_cache()

    # -- LDA: 100,000 documents over a 4,096-word vocabulary ---------------
    rng = np.random.default_rng(SEED)
    topics = torch.from_numpy(rng.dirichlet(np.full(LDA_VOCAB, 0.05),
                                            LDA_TOPICS)).float().to(dev)
    theta = torch.from_numpy(rng.dirichlet(np.full(LDA_TOPICS, 0.3),
                                           LDA_DOCS)).float().to(dev)
    words = torch.multinomial(theta @ topics, LDA_LEN, replacement=True,
                              generator=gen)
    docs = torch.zeros((LDA_DOCS, LDA_VOCAB), dtype=torch.int32, device=dev)
    docs.scatter_add_(1, words, torch.ones_like(words, dtype=torch.int32))
    del topics, theta, words
    tl = Table({"counts": docs})
    learned, trace = twice(
        f"lda_fit ({LDA_DOCS} docs x {LDA_VOCAB} words, {LDA_TOPICS} topics, "
        f"{LDA_ROUNDS} rounds, blocks of {LDA_BLOCK})",
        lambda: lda.lda_fit(tl, LDA_TOPICS, LDA_VOCAB,
                            max_iters=LDA_ROUNDS, tol=None, seed=SEED,
                            block_size=LDA_BLOCK))
    require(len(trace) == LDA_ROUNDS and all(
        b < a for a, b in zip(trace, trace[1:])),
        f"lda_fit: perplexity does not fall (the bound does not rise) every "
        f"round: {trace}")
    require(bool(torch.isfinite(learned).all()), "lda_fit: topics not finite")
    beta = lda.dirichlet_topics(LDA_TOPICS, LDA_VOCAB, seed=SEED,
                                device="cpu").log()
    head = {"counts": docs[:LDA_CHECK_DOCS]}
    e_card = run_local(lda.LDAEStepAggregate(beta.to(dev)), Table(head))
    e_cpu = run_local(lda.LDAEStepAggregate(beta),
                      Table({"counts": head["counts"].cpu()}))
    for k in e_cpu:
        scale = float(e_cpu[k].abs().max())
        torch.testing.assert_close(e_card[k].cpu(), e_cpu[k], rtol=LDA_RTOL,
                                   atol=LDA_ATOL_SHARE * scale)
    print(f"[methods] lda_fit: perplexity by round {trace} (the bound rises "
          f"every round); E-step state on {LDA_CHECK_DOCS} documents within "
          f"rtol {LDA_RTOL} of the CPU port")
    del tl, docs, learned, e_card, head
    part_done("LDA")
    gc.collect()
    torch.cuda.empty_cache()

    # -- apriori over 10M transactions of 32 items, rules planted ----------
    items = (torch.rand((AR_ROWS, AR_ITEMS), generator=gen, device=dev)
             < AR_P).float()
    items[:, 1] = torch.maximum(items[:, 0], items[:, 1])      # 0 -> 1
    items[:, 3] = torch.maximum(items[:, 2] * (torch.rand(
        AR_ROWS, generator=gen, device=dev) < 0.9).float(), items[:, 3])
    tar = Table({"items": items})
    res = twice(f"apriori ({AR_ROWS} x {AR_ITEMS}, blocks of {AR_BLOCK})",
                lambda: assoc_rules.apriori(tar, min_support=0.05,
                                            min_confidence=0.6, max_len=3,
                                            block_size=AR_BLOCK))
    for s, supp in res.supports.items():
        count = int((items[:, list(s)] > 0).all(1).sum())
        require(supp == float(np.float32(count) / AR_ROWS),
                f"apriori: support of {s} {supp} != direct count {count}")
    require(any(r[0] == (0,) and r[1] == (1,) for r in res.rules)
            and any(r[0] == (2,) and r[1] == (3,) for r in res.rules),
            f"apriori: a planted rule was not found: {res.rules}")
    print(f"[methods] apriori: {len(res.supports)} frequent itemsets, "
          f"supports equal to direct counts; {len(res.rules)} rules, the "
          "planted 0 -> 1 and 2 -> 3 among them")
    del tar, items, res
    part_done("apriori")
    gc.collect()
    torch.cuda.empty_cache()

    # -- approximate string match over 1,000,000 strings -------------------
    length = torch.randint(8, SM_WIDTH + 1, (SM_ROWS, 1), generator=gen,
                           device=dev)
    chars = torch.randint(ord("a"), ord("z") + 1, (SM_ROWS, SM_WIDTH),
                          generator=gen, device=dev).to(torch.uint8)
    chars[torch.arange(SM_WIDTH, device=dev)[None, :] >= length] = 0
    planted = SM_ROWS // 3
    near = SM_QUERY.replace("lazy", "hazy")
    chars[planted] = string_match.encode_strings([near], SM_WIDTH,
                                                 device=dev)[0]
    ts = Table({"chars": chars, "doc_id": torch.arange(
        SM_ROWS, dtype=torch.int32, device=dev)})
    index = twice(f"trigram index ({SM_ROWS} strings x {SM_WIDTH}, "
                  f"{SM_BUCKETS} buckets)", lambda: run_local(
                      string_match.TrigramIndexAggregate(SM_ROWS, SM_BUCKETS),
                      ts))
    idx, scores = twice("approx_match", lambda: string_match.approx_match(
        index, SM_QUERY, threshold=0.3, width=SM_WIDTH))
    top = int(torch.argmax(scores))
    require(top == planted and int(idx[0]) == planted,
            f"approx_match: the planted near-duplicate (row {planted}) is "
            f"not ranked first (top row {top}, first hit {int(idx[0])})")
    pre = {k: v[:SM_PREFIX] for k, v in ts.columns.items()}
    card = run_local(string_match.TrigramIndexAggregate(SM_PREFIX, SM_BUCKETS),
                     Table(pre))
    cpu = run_local(string_match.TrigramIndexAggregate(SM_PREFIX, SM_BUCKETS),
                    Table({k: v.cpu() for k, v in pre.items()}))
    require(torch.equal(card.cpu(), cpu), "trigram index on the first "
            f"{SM_PREFIX} strings differs between the card and the CPU")
    print(f"[methods] approx_match: the planted near-duplicate ranked first "
          f"(score {float(scores[planted]):.4f}); index on {SM_PREFIX} "
          "strings bitwise equal to the CPU port")
    del ts, chars, index, scores, card, cpu
    part_done("string match")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[methods] section j took {time.perf_counter() - t_section:.1f} s")
    return steps


# ---------------------------------------------------------------------------
# k. the §5.1 convex layer and what runs on it, at full size, on tables made
# on the card from the seed.
# ---------------------------------------------------------------------------

# the solvers' checks: max |solver - reference| within CONVEX_RTOL of the
# reference's max |coef| (f32 solves of the same normal equations, or of the
# same likelihood to convergence)
CONVEX_RTOL = 1e-3
# rows per block of the Newton passes: 10^7 / 16, so the fold pads no tail
# (a padded tail copies every column), and torch.func.hessian's 160
# per-tangent intermediates stay at 160 x 625,000 x 4 B = 0.4 GB each
NEWTON_BLOCK = 625_000
NEWTON_TOL, CG_TOL_SHARE = 1e-5, 1e-6
GD_STEPSIZE, GD_ROUNDS = 2e-5, 5
# Bismarck's Forest covertype workload: 581,012 rows x 54 features; the
# Table 2 models by SGD, batch 128, one epoch each (with one epoch,
# annealing's stepsize / (1 + epoch) is the stepsize itself, as the
# benchmark's anneal=False has it)
COV_ROWS, COV_FEATURES, SGD_BATCH, SGD_EPOCHS = 581_012, 54, 128, 1
SGD_STEPS = {"least_squares": 0.002, "lasso": 0.002, "logistic": 0.01,
             "svm": 0.01}
SVM_ACCURACY = 0.97
# MovieLens-1M: 6,040 users x 3,706 movies, 1,000,209 ratings; rank 10
ML_USERS, ML_ITEMS, ML_RATINGS, ML_RANK = 6_040, 3_706, 1_000_209, 10
ML_BATCH, ML_EPOCHS = 256, 2
# CoNLL-2000 chunking: 8,936 training sentences (211,727 tokens, 23.7 a
# sentence), 23 chunk tags; padded to T = 64 with a length mask; 2^18 hashed
# features (word, previous word, position, dictionary) over a 20,000-word
# vocabulary of which 10% is in the dictionary
CONLL_SENTS, CONLL_T, CONLL_LABELS, CONLL_FEATURES = 8_936, 64, 23, 1 << 18
CONLL_VOCAB, CONLL_MEAN_LEN, CRF_BATCH, CRF_STEPSIZE = 20_000, 23.7, 128, 0.3
GIBBS_SWEEPS, MH_STEPS = 20, 200
# xtx at narrow widths on 10^7 dyadic rows (the paper's Fig. 4 sweeps K
# over 10-320), K_NARROW = 120 and the first width past it among them;
# the narrow kernel's micro-tiles fill a CTA up to K = 176
XTX_WIDTHS = (1, 8, 10, 16, 20, 32, 40, 64, 80, 96, 120, 128, 160, 320)
XTX_NARROW_REPS = 10
XTX_NARROW_MAX = 176


def convex_section(torch, dev, counters, errs, smi) -> dict:
    """Section k: the convex solvers at the main path's width (10^7 x
    160), Table 2's models by SGD at Forest covertype's shape, low-rank
    recommendation at MovieLens-1M's, the CRF at CoNLL-2000's, and xtx at
    narrow widths beside its bound.  Each statement's first and repeated
    seconds are printed.  The steps that launch kernels (the grouped OLS
    task, and the linregr fits the solvers are held to) run between a
    zero and a read of the launch counters; returns their launches by
    step."""
    from repro_torch.core import (
        Table, conjugate_gradient, fit_grouped, gradient_descent, newton, sgd)
    from repro_torch.kernels.xtx import ops as xtx_ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref
    from repro_torch.methods import crf, svd, svm
    from repro_torch.methods.linregr import (
        LinregrTask, linregr, linregr_grouped)
    from repro_torch.methods.logregr import logistic_program, logregr
    from repro_torch.methods.sgd_models import (
        REGISTRY, fit_sgd_model, least_squares_program)

    t_section = time.perf_counter()
    steps: dict[str, dict[str, int]] = {}
    summary: dict = {"device": smi}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)

    def main_step(label, fn):
        counters.zero()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = {k: v for k, v in counters.read().items() if v}
        return out

    def twice(what, fn, step=None):
        """``fn()`` run twice: the first result and both host seconds.
        With ``step``, the first run is that main-path step (counted) and
        the repeat only times it."""
        out, first = timed(torch, fn if step is None
                           else lambda: main_step(step, fn))
        _, again = timed(torch, fn)
        print(f"[convex] {what}: first {first:.4f} s, repeated {again:.4f} "
              f"s; {smi}")
        summary[what] = [first, again]
        return out

    def rel(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    t_part = [time.perf_counter()]

    def part_done(what):
        now = time.perf_counter()
        print(f"[convex] {what}: {now - t_part[0]:.1f} s of section k")
        t_part[0] = now

    # -- the solvers at the main path's width: y = x b + e and a 0/1 label
    # from sigmoid(x b_l), x and y dyadic (x b exact: b in multiples of 1/8)
    n, k = N_MAIN, K_MAIN
    x = dyadic(torch, gen, (n, k), dev)
    b = torch.randint(-8, 9, (k,), generator=gen, device=dev).float() / 8
    y = x @ b + dyadic(torch, gen, (n,), dev)
    b_l = 2.0 * torch.randn((k,), generator=gen, device=dev)
    lab = (torch.rand((n,), generator=gen, device=dev)
           < torch.sigmoid(x @ b_l)).float()
    g = torch.randint(0, G_MAIN, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    t_reg = Table({"x": x, "y": y})
    t_cls = Table({"x": x, "y": lab})
    zeros = torch.zeros((k,), device=dev)

    ols = main_step("linregr (the solvers' reference)",
                    lambda: linregr(t_reg, use_kernel=True)).coef
    w_ls = twice(f"newton(least_squares_program) ({n}, {k}), 1 step",
                 lambda: newton(least_squares_program(), t_reg, zeros,
                                max_iters=1, tol=None, ridge=0.0,
                                block_size=NEWTON_BLOCK))[0]
    e_ls = rel(w_ls, ols)
    require(e_ls <= CONVEX_RTOL, f"newton(least_squares) one step is "
            f"{e_ls:.3e} of max |coef| off linregr")
    irls = logregr(t_cls)
    w_lg, tr_lg, conv_lg = twice(
        f"newton(logistic_program) ({n}, {k}), tol {NEWTON_TOL}",
        lambda: newton(logistic_program(), t_cls, zeros, max_iters=20,
                       tol=NEWTON_TOL, block_size=NEWTON_BLOCK))
    e_lg = rel(w_lg, irls.coef)
    require(conv_lg and irls.converged, "newton(logistic) or IRLS did not "
            "converge")
    require(e_lg <= CONVEX_RTOL, f"newton(logistic) is {e_lg:.3e} of max "
            "|coef| off IRLS")
    rhs = x.T @ y
    w_cg, res_cg, it_cg = twice(
        f"conjugate_gradient X^T X w = X^T y ({n}, {k})",
        lambda: conjugate_gradient(lambda v: x.T @ (x @ v), rhs,
                                   tol=CG_TOL_SHARE * float(rhs.norm())))
    e_cg = rel(w_cg, ols)
    require(e_cg <= CONVEX_RTOL, f"conjugate_gradient is {e_cg:.3e} of max "
            "|coef| off linregr")
    _, tr_gd, _ = twice(
        f"gradient_descent(logistic_program) ({n}, {k}), {GD_ROUNDS} rounds",
        lambda: gradient_descent(logistic_program(), t_cls, zeros,
                                 stepsize=GD_STEPSIZE, max_iters=GD_ROUNDS))
    losses = [r[0] for r in tr_gd]
    require(len(losses) == GD_ROUNDS and all(
        a > c for a, c in zip(losses, losses[1:])),
        f"gradient_descent: the loss does not fall every round: {losses}")
    print(f"[convex] newton(least_squares) vs linregr {e_ls:.3e}; "
          f"newton(logistic) {len(tr_lg)} rounds vs IRLS {irls.n_iters} "
          f"rounds, {e_lg:.3e}; conjugate_gradient {it_cg} iterations "
          f"(residual {float(res_cg):.3e}), {e_cg:.3e} (relative to max "
          f"|coef|); gradient_descent losses {losses}")
    summary.update({"newton_logistic_rounds": len(tr_lg),
                    "irls_rounds": irls.n_iters, "cg_iterations": it_cg,
                    "errors": [e_ls, e_lg, e_cg], "gd_losses": losses})
    del w_ls, w_lg, w_cg, rhs, irls, t_cls, lab

    # fit_grouped(LinregrTask) through xtx, one launch per non-empty group
    tg = Table({"x": x, "y": y, "g": g})
    groups = int((torch.bincount(g, minlength=G_MAIN) > 0).sum())
    step = f"fit_grouped(LinregrTask) ({n}, {k}), G = {G_MAIN}"
    fg = twice(f"fit_grouped(LinregrTask(use_kernel=True)) ({n}, {k}), "
               f"G = {G_MAIN}", lambda: fit_grouped(
                   LinregrTask(use_kernel=True), tg, "g", G_MAIN,
                   max_iters=1, tol=None), step=step)
    launched = steps[step]
    require(launched.get("xtx", 0) == groups and set(launched) == {"xtx"},
            f"fit_grouped(LinregrTask): launches {launched}, want xtx once "
            f"per non-empty group ({groups})")
    lg = main_step(f"linregr_grouped ({n}, {k}), G = {G_MAIN} (reference "
                   "of fit_grouped)", lambda: linregr_grouped(
                       tg, "g", G_MAIN, use_kernel=True))
    e_fg = rel(fg.result.coef, lg.coef)
    require(torch.equal(fg.result.num_rows, lg.num_rows) and e_fg <= 1e-4,
            f"fit_grouped(LinregrTask) is {e_fg:.3e} off linregr_grouped")
    # xtx at the task's launch shape: the first group's rows
    view = tg.group_by("g", G_MAIN)
    r0, r1 = int(view.offsets[0]), int(view.offsets[1])
    xg, yg = view.table["x"][r0:r1], view.table["y"][r0:r1]
    errs["xtx"] = max(errs["xtx"], *(bitwise(
        torch, f"xtx at one group's rows ({r1 - r0}, {k})", a, c)
        for a, c in zip(xtx_ops.xtx_xty(xg, yg), xtx_xty_ref(xg, yg))))
    print(f"[convex] fit_grouped(LinregrTask): {launched.get('xtx', 0)} xtx "
          f"launches for {groups} non-empty groups, coefficients {e_fg:.3e} "
          "of max |coef| off linregr_grouped; xtx bitwise its plain version "
          f"at ({r1 - r0}, {k})")
    summary["fit_grouped_error"] = e_fg
    del x, y, g, b, b_l, t_reg, tg, fg, lg, view, xg, yg, ols, zeros
    part_done("the solvers at 10^7 x 160")
    gc.collect()
    torch.cuda.empty_cache()

    # -- Table 2 by SGD at Forest covertype's shape: two Gaussian classes at
    # +-1.5 (tests/test_methods.py's separable draw), y = x b + 0.1 e
    m, d = COV_ROWS, COV_FEATURES
    cls = (torch.rand((m,), generator=gen, device=dev) < 0.5).float()
    xc = torch.randn((m, d), generator=gen, device=dev) \
        + 1.5 * (1.0 - 2.0 * cls)[:, None]
    bc = torch.randn((d,), generator=gen, device=dev)
    yc = xc @ bc + 0.1 * torch.randn((m,), generator=gen, device=dev)
    tables = {"least_squares": Table({"x": xc, "y": yc}),
              "lasso": Table({"x": xc, "y": yc}),
              "logistic": Table({"x": xc, "y": cls}),
              "svm": Table({"x": xc, "y": cls})}
    every = torch.ones((m,), dtype=torch.bool, device=dev)
    n_steps = m // SGD_BATCH * SGD_EPOCHS
    summary["sgd"] = {}
    for name, tbl in tables.items():
        prog = REGISTRY[name]()
        w0 = torch.zeros((d,), device=dev)
        w, secs = timed(torch, lambda: fit_sgd_model(
            name, tbl, w0, epochs=SGD_EPOCHS, stepsize=SGD_STEPS[name],
            batch=SGD_BATCH, seed=SEED))
        f0 = float(prog.total_loss(w0, tbl.columns, every))
        f1 = float(prog.total_loss(w, tbl.columns, every))
        require(f1 < f0, f"fit_sgd_model({name}): the objective did not "
                f"fall ({f0} -> {f1})")
        print(f"[convex] fit_sgd_model({name}) ({m}, {d}), batch "
              f"{SGD_BATCH}: {secs / SGD_EPOCHS:.3f} s an epoch, "
              f"{n_steps / secs:.0f} steps/s; objective {f0:.6g} -> "
              f"{f1:.6g}; {smi}")
        summary["sgd"][name] = {"s_per_epoch": secs / SGD_EPOCHS,
                                "steps_per_s": n_steps / secs,
                                "objective": [f0, f1]}
    w, secs = timed(torch, lambda: svm.svm_fit(
        tables["svm"], epochs=SGD_EPOCHS, batch=SGD_BATCH, seed=SEED))
    acc = float((svm.svm_predict(w, xc) == cls.to(torch.int32))
                .float().mean())
    require(acc > SVM_ACCURACY, f"svm_fit accuracy {acc} <= {SVM_ACCURACY}")
    print(f"[convex] svm_fit ({m}, {d}), {SGD_EPOCHS} epoch: accuracy "
          f"{acc:.5f}, {secs:.3f} s; {smi}")
    summary["svm_fit"] = {"accuracy": acc, "s": secs}
    del xc, yc, cls, bc, tables, every, w
    part_done("Table 2 by SGD")

    # -- low-rank recommendation at MovieLens-1M's shape: ratings from a
    # planted rank-10 model (unit-variance products) plus noise
    scale = ML_RANK ** -0.25
    l0 = scale * torch.randn((ML_USERS, ML_RANK), generator=gen, device=dev)
    r0 = scale * torch.randn((ML_ITEMS, ML_RANK), generator=gen, device=dev)
    ii = torch.randint(0, ML_USERS, (ML_RATINGS,), generator=gen, device=dev)
    jj = torch.randint(0, ML_ITEMS, (ML_RATINGS,), generator=gen, device=dev)
    vv = (l0[ii] * r0[jj]).sum(-1) \
        + 0.1 * torch.randn((ML_RATINGS,), generator=gen, device=dev)
    tr = Table({"i": ii.float(), "j": jj.float(), "v": vv})

    def rmse(p):
        pred = (p["L"][ii] * p["R"][jj]).sum(-1)
        return float(torch.sqrt(torch.mean((pred - vv) ** 2)))

    p0 = svd.lowrank_sgd(tr, ML_USERS, ML_ITEMS, ML_RANK, epochs=0,
                         seed=SEED)
    p, secs = timed(torch, lambda: svd.lowrank_sgd(
        tr, ML_USERS, ML_ITEMS, ML_RANK, epochs=ML_EPOCHS, batch=ML_BATCH,
        seed=SEED))
    before, after = rmse(p0), rmse(p)
    require(after < before, f"lowrank_sgd: RMSE did not fall ({before} -> "
            f"{after})")
    ml_steps = ML_RATINGS // ML_BATCH * ML_EPOCHS
    print(f"[convex] lowrank_sgd {ML_USERS} x {ML_ITEMS}, {ML_RATINGS} "
          f"ratings, rank {ML_RANK}, batch {ML_BATCH}: "
          f"{secs / ML_EPOCHS:.3f} s an epoch, {ml_steps / secs:.0f} "
          f"steps/s; RMSE {before:.4f} -> {after:.4f} (ratings' std "
          f"{float(vv.std()):.4f}); {smi}")
    summary["lowrank"] = {"s_per_epoch": secs / ML_EPOCHS,
                          "steps_per_s": ml_steps / secs,
                          "rmse": [before, after]}
    del l0, r0, ii, jj, vv, tr, p0, p
    part_done("low-rank recommendation")

    # -- the CRF at CoNLL-2000 chunking's shape
    B, T, L, F = CONLL_SENTS, CONLL_T, CONLL_LABELS, CONLL_FEATURES
    toks = torch.randint(0, CONLL_VOCAB, (B, T), generator=gen,
                         dtype=torch.int32, device=dev)
    lengths = (CONLL_MEAN_LEN + 11.0 * torch.randn(
        (B,), generator=gen, device=dev)).round().clamp(1, T)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).float()
    noise = torch.randint(0, L, (B, T), generator=gen, dtype=torch.int32,
                          device=dev)
    keep = torch.rand((B, T), generator=gen, device=dev) < 0.8
    labels = torch.where(keep, (toks * 7) % L, noise).to(torch.int32)
    dictionary = (torch.rand((CONLL_VOCAB,), generator=gen, device=dev)
                  < 0.1).to(torch.int32)
    feats = twice(f"extract_features ({B}, {T}) into 2^18",
                  lambda: crf.extract_features(toks, F, dictionary))
    cpu_feats = crf.extract_features(toks.cpu(), F, dictionary.cpu())
    require(torch.equal(feats.cpu(), cpu_feats),
            "extract_features on the card differs from the CPU port")
    tc = Table({"feats": feats, "labels": labels, "mask": mask})
    init = crf.crf_init_params(F, L, seed=SEED, device=dev)
    ll0 = float(crf.crf_log_likelihood(init, feats, labels, mask))
    params, secs = timed(torch, lambda: sgd(
        crf.crf_program(F, L, mu=1e-4), tc, init, stepsize=CRF_STEPSIZE,
        epochs=1, batch=CRF_BATCH, seed=SEED))
    ll1 = float(crf.crf_log_likelihood(params, feats, labels, mask))
    require(ll1 > ll0, f"CRF sgd: the log-likelihood did not rise ({ll0} "
            f"-> {ll1})")
    crf_steps = B // CRF_BATCH
    print(f"[convex] sgd(crf_program) ({B}, {T}), {L} labels, batch "
          f"{CRF_BATCH}: {secs:.3f} s an epoch, {crf_steps / secs:.1f} "
          f"steps/s; log-likelihood {ll0:.6g} -> {ll1:.6g}; {smi}")
    vit = twice(f"viterbi_decode ({B}, {T}, {L})",
                lambda: crf.viterbi_decode(params, feats, mask))
    cpu_params = {q: v.cpu() for q, v in params.items()}
    require(torch.equal(vit.cpu(), crf.viterbi_decode(
        cpu_params, cpu_feats, mask.cpu())),
        "viterbi_decode on the card differs from the CPU port")
    _, marg = twice(f"gibbs_sample ({B}, {T}), {GIBBS_SWEEPS} sweeps",
                    lambda: crf.gibbs_sample(params, feats, mask, seed=SEED,
                                             n_sweeps=GIBBS_SWEEPS))
    sums = marg.sum(-1)
    require(bool(((sums - 1.0).abs() < 1e-5).all()),
            "gibbs_sample: marginals do not sum to 1")
    _, rate = twice(f"mh_sample ({B}, {T}), {MH_STEPS} steps",
                    lambda: crf.mh_sample(params, feats, mask, seed=SEED,
                                          n_steps=MH_STEPS))
    require(0.0 < float(rate) <= 1.0, f"mh_sample: acceptance {rate}")
    acc = float((vit == labels)[mask > 0].float().mean())
    print(f"[convex] CRF: Viterbi labels equal to the CPU port's on all {B} "
          f"sentences (token accuracy {acc:.4f}); Gibbs marginals sum to 1; "
          f"MH acceptance {float(rate):.4f}")
    summary["crf"] = {"s_per_epoch": secs, "steps_per_s": crf_steps / secs,
                      "log_likelihood": [ll0, ll1],
                      "mh_acceptance": float(rate), "viterbi_accuracy": acc}
    del toks, lengths, mask, noise, keep, labels, dictionary, feats, tc
    del init, params, cpu_params, cpu_feats, vit, marg, sums
    part_done("the CRF")
    gc.collect()
    torch.cuda.empty_cache()

    # -- xtx at narrow widths on 10^7 dyadic rows, one width at a time:
    # the path xtx_xty takes (the narrow kernel up to K_NARROW) and the
    # other path where it exists (the narrow kernel's micro-tiles fill a
    # CTA up to K = XTX_NARROW_MAX), both bitwise the plain version, timed
    # beside torch.matmul(x.T, x) and the bound
    narrow = []
    for kw in XTX_WIDTHS:
        xw = dyadic(torch, gen, (N_MAIN, kw), dev)
        yw = dyadic(torch, gen, (N_MAIN,), dev)
        path = "narrow" if kw <= xtx_ops.K_NARROW else "wide"
        other = "wide" if path == "narrow" else "narrow"
        want = xtx_xty_ref(xw, yw)
        runs = {path: lambda: xtx_ops.xtx_xty(xw, yw)}
        if other == "wide" or kw <= XTX_NARROW_MAX:
            runs[other] = lambda: xtx_ops._launch(xw, yw, other == "narrow")
        for name, fn in runs.items():
            got = fn()
            errs["xtx"] = max(errs["xtx"], *(bitwise(
                torch, f"xtx ({N_MAIN}, {kw}) {name} path", a, c)
                for a, c in zip(got, want)))
            require(torch.equal(got[0], got[0].T),
                    f"xtx ({N_MAIN}, {kw}) {name} path: not bitwise symmetric")
        del got, want
        ms = cuda_ms(torch, runs[path], XTX_NARROW_REPS)
        other_ms = (cuda_ms(torch, runs[other], XTX_NARROW_REPS)
                    if other in runs else None)
        mm = cuda_ms(torch, lambda: torch.matmul(xw.T, xw), XTX_NARROW_REPS)
        # each call alone on the card (the host's time hidden), and the
        # host's microseconds a call at 4,096 rows (no wait for the card)
        alone = alone_ms(torch, runs[path], XTX_NARROW_REPS)
        mm_alone = alone_ms(torch, lambda: torch.matmul(xw.T, xw),
                            XTX_NARROW_REPS)
        xs, ys = xw[:4096], yw[:4096]
        host_us = host_call_us(torch, lambda: xtx_ops.xtx_xty(xs, ys))
        mm_host_us = host_call_us(torch, lambda: torch.matmul(xs.T, xs))
        t_ops, t_bytes = xtx_ops.xtx_cost(N_MAIN, kw)
        t_ops, t_bytes = (t_ops / PEAK_F32_FLOPS * 1e3,
                          t_bytes / PEAK_BYTES * 1e3)
        row = {"k": kw, "rows": N_MAIN, "path": path, "ms": ms,
               "other_path": other, "other_ms": other_ms, "matmul_ms": mm,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops_ms": t_ops, "bytes_ms": t_bytes,
               "bound_share": max(t_ops, t_bytes) / ms,
               "alone_ms": alone, "matmul_alone_ms": mm_alone,
               "host_us": host_us, "matmul_host_us": mm_host_us,
               "faster_than_matmul": ms < mm and alone < mm_alone}
        other_s = ("not run (too wide for its micro-tiles)"
                   if other_ms is None else f"{other_ms:.4f} ms")
        print(f"[convex] xtx ({N_MAIN}, {kw}), {path} path: {ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{row['bound_share']:.1%} of it), torch.matmul(x.T, x) "
              f"{mm:.4f} ms, the {other} path {other_s}; each call alone "
              f"{alone:.4f} ms against torch.matmul's {mm_alone:.4f}, host "
              f"{host_us:.1f} us a call against {mm_host_us:.1f}; each "
              f"path run bitwise the plain version; {smi}")
        narrow.append(row)
        del xw, yw, xs, ys, runs
        torch.cuda.empty_cache()
    # a K = 10 view that starts 4 bytes off 16, as a segment view may
    kv = 10
    flat = dyadic(torch, gen, (N_MAIN * kv + 1,), dev)
    xv, yv = flat[1:].view(N_MAIN, kv), dyadic(torch, gen, (N_MAIN,), dev)
    require(xv.data_ptr() % 16 != 0, "the K = 10 view is 16-byte aligned")
    want = xtx_xty_ref(xv, yv)
    for name, got in (("narrow", xtx_ops._launch(xv, yv, True)),
                      ("wide", xtx_ops._launch(xv, yv, False))):
        errs["xtx"] = max(errs["xtx"], *(bitwise(
            torch, f"xtx ({N_MAIN}, {kv}) view off 16 bytes, {name} path",
            a, c) for a, c in zip(got, want)))
    print(f"[convex] xtx ({N_MAIN}, {kv}) on a view {xv.data_ptr() % 16} "
          "bytes off 16: both paths bitwise the plain version")
    del flat, xv, yv, want, got
    # Gaussian K = 8: the narrow kernel no farther from a float64 sum
    # than the plain version
    xg = torch.randn((N_MAIN, 8), generator=gen, device=dev)
    yg = torch.randn((N_MAIN,), generator=gen, device=dev)
    got = dict(zip(("xtx", "xty"), xtx_ops.xtx_xty(xg, yg)))
    plain = dict(zip(("xtx", "xty"), xtx_xty_ref(xg, yg)))
    wide = dict(zip(("xtx", "xty"), xtx_ops._launch(xg, yg, False)))
    x64 = xg.double()
    exact = {"xtx": x64.T @ x64, "xty": x64.T @ yg.double()}
    err_k, scale = max_err(torch, got, exact)
    err_p, err_w = max_err(torch, plain, exact)[0], max_err(
        torch, wide, exact)[0]
    diff = max_err(torch, got, plain)[0]
    require(err_k <= err_p, f"xtx ({N_MAIN}, 8) narrow gaussian: kernel "
            f"error {err_k} vs float64 exceeds the plain version's {err_p}")
    errs["xtx"] = max(errs["xtx"], diff)
    print(f"[convex] xtx ({N_MAIN}, 8) narrow gaussian: max error vs "
          f"float64 kernel {err_k:.3e}, plain {err_p:.3e}, wide path "
          f"{err_w:.3e} (max |sum| {scale:.3e}); kernel vs plain {diff:.3e}")
    summary["xtx_gaussian_k8"] = {"kernel": err_k, "plain": err_p,
                                  "wide": err_w, "scale": scale}
    del xg, yg, got, plain, wide, x64, exact
    print(json.dumps({"xtx_narrow": narrow, "device": smi}))
    part_done("xtx at narrow widths")
    summary["seconds"] = time.perf_counter() - t_section
    print(json.dumps({"convex_section": summary}))
    print(f"[convex] section k took {summary['seconds']:.1f} s")
    return steps


# ---------------------------------------------------------------------------
# n. the sharded engine: a single-controller mesh of segments on one card
# ---------------------------------------------------------------------------

SHARD_SEGS = (1, 8, 24)      # 24: the paper's top segment count (§4.4)
SHARD_REPS = 3               # repeated runs timed: the best counts


def sharded_section(torch, dev, counters, errs, smi) -> dict:
    """Section h's dyadic N_MAIN x K_MAIN table (``x``, ``y``, a Zipf
    ``item``, G_MAIN groups ``g``) and section e's blobs, made on the card
    from the seed, distributed over meshes of SHARD_SEGS segments on one
    card (24 after ``pad_to`` a multiple of 24, with its mask).  At each
    count the main path's statements run on the sharded engines, each
    between a zero and a read of the launch counters: ``linregr`` and
    ``linregr_grouped`` (fold states), a ``Session`` batch of profile,
    linregr, Count-Min and FM (one planned scan), the grouped Count-Min
    and FM, and ``kmeans_fit`` (k = K_KM).  Each is held against the
    local engine on the same table: bitwise, and k-means in two steps.
    One Lloyd round from the seeds, where rounding cannot compound, is
    held by km_round_check; the fit to convergence keeps equal rounds,
    at most KM_SHARD_ROWS_APART rows assigned apart and the SSE within
    1e-5.  Launches are held against the segment count; seconds of both
    engines are printed beside the card.  Then xtx, countmin and
    kmeans_assign against their plain versions on a segment view that
    starts off 16 bytes.  Returns the main path's launches by step."""
    from repro_torch.core import (
        ProfileAggregate, Session, make_mesh, run_grouped, run_local,
        run_sharded, trace_execution)
    from repro_torch.core.table import Table
    from repro_torch.kernels.countmin import ops as cm_ops
    from repro_torch.kernels.countmin.ref import countmin_block_ref
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.kmeans_assign.ref import assign_and_reduce_ref
    from repro_torch.kernels.xtx import ops as xtx_ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref
    from repro_torch.methods.kmeans import (
        KMeansAggregate, kmeans_fit, kmeans_pp_seed)
    from repro_torch.methods.linregr import LinregrAggregate
    from repro_torch.methods.sketches import CountMinAggregate, FMAggregate
    from repro_torch.tree import tree_leaves

    t_section = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 25)
    base = Table({"x": dyadic(torch, gen, (N_MAIN, K_MAIN), dev),
                  "y": dyadic(torch, gen, (N_MAIN,), dev),
                  "item": zipf_items(torch, gen, N_MAIN, dev),
                  "g": torch.randint(0, G_MAIN, (N_MAIN,), generator=gen,
                                     dtype=torch.int32, device=dev)})
    centers = torch.randn((K_KM, D_KM), generator=gen, device=dev) \
        * CENTER_SD
    lab = torch.randint(0, K_KM, (N_MAIN,), generator=gen, device=dev)
    blobs = Table({"x": centers[lab] + torch.randn(
        (N_MAIN, D_KM), generator=gen, device=dev)})
    del lab
    seeds = kmeans_pp_seed(blobs, K_KM, SEED)
    torch.cuda.synchronize()
    print(f"[sharded] tables made on the card: {N_MAIN} x {K_MAIN} dyadic "
          f"and {N_MAIN} x {D_KM} blobs, {time.perf_counter() - t_section:.1f}"
          f" s; {smi}")
    steps: dict[str, dict[str, int]] = {}
    seconds: list[dict] = []

    def states_equal(what, got, want):
        a, b = tree_leaves(got), tree_leaves(want)
        require(len(a) == len(b), f"{what}: states differ in shape")
        for x, y in zip(a, b):
            bitwise(torch, what, x, y)

    def statements(tbl, mask):
        """The main path's statements over ``tbl`` (any engine: the
        table's distribution decides), each returning what is held."""
        def batch():
            s = Session()
            hs = [s.scan(agg, tbl, columns=cols, mask=mask, label=label)
                  for label, agg, cols in (
                      ("profile", ProfileAggregate(), ("x", "y")),
                      ("linregr", LinregrAggregate(use_kernel=True),
                       {"x": "x", "y": "y"}),
                      ("countmin", CountMinAggregate(use_kernel=True),
                       ("item",)),
                      ("fm", FMAggregate(), ("item",)))]
            s.run()
            return s.last_plan, [h.result() for h in hs]

        def grouped(agg, cols):
            return lambda: run_grouped(agg, tbl.select(*cols), "g", G_MAIN,
                                       mask=mask, method="segment",
                                       finalize=False)

        return {
            "linregr": lambda: (run_sharded if tbl.mesh is not None
                                else run_local)(
                LinregrAggregate(use_kernel=True), tbl.select("x", "y"),
                mask=mask, finalize=False),
            "linregr_grouped": grouped(LinregrAggregate(use_kernel=True),
                                       ("x", "y", "g")),
            "session batch": batch,
            "countmin_grouped": grouped(CountMinAggregate(use_kernel=True),
                                        ("item", "g")),
            "fm_grouped": grouped(FMAggregate(use_kernel=True),
                                  ("item", "g")),
        }

    want_launch = {"linregr": {"xtx": 1},
                   "linregr_grouped": {"segment_linregr": 1},
                   "session batch": {"xtx": 1, "countmin": 1,
                                     "column_stats": 2},
                   "countmin_grouped": {"segment_countmin": 1},
                   "fm_grouped": {"segment_fm": 1}}
    for segs in SHARD_SEGS:
        n_pad = -(-N_MAIN // segs) * segs      # 10,000,008 at 24 segments
        padded = n_pad != N_MAIN
        if padded:
            tbl, mask = base.pad_to(n_pad)
            btbl, _ = blobs.pad_to(n_pad)
        else:
            tbl, mask, btbl = base, None, blobs
        mesh = make_mesh((segs,), ("data",), devices=[dev] * segs)
        dist, bdist = tbl.distribute(mesh), btbl.distribute(mesh)
        local_runs = statements(tbl, mask)
        for name, run in statements(dist, mask).items():
            label = f"{name}, {segs} segment{'s' * (segs > 1)}" + (
                f" (padded to {n_pad})" if padded else "")
            counters.zero()
            with trace_execution() as tr:
                got, s_first = timed(torch, run)
            steps[label] = {k: v for k, v in counters.read().items() if v}
            want = local_runs[name]()
            # repeated, each engine: the best of SHARD_REPS is printed
            s_sh = min(timed(torch, run)[1] for _ in range(SHARD_REPS))
            s_lo = min(timed(torch, local_runs[name])[1]
                       for _ in range(SHARD_REPS))
            if name == "session batch":
                (plan_sh, got), (plan_lo, want) = got, want
                engine = plan_sh.passes[0].engine
                require(len(plan_sh.passes) == 1 and len(tr.scans) == 1,
                        f"{label}: {len(tr.scans)} scans, want one")
                require(engine == ("sharded" if segs > 1 else "local"),
                        f"{label}: planned on {engine}")
                print(f"[sharded] {label}: one planned scan on the "
                      f"{engine} engine (the cost model's choice)")
            # the local engine launches once where the planner keeps it
            per = segs if (name != "session batch" or segs > 1) else 1
            expect = {k: v * per for k, v in want_launch[name].items()}
            require(steps[label] == expect,
                    f"{label}: launches {steps[label]}, want {expect}")
            states_equal(f"sharded {label} vs local", got, want)
            seconds.append({"statement": name, "segments": segs,
                            "sharded_s": s_sh, "local_s": s_lo,
                            "ratio": s_sh / s_lo, "sharded_first_s": s_first})
            print(f"[sharded] {label}: {s_sh:.4f} s sharded vs {s_lo:.4f} s "
                  f"local ({s_sh / s_lo:.2f}x; best of {SHARD_REPS} repeats, "
                  f"host clock, synchronized; the counted run {s_first:.4f} "
                  "s); launches "
                  f"{steps[label]}, fold state bitwise the local engine's; "
                  f"{smi}")
            del got, want
        # one Lloyd round from the seeds on each engine (a check, not
        # counted: one kmeans_assign launch per segment), where rounding
        # cannot compound: the counts, the sums and the SSE by
        # km_round_check, the centroids within section e's tolerance
        label = f"kmeans round k={K_KM}, {segs} segment" + "s" * (segs > 1)
        counters.zero()
        r_sh = run_sharded(KMeansAggregate(seeds, None, use_kernel=True),
                           bdist, finalize=False)
        require(counters.peek()["kmeans_assign"] == segs,
                f"{label}: {counters.peek()['kmeans_assign']} launches, "
                f"want {segs}")
        r_lo = run_local(KMeansAggregate(seeds, None, use_kernel=True), btbl,
                         finalize=False)
        one_round = km_round_check(
            torch, label, btbl["x"], seeds, km_ops.assign_and_reduce(
                btbl["x"], seeds, torch.ones((btbl.n_rows,), device=dev))[0],
            r_sh, r_lo)
        c_sh, c_lo = (KMeansAggregate(seeds, None).final(r)["centroids"]
                      for r in (r_sh, r_lo))
        one_round["centroid_max_diff"] = float((c_sh - c_lo).abs().max())
        require(torch.allclose(c_sh, c_lo, rtol=1e-4, atol=1e-3),
                f"{label}: centroids differ from local by "
                f"{one_round['centroid_max_diff']}")
        print(f"[sharded] {label}: {one_round['rows_apart']} rows assigned "
              f"apart from kmeans_assign's own ({one_round['near_ties']} "
              f"near ties), sums within {one_round['sums_err']:.4e} of "
              f"float64 (local {one_round['sums_err_local']:.4e}, limit "
              f"{one_round['sums_limit']:.4e}), SSE within "
              f"{one_round['sse_err']:.4e} (local "
              f"{one_round['sse_err_local']:.4e}), centroids within "
              f"{one_round['centroid_max_diff']:.3e} of local (section e's "
              "tolerance met)")
        del r_sh, r_lo, c_sh, c_lo
        # k-means from the same seeds on the blobs, sharded vs local
        kw = {"init_centroids": seeds, "use_kernel": True,
              "max_iters": KM_MAX_ITERS, "reassign_frac_tol": KM_REASSIGN_TOL}
        label = f"kmeans_fit k={K_KM}, {segs} segment{'s' * (segs > 1)}" + (
            f" (padded to {n_pad})" if padded else "")
        counters.zero()
        km_sh, s_first = timed(torch, lambda: kmeans_fit(bdist, K_KM, **kw))
        steps[label] = {k: v for k, v in counters.read().items() if v}
        km_lo = kmeans_fit(btbl, K_KM, **kw)
        s_sh = min(timed(torch, lambda: kmeans_fit(bdist, K_KM, **kw))[1]
                   for _ in range(SHARD_REPS))
        s_lo = min(timed(torch, lambda: kmeans_fit(btbl, K_KM, **kw))[1]
                   for _ in range(SHARD_REPS))
        want = {"kmeans_assign": 2 * segs * km_sh.n_iters}
        require(steps[label] == want,
                f"{label}: launches {steps[label]}, want {want}")
        require(km_sh.converged and km_sh.n_iters == km_lo.n_iters,
                f"{label}: rounds {km_sh.n_iters} (converged "
                f"{km_sh.converged}) vs local {km_lo.n_iters}")
        # the segments' f32 sums round apart from the local ones over the
        # rounds, and near-tie rows of a blob that two seeds share may go
        # the other way: few rows then assign apart under the two fits'
        # centroids, and the SSE agrees
        d_km = float((km_sh.centroids - km_lo.centroids).abs().max())
        ones = torch.ones((btbl.n_rows,), device=dev)
        flips = int((km_ops.assign_and_reduce(btbl["x"], km_sh.centroids,
                                              ones)[0]
                     != km_ops.assign_and_reduce(btbl["x"], km_lo.centroids,
                                                 ones)[0]).sum())
        d_sse = abs(km_sh.sse - km_lo.sse) / km_lo.sse
        within_e = torch.allclose(km_sh.centroids, km_lo.centroids,
                                  rtol=1e-4, atol=1e-3)
        require(flips <= KM_SHARD_ROWS_APART,
                f"{label}: {flips} rows assign apart (centroids differ from "
                f"local by {d_km})")
        require(d_sse <= 1e-5, f"{label}: SSE {km_sh.sse} vs local "
                f"{km_lo.sse}")
        seconds.append({"statement": "kmeans_fit", "segments": segs,
                        "sharded_s": s_sh, "local_s": s_lo,
                        "ratio": s_sh / s_lo, "sharded_first_s": s_first,
                        "rounds": km_sh.n_iters,
                        "centroid_max_diff": d_km, "rows_apart": flips,
                        "within_section_e_tolerance": within_e,
                        "one_round": one_round})
        print(f"[sharded] {label}: {s_sh:.4f} s sharded vs {s_lo:.4f} s "
              f"local ({s_sh / s_lo:.2f}x; best of {SHARD_REPS} repeats; the "
              f"counted fit {s_first:.4f} s), {km_sh.n_iters} rounds both, "
              f"centroids within {d_km:.3e} (section e's tolerance: "
              f"{'met' if within_e else 'not met'}), {flips} rows assign "
              f"apart, SSE within {d_sse:.2e} relative; launches "
              f"{steps[label]}; {smi}")
        del ones
        if segs == max(SHARD_SEGS):
            # the kernels on segment 1's views, which start 4 mod 16 bytes
            # in (xtx's y, countmin's items, kmeans_assign's weights)
            rows = n_pad // segs
            part = slice(rows, 2 * rows)
            xs, ys = tbl["x"][part], tbl["y"][part]
            items = tbl["item"][part]
            ms = torch.ones((n_pad,), dtype=torch.bool, device=dev)[part] \
                if mask is None else mask[part]
            w = torch.ones((n_pad,), device=dev)[part]
            bx = btbl["x"][part]
            require(ys.data_ptr() % 16 != 0 and items.data_ptr() % 16 != 0
                    and w.data_ptr() % 16 != 0,
                    "segment 1's views start on 16 bytes")
            got, want = xtx_ops.xtx_xty(xs, ys), xtx_xty_ref(xs, ys)
            errs["xtx"] = max(errs["xtx"], bitwise(
                torch, "xtx on segment 1's view", got[0], want[0]),
                bitwise(torch, "xty on segment 1's view", got[1], want[1]))
            errs["countmin"] = max(errs["countmin"], bitwise(
                torch, "countmin on segment 1's view",
                cm_ops.countmin_block(items, ms, 4, 1024),
                countmin_block_ref(items, ms, 4, 1024)))
            errs["kmeans_assign"] = max(errs["kmeans_assign"], km_gauss_check(
                torch, "kmeans_assign on segment 1's view", bx,
                km_lo.centroids, w, km_ops.assign_and_reduce(
                    bx, km_lo.centroids, w),
                assign_and_reduce_ref(bx, km_lo.centroids, w)))
            print(f"[sharded] xtx, countmin, kmeans_assign on segment 1's "
                  f"views ({rows} rows from row {rows}; y, item and the "
                  "weights 4 mod 16 bytes in): held against their plain "
                  "versions (xtx and countmin bitwise)")
            del xs, ys, items, ms, w, bx, got, want
        del tbl, mask, btbl, dist, bdist, km_sh, km_lo
        gc.collect()
        torch.cuda.empty_cache()
    out = {"seconds": seconds, "launches": steps,
           "section_s": time.perf_counter() - t_section, "device": smi}
    print(json.dumps({"sharded_section": out}))
    print(f"[sharded] section n took {out['section_s']:.1f} s; {smi}")
    return out


# ---------------------------------------------------------------------------
# o. the LM's distribution on a single-controller mesh of this card
# ---------------------------------------------------------------------------

# o1/o2: stablelm-1.6b over (data, model) = (2, 2), each data shard folding
# DIST_ACCUM micro-batches: 2 x 2 = section m's four micro-batches of
# (2, 4096)
DIST_MESH = (2, 2)
DIST_ACCUM = 2
DIST_STEPS = 3
# o1: both steps run the same kernels on the same four (2, 4096) pieces and
# differ only in the order of four f32 sums: the loss within DIST_LOSS_REL
# of the unsharded loss, every gradient element within DIST_GRAD_REL of its
# leaf's max |unsharded| (tests/test_torch_sharded_train.py's rule)
DIST_LOSS_REL = 1e-6
DIST_GRAD_REL = 1e-5
# o2: the int8 merge's mean within COMPRESS_SCALES scales of the f32 mean
# (the reference's rule, tests/test_multidevice.py)
COMPRESS_SCALES = 3.0
# o3: moonshot over (data, model) = (1, 4): 16 local experts a shard and
# 2,048 tokens a shard at (2, 4096); at depth A2A_CHECK_DEPTH in f32 with
# capacity_factor = E / k nothing drops, and the a2a logits are held within
# A2A_REL of max |gather| (the same f32 products summed in other orders:
# the expert matmuls in other batches, the combine in expert order)
MOE_EP = 4
A2A_CHECK_DEPTH = 2
A2A_REL = 1e-4
# o4: qwen3-8b's decode attention: B = 4, 32 query heads on 8 kv heads of
# 128, a 4,096-position bf16 cache split over model = 4, ragged positions;
# split-K against the unsharded softmax in f32 within SPLITK_TOL (the same
# f32 exponentials summed in other orders), then DECODE_STEPS decode steps
# of the full model under the mesh, bitwise the plain decode
SPLITK_B, SPLITK_CACHE = 4, 4096
SPLITK_POS = (17, 1500, 2900, 4095)
SPLITK_TOL = 1e-5
DECODE_STEPS = 16
# o5: stablelm's 24 blocks in PIPE_STAGES stages over pod = PIPE_STAGES,
# PIPE_MICRO micro-batches of (1, 4096)
PIPE_STAGES, PIPE_MICRO = 4, 8


def dist_section(torch, dev, counters, smi, driver) -> dict:
    """Section o, the LM's distribution on meshes whose positions all are
    this card: o1 the sharded train step (stablelm-1.6b, DIST_MESH, each
    data shard folding DIST_ACCUM micro-batches) against section m's
    unsharded grad_accum=4 step (loss and every gradient element, beside
    two planted merge faults; bitwise on a repeat; flash launches a step),
    its seconds, tokens/s and peak; o2 ``compressed_psum`` of the shards'
    gradients over the data axis; o5 GPipe over the same weights; o6
    section m's ``launch.train --full`` run (``driver``: its losses and
    the one-shard mesh it trained over) against the launcher with the
    plain step; o4 split-K decode attention at qwen3-8b's decode shape,
    the caches' shardings from ``decode_state_axes`` against split-K's
    key ranges, and 16 decode steps of qwen3-8b under the mesh; o3 the
    all-to-all MoE of moonshot-v1-16b-a3b against the gather MoE.  Every
    check is made before the first miss ends the section.  Returns the
    launches by main-path step."""
    import dataclasses
    import math
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core.compat import make_mesh
    from repro_torch.data import TokenStream, make_lm_batches
    from repro_torch.distributed import compression as C
    from repro_torch.distributed import decode as D
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.pipeline import bubble_fraction, \
        make_pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import jit_train_step

    t_section = time.perf_counter()
    fails: list[str] = []
    out: dict = {"launches": {}, "device": smi}

    def mesh_of(shape, names):
        return make_mesh(shape, names, devices=[dev] * math.prod(shape))

    def launches(step: str, got: dict) -> None:
        out["launches"][step] = {k: v for k, v in got.items() if v}

    # -- o1: the sharded train step ------------------------------------------
    cfg = get_config(TRAIN_ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(TRAIN_INIT_SEED)
    state = init_train_state(cfg, generator=g, device=dev)
    mesh = mesh_of(DIST_MESH, ("data", "model"))
    batches = make_lm_batches(TokenStream(
        vocab=cfg.vocab, seq_len=LM_SEQ, batch=TRAIN_BATCH, seed=SEED),
        device=dev)
    batch = next(batches)
    kw = dict(base_lr=TRAIN_LR, warmup=1, total_steps=TRAIN_STEPS)
    sharded = jit_train_step(
        make_train_step(cfg, grad_accum=DIST_ACCUM, **kw), state,
        M.param_axes(state.model), batch, mesh)
    plain = make_train_step(cfg, grad_accum=TRAIN_ACCUM, **kw)
    n_data = DIST_MESH[0]

    def rel_err(got, want):
        """max |got - want| / max |want|, over one leaf."""
        return float((got - want).abs().max()) / (
            float(want.abs().max()) or 1.0)

    # the unsharded grad_accum=4 step's loss and gradient: o1's reference,
    # and o2's for the planted dropped-shard fault
    l_p, _, g_p = plain.grads(state, batch)
    l_p = float(l_p)

    # o2 first, on the shards' gradient sums at the initial weights
    with S.activation_sharding(mesh):
        (per, s_shards) = timed(torch, lambda: sharded.shard_grads(
            state, batch))
    names = list(per[0][2])
    # planted fault: shard 1 dropped from the merge (shard 0's mean alone)
    drop_loss = abs(float(per[0][0]) / DIST_ACCUM - l_p) / abs(l_p)
    drop_grad = 0.0
    ug = torch.Generator(device=dev)
    ug.manual_seed(SEED + 26)
    worst, n_vals, s_merge = 0.0, 0, 0.0
    for name in names:
        means = [{"g": p[2][name].div_(DIST_ACCUM)} for p in per]
        drop_grad = max(drop_grad, rel_err(means[0]["g"], g_p[name]))
        errs_ = [C.init_error_feedback(m) for m in means]
        (merged, _), s = timed(torch, lambda: C.compressed_psum(
            means, errs_, ug))
        s_merge += s
        f32_mean = (means[0]["g"] + means[1]["g"]) / n_data
        scale = max(float(m["g"].abs().max()) for m in means) / 127.0
        dev_max = float((merged["g"] - f32_mean).abs().max())
        ratio = dev_max / scale if scale else 0.0
        worst = max(worst, ratio)
        n_vals += means[0]["g"].numel()
        if not dev_max < COMPRESS_SCALES * scale:
            fails.append(f"o2 compressed_psum {name}: |out - mean| "
                         f"{dev_max} against {COMPRESS_SCALES} x {scale}")
        del means, errs_, merged, f32_mean
    del per
    torch.cuda.empty_cache()
    out["o2"] = {"leaves": len(names), "values": n_vals,
                 "int8_bytes": n_vals * n_data,
                 "f32_bytes": 4 * n_vals * n_data, "scales": len(names),
                 "worst_dev_in_scales": worst, "seconds": s_merge,
                 "shard_grads_s": s_shards}
    print(f"[dist] o2 compressed_psum over data = {n_data} of the shards' "
          f"gradients ({len(names)} leaves, {n_vals} values a shard): int8 "
          f"merged {n_vals * n_data} bytes against f32 {4 * n_vals * n_data}"
          f" (+{len(names)} scales a shard); worst |out - f32 mean| "
          f"{worst:.3f} scales (limit {COMPRESS_SCALES}); {s_merge:.2f} s; "
          f"{smi}")

    # o1's checks: the sharded gradient against the unsharded grad_accum=4,
    # beside a planted scale fault (the merge divided by grad_accum, not
    # by n x grad_accum)
    l_s, _, g_s = sharded.grads(state, batch)
    rels = [rel_err(g_s[k], g_p[k]) for k in names]
    scale_grad = max(rel_err(g_s[k] * n_data, g_p[k]) for k in names)
    del g_p
    torch.cuda.empty_cache()
    l_s2, _, g_s2 = sharded.grads(state, batch)
    repeat = torch.equal(l_s, l_s2) and all(
        torch.equal(g_s[k], g_s2[k]) for k in g_s)
    l_s = float(l_s)
    del g_s, g_s2
    torch.cuda.empty_cache()
    loss_rel = abs(l_s - l_p) / abs(l_p)
    i_max = max(range(len(rels)), key=rels.__getitem__)
    print(f"[dist] o1 {TRAIN_ARCH} over (data, model) = {DIST_MESH}, "
          f"{DIST_ACCUM} micro-batches a data shard: loss {l_s!r} against "
          f"the unsharded grad_accum={TRAIN_ACCUM} step's {l_p!r} (relative "
          f"{loss_rel:.3e}, limit {DIST_LOSS_REL}); worst gradient leaf "
          f"max |diff| / max |unsharded| {rels[i_max]:.3e} ({names[i_max]}),"
          f" limit {DIST_GRAD_REL}; planted faults: shard 1 dropped, loss "
          f"{drop_loss:.3e} and gradient {drop_grad:.3e}; the merge scaled "
          f"by {n_data}, gradient {scale_grad:.3e}; bitwise on a repeat "
          f"{repeat}")
    if not (math.isfinite(l_s) and loss_rel <= DIST_LOSS_REL
            and rels[i_max] <= DIST_GRAD_REL and repeat):
        fails.append(f"o1 sharded step: loss {l_s} vs {l_p}, worst leaf "
                     f"{rels[i_max]} ({names[i_max]}), repeat {repeat}")
    want_bwd = cfg.n_layers * TRAIN_ACCUM
    want_fwd = want_bwd * (2 if cfg.remat else 1)
    recs = []
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    for i in range(DIST_STEPS):
        if i:
            batch = next(batches)
        before = counters.peek()
        (state, mets), sec = timed(torch, lambda: sharded(state, batch))
        got = {k: v - before[k] for k, v in counters.peek().items()}
        recs.append({"seconds": sec, "loss": float(mets["loss"]),
                     "flash_fwd": got["flash_attention"],
                     "flash_bwd": got["flash_attention_bwd"],
                     "flash_bwd_tc": got["flash_attention_bwd_tc"]})
        if (got["flash_attention"], got["flash_attention_bwd"],
                got["flash_attention_bwd_tc"]) != (want_fwd, want_bwd,
                                                   want_bwd):
            fails.append(f"o1 step {i}: flash launches {got}, want forward "
                         f"{want_fwd} and backward {want_bwd} on tc")
        if not math.isfinite(recs[-1]["loss"]):
            fails.append(f"o1 step {i}: loss {recs[-1]['loss']}")
    launches("o1 sharded train steps (data 2 x model 2)", counters.read())
    batches.close()
    peak = torch.cuda.max_memory_allocated() / 1e9
    later = recs[1:] or recs
    step_s = sum(r["seconds"] for r in later) / len(later)
    tokens = TRAIN_BATCH * LM_SEQ
    out["o1"] = {"mesh": list(DIST_MESH), "grad_accum": DIST_ACCUM,
                 "loss": l_s, "unsharded_loss": l_p, "loss_rel": loss_rel,
                 "max_leaf_rel": rels[i_max], "max_leaf": names[i_max],
                 "planted_drop_shard": {"loss_rel": drop_loss,
                                        "max_leaf_rel": drop_grad},
                 "planted_scale": {"max_leaf_rel": scale_grad},
                 "bitwise_repeat": repeat,
                 "steps": recs, "step_s": step_s,
                 "tokens_s": tokens / step_s, "peak_gb": peak}
    print(f"[dist] o1 {DIST_STEPS} sharded steps of {TRAIN_BATCH} x {LM_SEQ}"
          f" tokens: {step_s:.3f} s a step after the first "
          f"({tokens / step_s:.0f} tokens/s, host clock, synchronized), "
          f"losses {[round(r['loss'], 6) for r in recs]}, peak {peak:.2f} GB"
          f"; flash launches a step forward {recs[0]['flash_fwd']}, "
          f"backward {recs[0]['flash_bwd']} (section m's: {want_fwd}, "
          f"{want_bwd}); {smi}")

    # -- o5: GPipe over the trained weights -------------------------------------
    per_stage = cfg.n_layers // PIPE_STAGES
    model = state.model
    del state
    gc.collect()
    torch.cuda.empty_cache()

    class Stage(torch.nn.Module):
        def __init__(self, blocks):
            super().__init__()
            self.blocks = blocks

        def forward(self, x):
            pos = torch.arange(x.shape[1], device=x.device)[None].expand(
                x.shape[0], -1)
            for blk in self.blocks:
                x, _ = M._run_block(cfg, blk, x, pos)
            return x

    with torch.no_grad():
        stages = [Stage(model.blocks[s * per_stage:(s + 1) * per_stage])
                  for s in range(PIPE_STAGES)]
        pnames = [n for n, _ in stages[0].named_parameters()]
        stacked = {n: torch.stack([dict(st.named_parameters())[n]
                                   for st in stages]) for n in pnames}
        model.requires_grad_(False)
        gp = torch.Generator(device=dev)
        gp.manual_seed(SEED + 27)
        toks = torch.randint(0, cfg.vocab, (PIPE_MICRO, 1, LM_SEQ),
                             generator=gp, device=dev)
        x = model.embed[toks]

        def stage_fn(p, a):
            return torch.func.functional_call(stages[0], p, (a,))

        pipe = make_pipeline(mesh_of((PIPE_STAGES,), ("pod",)), stage_fn)
        counters.zero()
        got, s_pipe = timed(torch, lambda: pipe(stacked, x))
        launches("o5 GPipe 4 stages x 8 micro-batches", counters.read())

        def sequential():
            outs = []
            for mb in x:
                for s in range(PIPE_STAGES):
                    mb = stage_fn({n: v[s] for n, v in stacked.items()}, mb)
                outs.append(mb)
            return torch.stack(outs)

        want, s_seq = timed(torch, sequential)

        def own_blocks(mb):
            for st in stages:
                mb = st(mb)
            return mb

        own = torch.stack([own_blocks(mb) for mb in x])
    same = torch.equal(got, want)
    bubble = bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    out["o5"] = {"stages": PIPE_STAGES, "micro": PIPE_MICRO,
                 "bitwise": same, "model_blocks_bitwise": torch.equal(got, own),
                 "bubble_fraction": bubble, "seconds": s_pipe,
                 "sequential_s": s_seq}
    print(f"[dist] o5 GPipe, {cfg.n_layers} blocks in {PIPE_STAGES} stages "
          f"over pod = {PIPE_STAGES}, {PIPE_MICRO} micro-batches of (1, "
          f"{LM_SEQ}): final hidden states bitwise the sequential run "
          f"{same} (and the model's own blocks {torch.equal(got, own)}); "
          f"bubble_fraction({PIPE_STAGES}, {PIPE_MICRO}) = {bubble:.6f}; "
          f"{s_pipe:.3f} s against {s_seq:.3f} s sequential (host clock); "
          f"{smi}")
    if not (same and abs(bubble - 3 / 11) < 1e-12):
        fails.append(f"o5 GPipe: bitwise {same}, bubble {bubble}")
    del model, stages, stacked, x, got, want, own, toks
    gc.collect()
    torch.cuda.empty_cache()

    # -- o6: section m's launcher run against the launcher's plain step -----
    # (section m's run went through jit_train_step over the one-shard mesh
    # of this card, and its launches are section m's)
    argv = ["--arch", TRAIN_ARCH, "--full", "--steps", "4"]
    with mock.patch.object(launch_train, "jit_train_step",
                           lambda step, *a, **k: step):
        plain_losses, s_plain = timed(torch,
                                      lambda: launch_train.main(argv))
    gc.collect()
    torch.cuda.empty_cache()
    ok6 = (len(driver["meshes"]) == 1 and len(driver["meshes"][0]) == 1
           and driver["losses"] == plain_losses)
    out["o6"] = {"meshes": driver["meshes"], "losses": driver["losses"],
                 "plain_step_losses": plain_losses,
                 "seconds": driver["seconds"], "plain_seconds": s_plain}
    print(f"[dist] o6 launch.train --arch {TRAIN_ARCH} --full --steps 4 "
          f"through the mesh {driver['meshes']} (section m's run): losses "
          f"{driver['losses']}; with the plain step {plain_losses}; bitwise "
          f"{ok6}; {driver['seconds']:.2f} s against {s_plain:.2f} s; {smi}")
    if not ok6:
        fails.append(f"o6 launch.train: mesh {driver['meshes']}, losses "
                     f"{driver['losses']} vs the plain step's {plain_losses}")

    # -- o4: split-K decode attention, then decode under the mesh ------------
    qcfg = get_config(LM_ARCH)
    hq, hk, dh = qcfg.n_heads, qcfg.n_kv_heads, qcfg.d_head
    gk = torch.Generator(device=dev)
    gk.manual_seed(SEED + 28)
    q = torch.randn(SPLITK_B, 1, hq, dh, generator=gk, device=dev
                    ).to(torch.bfloat16)
    ck, cv = (torch.randn(SPLITK_B, SPLITK_CACHE, hk, dh, generator=gk,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(SPLITK_POS, device=dev)
    mesh4 = mesh_of((1, MOE_EP), ("data", "model"))
    attn = D.make_splitk_decode_attention(mesh4, batch_axes=("data",))

    def unsharded():
        qg = q.reshape(SPLITK_B, hk, hq // hk, dh).float()
        lg = torch.einsum("bhgd,bkhd->bhgk", qg, ck.float()) / dh ** 0.5
        valid = torch.arange(SPLITK_CACHE, device=dev)[None] <= pos[:, None]
        lg = torch.where(valid[:, None, None], lg,
                         torch.tensor(-1e30, device=dev))
        w = torch.softmax(lg, -1)
        return torch.einsum("bhgk,bkhd->bhgd", w, cv.float()).reshape(
            SPLITK_B, 1, hq, dh)

    # split-K computes in f32 and returns q's dtype: held in f32 (q cast
    # up front, as splitk_partial casts it), and the bf16 call its cast
    got32 = attn(q.float(), ck, cv, pos)
    ref = unsharded()
    err = float((got32 - ref).abs().max())
    same_cast = torch.equal(attn(q, ck, cv, pos), got32.to(torch.bfloat16))
    repeat_k = torch.equal(attn(q.float(), ck, cv, pos), got32)
    ms_split = cuda_ms(torch, lambda: attn(q, ck, cv, pos), 20)
    ms_plain = cuda_ms(torch, unsharded, 20)
    out["o4_splitk"] = {"shape": [SPLITK_B, hq, hk, SPLITK_CACHE, dh],
                        "shards": MOE_EP, "max_abs_err": err,
                        "bf16_out_is_cast": same_cast,
                        "bitwise_repeat": repeat_k, "ms": ms_split,
                        "unsharded_ms": ms_plain}
    print(f"[dist] o4 split-K decode attention, B {SPLITK_B}, {hq} heads on "
          f"{hk} kv heads of {dh}, a {SPLITK_CACHE}-position bf16 cache over "
          f"model = {MOE_EP}, pos {list(SPLITK_POS)}: f32 combine within "
          f"{err:.3e} of the unsharded softmax (limit {SPLITK_TOL}), the "
          f"bf16 output its cast {same_cast}, bitwise on a repeat "
          f"{repeat_k}; {ms_split:.4f} ms split-K "
          f"against {ms_plain:.4f} ms unsharded (CUDA events); {smi}")
    if not (err <= SPLITK_TOL and same_cast and repeat_k):
        fails.append(f"o4 split-K: error {err}, cast {same_cast}, repeat "
                     f"{repeat_k}")
    del q, ck, cv, got32, ref
    torch.cuda.empty_cache()

    gq = torch.Generator(device=dev)
    gq.manual_seed(SEED + 29)
    model = M.init_model(qcfg, generator=gq, device=dev)
    rules = dict(S.DEFAULT_RULES, kv_seq="model")
    tok0 = torch.randint(0, qcfg.vocab, (SPLITK_B, 1), generator=gq,
                         device=dev)
    runs, secs = [], []
    for under_mesh in (False, True):
        st = M.init_decode_state(qcfg, SPLITK_B, SPLITK_CACHE, device=dev)
        if under_mesh:
            # every cache splits its positions over model = MOE_EP as
            # split-K's shards take their keys: shard s the range
            # [s Sl, (s + 1) Sl)
            sh = S.param_sharding(M.decode_state_axes(qcfg), mesh4, st, rules)
            spec = sh[0]["k"].spec
            sl = SPLITK_CACHE // MOE_EP
            ranges = [slice(e * sl, (e + 1) * sl) for e in range(MOE_EP)]
            layout_ok = True
            for s_l, c_l in zip(sh, st):
                for key, leaf in c_l.items():
                    s_l[key].check(leaf.shape, leaf.device, f"o4 {key}")
                    got_r = [s_l[key].index((0, e), leaf.shape)[1]
                             for e in range(MOE_EP)]
                    layout_ok &= (s_l[key].spec == spec and got_r == ranges)
        tok, logits_all, toks_all = tok0, [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS):
            p = torch.tensor([i, i + 3, i + 7, i + 11], device=dev)
            if under_mesh:
                with S.activation_sharding(mesh4, rules):
                    lg, st = M.decode_step(model, st, tok, p)
            else:
                lg, st = M.decode_step(model, st, tok, p)
            tok = torch.argmax(lg, -1)[:, None]
            logits_all.append(lg)
            toks_all.append(tok)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        runs.append((torch.stack(logits_all), torch.cat(toks_all, 1)))
        del st
    same_dec = (torch.equal(runs[0][0], runs[1][0])
                and torch.equal(runs[0][1], runs[1][1]))
    out["o4_decode"] = {"steps": DECODE_STEPS, "bitwise": same_dec,
                        "cache_spec": [e for e in spec],
                        "cache_layout_is_splitk": layout_ok,
                        "seconds": secs}
    print(f"[dist] o4 {LM_ARCH} caches by decode_state_axes over model = "
          f"{MOE_EP}: every layer {spec}, positions split as split-K's "
          f"shards {layout_ok}; {DECODE_STEPS} decode steps at batch "
          f"{SPLITK_B} under activation_sharding: tokens and logits bitwise "
          f"the plain decode_step {same_dec}; {secs[1]:.3f} s against "
          f"{secs[0]:.3f} s (host clock); {smi}")
    if not (same_dec and layout_ok):
        fails.append(f"o4 decode: bitwise {same_dec}, cache layout "
                     f"{layout_ok}")
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()

    # -- o3: the all-to-all MoE -------------------------------------------------
    mcfg = get_config("moonshot-v1-16b-a3b")
    gm = torch.Generator(device=dev)
    gm.manual_seed(SEED + 30)
    toks = torch.randint(0, mcfg.vocab, (LM_BATCH, LM_SEQ), generator=gm,
                         device=dev)
    c32 = dataclasses.replace(mcfg, n_layers=A2A_CHECK_DEPTH,
                              dtype="float32",
                              capacity_factor=mcfg.n_experts / mcfg.top_k)
    model = M.init_model(c32, generator=gm, device=dev)
    lg_g, aux_g = M.forward(model, toks)
    model.cfg = dataclasses.replace(c32, moe_impl="a2a")
    with S.activation_sharding(mesh4):
        lg_a, aux_a = M.forward(model, toks)
    rel = float((lg_a - lg_g).abs().max()) / float(lg_g.abs().max())
    drops32 = (float(aux_g["drop_frac"]), float(aux_a["drop_frac"]))
    print(f"[dist] o3 moonshot-v1-16b-a3b at depth {A2A_CHECK_DEPTH} in f32, "
          f"capacity_factor = E / k: a2a logits within {rel:.3e} of max "
          f"|gather| (limit {A2A_REL}); drop_frac gather {drops32[0]}, a2a "
          f"{drops32[1]}")
    if not (rel <= A2A_REL and drops32 == (0.0, 0.0)):
        fails.append(f"o3 a2a f32: rel {rel}, drops {drops32}")
    del model, lg_g, lg_a
    gc.collect()
    torch.cuda.empty_cache()

    model = M.init_model(mcfg, generator=gm, device=dev)
    tokens = LM_BATCH * LM_SEQ
    M.forward(model, toks)                                    # warm
    (_, aux_g), s_g = timed(torch, lambda: M.forward(model, toks))
    model.cfg = dataclasses.replace(mcfg, moe_impl="a2a")
    counters.zero()
    with S.activation_sharding(mesh4):
        (lg1, aux1), s_a1 = timed(torch, lambda: M.forward(model, toks))
        (lg2, aux2), s_a2 = timed(torch, lambda: M.forward(model, toks))
    launches("o3 moonshot a2a forward x2 (model = 4)", counters.read())
    rep = torch.equal(lg1, lg2) and all(torch.equal(aux1[k], aux2[k])
                                        for k in aux1)
    d_g, d_a = float(aux_g["drop_frac"]), float(aux1["drop_frac"])
    out["o3"] = {"ep": MOE_EP, "f32_rel": rel, "f32_drop_frac": drops32,
                 "gather_ms": s_g * 1e3, "a2a_ms": s_a2 * 1e3,
                 "a2a_first_ms": s_a1 * 1e3, "gather_tokens_s": tokens / s_g,
                 "a2a_tokens_s": tokens / s_a2,
                 "drop_frac": {"gather": d_g, "a2a": d_a},
                 "a2a_bitwise_repeat": rep}
    print(f"[dist] o3 moonshot-v1-16b-a3b full depth bf16 (2, {LM_SEQ}), "
          f"capacity_factor {mcfg.capacity_factor}: forward a2a "
          f"{s_a2 * 1e3:.1f} ms ({tokens / s_a2:.0f} tokens/s) against gather"
          f" {s_g * 1e3:.1f} ms ({tokens / s_g:.0f} tokens/s), host clock; "
          f"drop_frac (summed over {mcfg.n_layers} layers) gather {d_g:.6f}, "
          f"a2a {d_a:.6f}; a2a bitwise on a repeat {rep}; {smi}")
    if not (rep and 0.0 <= d_a / mcfg.n_layers < 1.0
            and 0.0 <= d_g / mcfg.n_layers < 1.0):
        fails.append(f"o3 a2a bf16: repeat {rep}, drops {d_g}, {d_a}")
    del model, lg1, lg2
    gc.collect()
    torch.cuda.empty_cache()

    out["section_s"] = time.perf_counter() - t_section
    print(json.dumps({"dist_section": out}))
    print(f"[dist] section o took {out['section_s']:.1f} s; {smi}")
    require(not fails, "section o: " + "; ".join(fails))
    return out


# ---------------------------------------------------------------------------
# p. the dry run: the meta cells at 256 and 512 positions, then the dry
# run held against the card on section m's train step and section g's
# prefill
# ---------------------------------------------------------------------------

# p1 runs one cell per (family, kind) in-process, of the family's arch
# with the fewest layers; xlstm-350m's train and prefill cells dispatch its
# sLSTM time loop (about 22 ops a step, 4,096 or 32,768 steps a layer) op
# by op on meta, which takes minutes: ``python -m
# repro_torch.launch.dryrun --all`` traces them, and PERF.md has its times
DRY_ARCHS = ("stablelm-1.6b", "dbrx-132b", "hubert-xlarge",
             "recurrentgemma-2b", "qwen2-vl-2b", "xlstm-350m")
DRY_SLOW = {("xlstm-350m", "train_4k"), ("xlstm-350m", "prefill_32k")}
# the card against the dry run: the state and batch that the step's
# arguments hold within ARG_REL of the prediction; the step's temporary
# memory (max_memory_allocated less the arguments) within TEMP_REL of the
# meta trace's peak of live storage; the dot flops equal
ARG_REL, TEMP_REL = 0.01, 0.10


def dryrun_section(torch, dev, counters, smi) -> dict:
    """p1: the dry run of one cell per (family, kind) on both production
    meshes (fits, GB a device, dominant term, trace seconds).  p2: the
    dry run of stablelm-1.6b's train step (TRAIN_BATCH x LM_SEQ,
    TRAIN_ACCUM micro-batches, one-position mesh) against the same step
    on the card: argument bytes against ``memory_allocated`` of the real
    state and batch, the meta ``dot_flops`` against the op counter's
    count of one real step (the flash kernels recording their cost),
    temp bytes against ``max_memory_allocated`` less the arguments; MFU
    from a step timed without the counter.  p3: the same for qwen3-8b's
    prefill at (LM_BATCH, LM_SEQ).  Returns the launches by main-path
    step (p2's step and p3's forward under the counter)."""
    from repro_torch.configs import SHAPES, cells, get_config
    from repro_torch.core.compat import make_mesh
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.launch.op_analysis import OpCounter, analyze
    from repro_torch.launch.scan_registry import (clear_registry,
                                                  get_registry)
    from repro_torch.models import model as M
    from repro_torch.train import init_train_state, make_train_step

    out: dict = {"launches": {}, "device": smi, "p1": [], "skipped": []}
    fails: list[str] = []

    # -- p1 ------------------------------------------------------------------
    t_p1 = time.perf_counter()
    picked = {}
    for arch, shape, _, _ in cells():
        key = (get_config(arch).family, SHAPES[shape]["kind"])
        if arch not in DRY_ARCHS:
            continue
        if (arch, shape) in DRY_SLOW:
            out["skipped"].append(f"{arch} {shape}")
        elif key not in picked:
            picked[key] = (arch, shape)
    for arch, shape in picked.values():
        cell = D.abstract_cell(arch, shape)
        counts, secs = D.trace(cell, D.make_production_mesh())
        for mp in (False, True):
            res = D.cell_result(arch, shape, cell, counts, secs, mp)
            print(f"[dryrun] p1 {D.summary(res)}")
            out["p1"].append({k: res[k] for k in (
                "arch", "shape", "mesh", "fits", "trace_s")} | {
                "gb": (res["memory"]["argument_bytes"]
                       + res["memory"]["temp_bytes"]) / 1e9,
                "dominant": res["roofline"]["dominant"]})
        del cell
    out["p1_s"] = time.perf_counter() - t_p1
    print(f"[dryrun] p1: {len(picked)} cells on both meshes in "
          f"{out['p1_s']:.1f} s; traced by --all instead: "
          f"{', '.join(out['skipped'])}")

    # -- p2 and p3 ----------------------------------------------------------
    meta_mesh = D.one_position_mesh()
    card_mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])

    def against_card(tag, cell, build, run, mflops):
        """The dry run of ``cell`` against ``build()`` (the arguments on the
        card) and ``run(args)`` (one step), as the docstring says."""
        pred_arg = int(D.position_bytes(cell.inputs(meta_mesh),
                                        meta_mesh).max())
        counts, trace_s = D.trace(cell, meta_mesh)
        pred_temp = counts["peak_bytes"] / cell.batch_positions(meta_mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = build()
        torch.cuda.synchronize()
        arg = torch.cuda.memory_allocated() - base
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        clear_registry()
        counters.zero()
        with OpCounter() as c, activation_sharding(card_mesh):
            run(args)
        torch.cuda.synchronize()
        got = counters.read()
        temp = torch.cuda.max_memory_allocated() - held
        card = analyze(c, get_registry())
        (_, secs1), (_, secs2) = (timed(torch, lambda: run(args))
                                  for _ in range(2))
        secs = min(secs1, secs2)
        mfu = mflops / secs / PEAK_FLOPS_BF16
        row = {"arg_pred": pred_arg, "arg_card": arg,
               "arg_rel": abs(arg - pred_arg) / pred_arg,
               "dot_flops_meta": counts["dot_flops"],
               "dot_flops_card": card["dot_flops"],
               "temp_pred": pred_temp, "temp_card": temp,
               "temp_rel": abs(temp - pred_temp) / pred_temp,
               "kernels_meta": counts["kernels"],
               "kernels_card": card["kernels"],
               "registry": card["registry"], "trace_s": trace_s,
               "step_s": secs, "step_s_both": [secs1, secs2],
               "model_flops": mflops, "mfu": mfu, "device": smi}
        out["launches"][f"p {tag}"] = {k: v for k, v in got.items() if v}
        if row["arg_rel"] > ARG_REL:
            fails.append(f"{tag}: argument bytes {arg} on the card, "
                         f"{pred_arg} predicted")
        if card["dot_flops"] != counts["dot_flops"]:
            fails.append(f"{tag}: dot flops {card['dot_flops']} on the "
                         f"card, {counts['dot_flops']} on meta")
        if row["temp_rel"] > TEMP_REL:
            fails.append(f"{tag}: temp bytes {temp} on the card, "
                         f"{pred_temp} predicted")
        if card["kernels"] != counts["kernels"]:
            fails.append(f"{tag}: kernel costs {card['kernels']} on the "
                         f"card, {counts['kernels']} on meta")
        print(f"[dryrun] {tag}: argument bytes {arg} on the card, "
              f"{pred_arg} predicted ({row['arg_rel']:.2e}, limit "
              f"{ARG_REL}); dot flops {card['dot_flops']:.6e} on the card, "
              f"{counts['dot_flops']:.6e} on meta; temp bytes {temp} on the "
              f"card, {pred_temp:.0f} predicted ({row['temp_rel']:.3f}, "
              f"limit {TEMP_REL}); meta trace {trace_s:.2f} s; step "
              f"{secs:.4f} s; MFU {mfu:.4f} ({mflops:.4e} model flops over "
              f"989e12); launches {out['launches'][f'p {tag}']}; {smi}")
        return row

    cfg = get_config(TRAIN_ARCH)
    step = make_train_step(cfg, grad_accum=TRAIN_ACCUM, base_lr=TRAIN_LR,
                           warmup=1, total_steps=TRAIN_STEPS)

    def build_train():
        g = torch.Generator(device=dev)
        g.manual_seed(TRAIN_INIT_SEED)
        return (init_train_state(cfg, generator=g, device=dev),
                synthetic_batch(cfg, TRAIN_BATCH, LM_SEQ, generator=g))

    out["p2"] = against_card(
        f"p2 {TRAIN_ARCH} train ({TRAIN_BATCH}, {LM_SEQ}) x {TRAIN_ACCUM}",
        D.abstract_cell(TRAIN_ARCH, "train_4k", cfg=cfg, batch=TRAIN_BATCH,
                        seq=LM_SEQ, grad_accum=TRAIN_ACCUM),
        build_train, lambda a: step(*a),
        D.model_flops(cfg, "train_4k", batch=TRAIN_BATCH, seq=LM_SEQ))
    gc.collect()
    torch.cuda.empty_cache()

    pcfg = get_config(LM_ARCH)

    def build_prefill():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 27)
        model = M.init_model(pcfg, generator=g, device=dev)
        return model, torch.randint(0, pcfg.vocab, (LM_BATCH, LM_SEQ),
                                    generator=g, dtype=torch.int32,
                                    device=dev)

    out["p3"] = against_card(
        f"p3 {LM_ARCH} prefill ({LM_BATCH}, {LM_SEQ})",
        D.abstract_cell(LM_ARCH, "prefill_32k", cfg=pcfg, batch=LM_BATCH,
                        seq=LM_SEQ),
        build_prefill, lambda a: M.forward(a[0], a[1]),
        D.model_flops(pcfg, "prefill_32k", batch=LM_BATCH, seq=LM_SEQ))
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"dryrun": out}))
    require(not fails, "; ".join(fails))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Session, run_grouped, run_many, \
        trace_execution
    from repro_torch.core.plan import ScanAgg, execute
    from repro_torch.core.aggregates import (
        probe_segment_ops, run_local, segment_block_size, segment_fold)
    from repro_torch.core.iterative import fit_grouped
    from repro_torch.core.table import Table, synthetic_regression_table
    from repro_torch.kernels import _build
    from repro_torch.kernels.column_stats import ops as cs_ops
    from repro_torch.kernels.column_stats.ref import column_stats_ref
    from repro_torch.kernels.countmin import ops as cm_ops
    from repro_torch.kernels.countmin.ref import countmin_block_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.kmeans_assign.ref import assign_and_reduce_ref
    from repro_torch.kernels.segment_fold import ops as sf_ops
    from repro_torch.kernels.segment_fold.ref import (
        segment_countmin_ref, segment_fm_ref, segment_linregr_ref)
    from repro_torch.kernels.sketch_hash import _hash_rows
    from repro_torch.kernels.xtx import ops as xtx_ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref
    from repro_torch.interop import state_to_numpy
    from repro_torch.methods.kmeans import (
        KMeansAggregate, KMeansTask, kmeans_fit, kmeans_grouped,
        kmeans_pp_seed)
    from repro_torch.methods.linregr import (
        LinregrAggregate, linregr, linregr_grouped)
    from repro_torch.methods.logregr import (
        IRLSAggregate, logregr, logregr_grouped)
    from repro_torch.methods.profile import profile
    from repro_torch.methods.sketches import (
        CountMinAggregate, FMAggregate, countmin_query,
        countmin_sketch_grouped, fm_distinct_count,
        fm_distinct_count_grouped)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    counters = Counters({"xtx": xtx_ops, "xtx_narrow": xtx_ops,
                         "segment_linregr": sf_ops,
                         "countmin": cm_ops, "segment_countmin": sf_ops,
                         "segment_fm": sf_ops, "kmeans_assign": km_ops,
                         "column_stats": cs_ops,
                         "flash_attention": fa_ops,
                         "flash_attention_tc": fa_ops,
                         "flash_attention_ffma": fa_ops,
                         "flash_attention_bwd": fa_ops,
                         "flash_attention_bwd_tc": fa_ops,
                         "flash_attention_bwd_ffma": fa_ops})

    # 1. device -------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    clock_hz = clock_mhz * 1e6
    print(f"[device] {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"[device] {sms} SMs, max SM clock {clock_mhz:.0f} MHz: integer "
          "peaks " + ", ".join(
              f"{pipe} {lanes * sms * clock_hz:.4e}/s ({lanes} lanes/SM/clock)"
              for pipe, lanes in PIPE_LANES_PER_SM.items())
          + f", issue {ISSUE_LANES_PER_SM * sms * clock_hz:.4e}/s")
    print(smi)

    # 2. build --------------------------------------------------------------
    _build.build(force=True)
    print(f"[build] {_build.last_build['seconds']:.1f} s -> {_build.LIB_PATH}")
    for line in _build.last_build["ptxas"]:
        print(f"[build] {line}")
    for key in ("flash_attention_tc", "flash_attention_kernel", "xtx_",
                "kmeans_assign", "segment_partial", "segment_reduce",
                "flash_bwd_dkdv_tc", "flash_bwd_dq_tc", "column_stats"):
        lines = ptxas_for(_build.last_build["ptxas"], key)
        require(bool(lines), f"build: no ptxas lines for {key}")
        for line in lines:
            print(f"[build] {key}: {line}")
    _build.lib()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for src in ("countmin", "segment_sketch"):
        for fn, mix in sass_mix(cuobjdump,
                                _build.BUILD_DIR / f"{src}.o").items():
            print(f"[build] SASS {fn}: " + ", ".join(
                f"{op} {n}" for op, n in mix.items() if n))

    # 3. kernels against their plain versions -------------------------------
    errs: dict[str, float] = {}
    # xtx past one 176-column tile (several units, halves of tile pairs),
    # from a generator of its own so that the main path's draws stay
    gen_k = torch.Generator(device=dev)
    gen_k.manual_seed(SEED + 15)
    x, y = dyadic(torch, gen_k, (200_000, 300), dev), dyadic(
        torch, gen_k, (200_000,), dev)
    got = xtx_ops.xtx_xty(x, y)
    want = xtx_xty_ref(x, y)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[0], got[0].T),
            "xtx (200000, 300) dyadic: not bitwise equal and symmetric")
    print("[kernels] xtx (200000, 300): dyadic bitwise, X^T X bitwise "
          "symmetric")
    del x, y, got, want
    for n, k in ((4096, 7), (1_000_000, 80), (N_MAIN, K_MAIN)):
        x = dyadic(torch, gen, (n, k), dev)
        y = dyadic(torch, gen, (n,), dev)
        got = dict(zip(("xtx", "xty"), xtx_ops.xtx_xty(x, y)))
        want = dict(zip(("xtx", "xty"), xtx_xty_ref(x, y)))
        torch.cuda.synchronize()
        require(all(torch.equal(got[q], want[q]) for q in want),
                f"xtx ({n}, {k}) dyadic: not bitwise equal "
                f"(max err {max_err(torch, got, want)[0]})")
        require(torch.equal(got["xtx"], got["xtx"].T),
                f"xtx ({n}, {k}): not bitwise symmetric")
        x = torch.randn((n, k), generator=gen, device=dev)
        y = torch.randn((n,), generator=gen, device=dev)
        got = dict(zip(("xtx", "xty"), xtx_ops.xtx_xty(x, y)))
        plain = dict(zip(("xtx", "xty"), xtx_xty_ref(x, y)))
        x64 = x.double()
        exact = {"xtx": x64.T @ x64, "xty": x64.T @ y.double()}
        del x64
        errs["xtx"] = gauss_check(torch, f"xtx ({n}, {k})", got, plain,
                                  exact)
        print(f"[kernels] xtx ({n}, {k}): dyadic bitwise, X^T X bitwise "
              "symmetric")
        del x, y, got, plain, exact

    def segment_layout(cols, num_groups, used, sentinels, base=None,
                       block=4096, gen=gen):
        """A real aligned_blocks layout: ids 0..used-1 only (the rest are
        empty groups), padded by pad_blocks_to with ``sentinels`` blocks."""
        n = next(iter(cols.values())).shape[0]
        g = torch.randint(0, used, (n,), generator=gen, dtype=torch.int32,
                          device=dev)
        view = Table({**cols, "g": g}).group_by("g", num_groups)
        real = int((-(-view.counts.long() // block)).sum())
        pbase = None if base is None else view.permute(base)
        out, valid, bgids = view.aligned_blocks(
            block, pbase, pad_blocks_to=real + sentinels)
        require(int((bgids == num_groups).sum()) == sentinels,
                "sentinel blocks")
        return out, valid, bgids

    # segment_linregr at the edges of its plan: A's width k + 2 below, at
    # and past one 176-column tile (tile pairs and halves), blocks of one
    # row split (64, 4096) and of two (9000 > 8192 rows), a ragged base
    # mask, 8 empty groups and 5 sentinel blocks; dyadic, so bitwise.  A
    # generator of their own, so that the main path's draws stay.
    gen_e = torch.Generator(device=dev)
    gen_e.manual_seed(SEED + 16)
    for k, block in ((1, 64), (7, 9000), (160, 64), (174, 4096),
                     (175, 9000), (300, 4096), (300, 9000)):
        n = 200_000
        cols, valid, bgids = segment_layout(
            {"x": dyadic(torch, gen_e, (n, k), dev),
             "y": dyadic(torch, gen_e, (n,), dev)}, G_MAIN, G_MAIN - 8, 5,
            base=torch.rand((n,), generator=gen_e, device=dev) < 0.8,
            block=block, gen=gen_e)
        args = (cols["x"], cols["y"], valid, bgids)
        got = sf_ops.segment_linregr(*args, num_groups=G_MAIN)
        want = segment_linregr_ref(*args, num_groups=G_MAIN)
        torch.cuda.synchronize()
        require(all(torch.equal(got[q], want[q]) for q in want),
                f"segment_linregr (k {k}, block {block}) dyadic: not bitwise "
                f"equal (max err {max_err(torch, got, want)[0]})")
        require(torch.equal(got["xtx"], got["xtx"].transpose(1, 2)),
                f"segment_linregr (k {k}, block {block}): x^T x not "
                "bitwise symmetric")
        require(all(float(got[q][G_MAIN - 8:].abs().max()) == 0.0
                    for q in got), "segment_linregr: empty groups not zero")
        print(f"[kernels] segment_linregr ({n}, {k}), block {block}, "
              f"{bgids.shape[0]} blocks, G={G_MAIN} with 8 empty groups and "
              "5 sentinel blocks, ragged mask: dyadic bitwise, x^T x "
              "bitwise symmetric")
        del cols, valid, bgids, args, got, want

    for label, make in (("dyadic", dyadic),
                        ("gaussian", lambda t, g_, s, d: torch.randn(
                            s, generator=g_, device=d))):
        cols, valid, bgids = segment_layout(
            {"x": make(torch, gen, (N_MAIN, K_MAIN), dev),
             "y": make(torch, gen, (N_MAIN,), dev)}, G_MAIN, G_MAIN - 8, 5)
        xs, ys = cols["x"], cols["y"]
        del cols
        got = sf_ops.segment_linregr(xs, ys, valid, bgids,
                                     num_groups=G_MAIN)
        want = segment_linregr_ref(xs, ys, valid, bgids, num_groups=G_MAIN)
        torch.cuda.synchronize()
        require(all(float(got[q][G_MAIN - 8:].abs().max()) == 0.0
                    for q in got), "segment_linregr: empty groups not zero")
        if label == "dyadic":
            require(all(torch.equal(got[q], want[q]) for q in want)
                    and torch.equal(got["xtx"], got["xtx"].transpose(1, 2)),
                    "segment_linregr dyadic: not bitwise equal and "
                    f"symmetric (max err {max_err(torch, got, want)[0]})")
            print(f"[kernels] segment_linregr ({N_MAIN}, {K_MAIN}), "
                  f"{bgids.shape[0]} blocks, G={G_MAIN} with 8 empty groups "
                  "and sentinel blocks: dyadic bitwise")
        else:
            exact = segment_linregr_ref(xs.double(), ys.double(), valid,
                                        bgids, num_groups=G_MAIN)
            errs["segment_linregr"] = gauss_check(
                torch, f"segment_linregr ({N_MAIN}, {K_MAIN})", got, want,
                exact)
            del exact
        del xs, ys, valid, bgids, got, want
    torch.cuda.empty_cache()

    # the sketch kernels: integer counts, so bitwise on any items.  The
    # items are the main path's Zipf keys with a tenth replaced by
    # full-range int32 draws and a fifth negated; the mask is ragged.
    zipf = zipf_items(torch, gen, N_MAIN, dev)

    def sketch_items(n, g_=gen):
        keys = zipf[:n].clone()
        wide = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g_,
                             dtype=torch.int32, device=dev)
        u = torch.rand((n,), generator=g_, device=dev)
        keys = torch.where(u < 0.1, wide, keys)
        keys = torch.where((u >= 0.1) & (u < 0.3), -keys, keys)
        mask = torch.rand((n,), generator=g_, device=dev) < 0.9
        return keys, mask

    errs.update(countmin=0.0, segment_countmin=0.0, segment_fm=0.0)

    def countmin_check(what, items, mask, depth, width):
        got = cm_ops.countmin_block(items, mask, depth, width)
        want = countmin_block_ref(items, mask, depth, width)
        errs["countmin"] = max(errs["countmin"], bitwise(
            torch, f"countmin {what} ({items.shape[0]}, {depth}, {width})",
            got, want))
        require(int(got.sum()) == depth * int(mask.sum()),
                "countmin: counts do not add up to depth x valid rows")
        print(f"[kernels] countmin {what} ({items.shape[0]}, depth {depth}, "
              f"width {width}): bitwise")

    # widths of a power of two take the AND path, 1000 the division path;
    # 8 x 8192 (256 KB of counters) is past the opt-in shared memory; n
    # around the kernel's 4-row chunks.  The shapes added beside the first
    # four draw from a generator of their own, so that the main path's
    # draws stay.
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(SEED + 17)
    for n, depth, width, g_ in (
            (1, 4, 1024, gen_s), (3, 4, 1024, gen_s), (4095, 4, 1024, gen_s),
            (4096, 4, 1024, gen), (4097, 4, 1024, gen_s),
            (1_000_000, 8, 4096, gen), (1_000_000, 3, 1000, gen),
            (1_000_000, 8, 8192, gen_s), (N_MAIN, 4, 1024, gen)):
        items, mask = sketch_items(n, g_)
        require(n < 1000 or bool((items < 0).any()),
                "negative items present")
        countmin_check("negative items, ragged mask", items, mask, depth,
                       width)
    # contiguous views 4 and 12 bytes into the items, the mask at the same
    # offset (4-byte mask loads) or another (byte loads); every row the
    # same item (each warp's atomics on one counter)
    items, mask = sketch_items(N_MAIN, gen_s)
    for i0, m0 in ((1, 1), (3, 3), (1, 0)):
        countmin_check(f"items[{i0}:], mask[{m0}:]",
                       items[i0:i0 + N_MAIN - 3], mask[m0:m0 + N_MAIN - 3],
                       4, 1024)
    hot = torch.full((N_MAIN,), -123457, dtype=torch.int32, device=dev)
    for depth, width in ((4, 1024), (8, 8192)):
        countmin_check("one hot key", hot, mask, depth, width)
    del hot
    items, mask = sketch_items(N_MAIN)
    cols, valid, bgids = segment_layout({"item": items}, G_MAIN, G_MAIN - 8,
                                        5, base=mask)
    seg_items = cols["item"]
    del cols, items, mask
    nb, bs = bgids.shape[0], seg_items.shape[0] // bgids.shape[0]
    per = sf_ops.cta_blocks(nb, sms)
    edges = torch.arange(per, nb, per, device=dev)
    straddle = int((bgids[edges] == bgids[edges - 1]).sum())
    require(straddle > 0, "segment_countmin: no run straddles two CTAs")
    print(f"[kernels] segment_countmin layout: {straddle} runs of one group "
          f"straddle two of the {-(-nb // per)} CTAs' ranges")
    # the same blocks shuffled: a group's blocks are no longer adjacent
    perm = torch.randperm(nb, generator=gen_s, device=dev)
    layouts = {"aligned": (seg_items, valid, bgids),
               "shuffled blocks": (seg_items.view(nb, bs)[perm].reshape(-1),
                                   valid.view(nb, bs)[perm].reshape(-1),
                                   bgids[perm].contiguous())}
    checks = [("segment_countmin", sf_ops.segment_countmin,
               segment_countmin_ref, {"depth": depth, "width": width})
              for depth, width in ((4, 1024), (3, 1000), (8, 8192))]
    checks += [("segment_fm", sf_ops.segment_fm, segment_fm_ref,
                {"num_hashes": 8, "bits": bits}) for bits in (16, 32)]
    for name, kern, plain, kw in checks:
        for order, (li, lv, lb) in layouts.items():
            if name == "segment_fm" and order != "aligned":
                continue
            got = kern(li, lv, lb, num_groups=G_MAIN, **kw)
            want = plain(li, lv, lb, num_groups=G_MAIN, **kw)
            errs[name] = max(errs[name], bitwise(
                torch, f"{name} {kw} {order}", got, want))
            require(int(got[G_MAIN - 8:].abs().sum()) == 0,
                    f"{name}: empty groups not zero")
            require(int(got[:G_MAIN - 8].sum()) > 0,
                    f"{name}: nothing counted")
            print(f"[kernels] {name} {kw}: {li.shape[0]} rows, {nb} blocks "
                  f"({order}), G={G_MAIN} with 8 empty groups and 5 "
                  "sentinel blocks: bitwise")
    del seg_items, valid, bgids, got, want, layouts, perm, edges
    torch.cuda.empty_cache()

    # kmeans_assign: dyadic draws bitwise at every shape (rows and
    # centroids multiples of 1/8 around N(0, 1) and N(0, 4); at 10M rows
    # values in {-1/8, 0, 1/8}, so that every coordinate sum stays exact
    # in f32, and most rows tie: argmin's lowest-index rule decides
    # them); Gaussian draws held by km_gauss_check.  Masks at p = 0.9.
    errs["kmeans_assign"] = 0.0

    def dyadic_normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                * 8).round() / 8

    # each size class of the register tile (1, 2 or 4 lanes a row, passes
    # of 32 centroids) at, below and past its edge, against rows of 1
    # column (4-byte copies), 17, 32 (16-byte copies) and 33 (two staged
    # chunks); two equal centroids at the origin: the lower index must win
    # every tie
    for k in (1, 8, 9, 16, 17, 32, 33, 64):
        for d in (1, 17, 32, 33):
            n = 20_000
            m = (torch.rand((n,), generator=gen_e, device=dev) < 0.9).float()
            x = (torch.randn((n, d), generator=gen_e, device=dev)
                 * 8).round() / 8
            c = (torch.randn((k, d), generator=gen_e, device=dev)
                 * 16).round() / 8
            if k > 1:
                c[0] = 0.0
                c[1] = 0.0
            got = km_ops.assign_and_reduce(x, c, m)
            want = assign_and_reduce_ref(x, c, m)
            bitwise(torch, f"kmeans_assign ({n}, {d}, {k}) assign",
                    got[0].long(), want[0])
            for q, a, b in zip(("mind", "sums", "counts"), got[1:], want[1:]):
                bitwise(torch, f"kmeans_assign ({n}, {d}, {k}) {q}", a, b)
            require(k == 1 or not bool((got[0] == 1).any()),
                    f"kmeans_assign ({n}, {d}, {k}): a tie went to the "
                    "higher index")
    print("[kernels] kmeans_assign (20000, d in {1, 17, 32, 33}, k in {1, 8, "
          "9, 16, 17, 32, 33, 64}) dyadic, ties at the origin: bitwise")

    for n, d, k, case in ((256, 2, 4, ""), (777, 17, 9, ""),
                          (1024, 64, 32, ""), (100, 3, 5, ""),
                          (5000, 8, 6, "duplicate centroids"),
                          (3000, 5, 1, "K = 1"),
                          (1_000_000, 256, 1024, "envelope edge"),
                          (N_MAIN, D_KM, K_KM, "main path")):
        m = (torch.rand((n,), generator=gen, device=dev) < 0.9).float()
        if n > 2_000_000:
            x, c = dyadic(torch, gen, (n, d), dev), 2 * dyadic(
                torch, gen, (k, d), dev)
        else:
            x, c = dyadic_normal((n, d), 1.0), dyadic_normal((k, d), 2.0)
        if case == "duplicate centroids":  # at the origin: many rows tie
            c[0] = 0.0
            c[1] = c[0]
        got = km_ops.assign_and_reduce(x, c, m)
        want = assign_and_reduce_ref(x, c, m)
        torch.cuda.synchronize()
        require(got[0].dtype == torch.int32, "kmeans_assign: assign dtype")
        errs["kmeans_assign"] = max(
            [errs["kmeans_assign"],
             bitwise(torch, f"kmeans_assign ({n}, {d}, {k}) assign",
                     got[0].long(), want[0])]
            + [bitwise(torch, f"kmeans_assign ({n}, {d}, {k}) {q}", a, b)
               for q, a, b in zip(("mind", "sums", "counts"), got[1:],
                                  want[1:])])
        if case == "duplicate centroids":
            require(not bool((got[0] == 1).any())
                    and bool((got[0] == 0).any()),
                    "kmeans_assign: a tie went to the higher index")
        print(f"[kernels] kmeans_assign ({n}, {d}, {k}) {case} dyadic: "
              "bitwise")
        if case in ("", "main path"):
            x = torch.randn((n, d), generator=gen, device=dev)
            c = 2.0 * torch.randn((k, d), generator=gen, device=dev)
            got = km_ops.assign_and_reduce(x, c, m)
            want = assign_and_reduce_ref(x, c, m)
            errs["kmeans_assign"] = max(errs["kmeans_assign"], km_gauss_check(
                torch, f"kmeans_assign ({n}, {d}, {k})", x, c, m, got, want))
        del x, c, m, got, want
    torch.cuda.empty_cache()

    # 4. main path ----------------------------------------------------------
    t, b_true = synthetic_regression_table(SEED, N_MAIN, K_MAIN)
    t = t.with_column("g", torch.randint(0, G_MAIN, (N_MAIN,), generator=gen,
                                         dtype=torch.int32, device=dev))
    t = t.with_column("item", zipf)
    del zipf
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    results = {}

    # a. OLS, solo and grouped
    for name, stmt in (
            ("linregr", lambda: linregr(t, use_kernel=True)),
            ("linregr_grouped",
             lambda: linregr_grouped(t, "g", num_groups=G_MAIN,
                                     use_kernel=True))):
        # twice: the first run pays the partitioning sort and the host
        # index build of the layout (memoized after), the second does not
        counters.zero()
        with trace_execution() as tr:
            seconds[name] = []
            for _ in range(2):
                results[name], s = timed(torch, stmt)
                seconds[name].append(s)
        launched = counters.read()
        kern = "xtx" if name == "linregr" else "segment_linregr"
        engines = [e.engine for e in tr.kernels]
        require(launched[kern] > 0, f"{name}: {kern}_launches did not rise")
        require(engines and all(e == "cuda" for e in engines),
                f"{name}: trace kernel events {engines}")
        print(f"[main] {name}: first {seconds[name][0]:.3f} s, again "
              f"{seconds[name][1]:.3f} s (host clock, synchronized); "
              f"launches {launched}, trace kernel events {engines}, "
              f"sorts {len(tr.sorts)}")

    solo, grouped = results["linregr"], results["linregr_grouped"]
    require(tuple(solo.coef.shape) == (K_MAIN,)
            and tuple(grouped.coef.shape) == (G_MAIN, K_MAIN),
            "result shapes")
    require(bool(torch.isfinite(solo.coef).all())
            and bool(torch.isfinite(grouped.coef).all()), "finite coef")
    coef_err = float((solo.coef - b_true).abs().max())
    require(coef_err < 1e-2, f"solo coef off the true b by {coef_err}")
    ref_solo = linregr(t, use_kernel="ref")
    ref_grouped = linregr_grouped(t, "g", num_groups=G_MAIN,
                                  use_kernel="ref")
    for name, got, want in (("linregr", solo, ref_solo),
                            ("linregr_grouped", grouped, ref_grouped)):
        d = float((got.coef - want.coef).abs().max())
        require(torch.allclose(got.coef, want.coef, rtol=1e-4, atol=1e-4),
                f"{name}: coef vs use_kernel='ref' differ by {d}")
        print(f"[main] {name}: coef vs use_kernel='ref' max diff {d:.3e}; "
              f"coef vs true b max diff "
              f"{float((got.coef - b_true).abs().max()):.3e}")
    del ref_solo, ref_grouped

    # b. the analytics mix as one Session batch: one shared scan
    def mix(tb, cm_kernel=True):
        sess = Session()
        handles = {
            "profile": sess.profile(tb, distinct_counts=True),
            "linregr": sess.linregr(tb, use_kernel=True),
            "countmin": sess.scan(CountMinAggregate(use_kernel=cm_kernel),
                                  tb, columns=("item",), label="countmin"),
            "fm_distinct": sess.fm_distinct_count(tb)}
        sess.run()
        return {k: h.result() for k, h in handles.items()}

    seconds["session batch"] = []
    for _ in range(2):
        counters.zero()
        with trace_execution() as tr:
            batch, s = timed(torch, lambda: mix(t))
        launched = counters.read()
        seconds["session batch"].append(s)
        events = sorted((e.detail["name"], e.engine) for e in tr.kernels)
        require(len(tr.scans) == 1,
                f"session batch: {len(tr.scans)} scans, want 1")
        # profile's transition: one column_stats a numeric column (x, y,
        # g, item)
        require(events == [("column_stats", "cuda")] * 4
                + [("countmin", "cuda"), ("xtx", "cuda")],
                f"session batch: trace kernel events {events}")
        require(launched["xtx"] > 0 and launched["countmin"] > 0
                and launched["column_stats"] == 4,
                f"session batch: launches {launched}")
    print(f"[main] session batch (profile with distinct counts, linregr, "
          f"countmin, fm_distinct): first {seconds['session batch'][0]:.3f} "
          f"s, again {seconds['session batch'][1]:.3f} s (host clock, "
          f"synchronized); scans 1, launches {launched}, trace kernel "
          f"events {events}")

    # the batch against the statements solo, on the plain versions
    cm_solo = execute(ScanAgg(CountMinAggregate(use_kernel="ref"), t,
                              label="countmin"))
    bitwise(torch, "session countmin vs solo use_kernel='ref'",
            batch["countmin"], cm_solo)
    for col in ("item", "g"):
        want = fm_distinct_count(t, item_col=col)
        got = (batch["fm_distinct"] if col == "item"
               else batch["profile"][col]["approx_distinct"])
        require(torch.equal(got, want)
                and torch.equal(batch["profile"][col]["approx_distinct"],
                                want),
                f"session FM estimate of {col} differs from solo")
    fused = run_many([CountMinAggregate(use_kernel=True), FMAggregate(),
                      FMAggregate(item_col="g")], t, finalize=False)
    for got, want in zip(fused, (
            cm_solo,
            run_many([FMAggregate()], t, finalize=False)[0],
            run_many([FMAggregate(item_col="g")], t, finalize=False)[0])):
        bitwise(torch, "fused sketch states vs solo", got, want)
    d_ols = float((batch["linregr"].coef - solo.coef).abs().max())
    require(torch.allclose(batch["linregr"].coef, solo.coef, rtol=1e-5,
                           atol=1e-6),
            f"session linregr coef vs solo differ by {d_ols}")
    # Count-Min never underestimates: the 100 most frequent keys
    exact = torch.bincount(t["item"].long(), minlength=ZIPF_KEYS)
    top = torch.topk(exact, 100).indices
    est = countmin_query(batch["countmin"], top.to(torch.int32))
    require(bool((est >= exact[top].to(est.dtype)).all()),
            "Count-Min underestimates a heavy hitter")
    over = float(((est - exact[top]).double() / exact[top].double()).max())
    # profile: count, min and max exact; sums against float64
    stats = batch["profile"]
    for col in ("x", "y", "g", "item"):
        v = t[col].to(torch.float32)
        st = stats[col]
        require(float(st["count"]) == N_MAIN, f"profile {col} count")
        require(torch.equal(st["min"], v.amin(dim=0))
                and torch.equal(st["max"], v.amax(dim=0)),
                f"profile {col} min/max")
        require(bool(torch.isfinite(st["std"]).all()), f"profile {col} std")
        # float64 sums, 32 columns at a time to bound the copies
        chunks = torch.split(v.reshape(N_MAIN, -1), 32, dim=1)
        for key, power in (("sum", 1), ("sumsq", 2)):
            want = torch.cat([(c.double() ** power).sum(0) for c in chunks])
            scale = torch.cat([(c.double().abs() ** power).sum(0)
                               for c in chunks])
            err = float((st[key].reshape(-1).double() - want).abs().max())
            limit = PROFILE_RTOL * float(scale.max())
            require(err <= limit, f"profile {col}.{key}: error {err} vs "
                    f"float64 exceeds {limit}")
        del v, chunks
    print(f"[main] session batch vs solo use_kernel='ref': countmin state "
          f"and fused sketch states bitwise, FM estimates bitwise, linregr "
          f"coef within {d_ols:.1e}; profile count/min/max exact, sum/sumsq within "
          f"{PROFILE_RTOL} of the float64 sum of |terms|; Count-Min over "
          f"the 100 heaviest keys: never under, max over {over:.3e} "
          f"(relative); FM estimate of item {float(batch['fm_distinct']):.0f}"
          f" vs {int((exact > 0).sum())} distinct")
    del batch, fused, exact, stats
    torch.cuda.empty_cache()

    # c. GROUP BY sketches, each a statement of its own
    view = t.group_by("g", G_MAIN).select("item")
    for name, stmt, agg_cls in (
            ("countmin_grouped",
             lambda uk: countmin_sketch_grouped(t, "g", G_MAIN,
                                                use_kernel=uk),
             CountMinAggregate),
            ("fm_grouped",
             lambda uk: fm_distinct_count_grouped(t, "g", G_MAIN,
                                                  use_kernel=uk),
             FMAggregate)):
        kern = "segment_" + ("countmin" if agg_cls is CountMinAggregate
                             else "fm")
        seconds[name] = []
        counters.zero()
        with trace_execution() as tr:
            for _ in range(2):
                results[name], s = timed(torch, lambda: stmt(True))
                seconds[name].append(s)
        launched = counters.read()
        engines = [e.engine for e in tr.kernels]
        require(launched[kern] == 2, f"{name}: launches {launched}")
        require(engines == ["cuda", "cuda"],
                f"{name}: trace kernel events {engines}")
        want = stmt("ref")
        bitwise(torch, f"{name} result vs use_kernel='ref'", results[name],
                want)
        got = run_grouped(agg_cls(use_kernel=True), view, finalize=False)
        want = run_grouped(agg_cls(use_kernel="ref"), view, finalize=False)
        bitwise(torch, f"{name} fold state vs use_kernel='ref'", got, want)
        require(tuple(got.shape[:1]) == (G_MAIN,), f"{name} shape")
        print(f"[main] {name}: first {seconds[name][0]:.3f} s, again "
              f"{seconds[name][1]:.3f} s (host clock, synchronized); "
              f"launches {launched}, trace kernel events {engines}, sorts "
              f"{len(tr.sorts)}; fold state bitwise vs use_kernel='ref'")
        del got, want

    # d. small input: the card's kernel path against the CPU port
    small, _ = synthetic_regression_table(SEED + 1, 4096, 7, device="cpu")
    small = small.with_column("g", torch.arange(4096, dtype=torch.int32) % 5)
    small = small.with_column("item", (torch.arange(4096, dtype=torch.int32)
                                       * 7919 % 1013) - 300)
    small_gpu = Table({k: v.to(dev) for k, v in small.columns.items()})
    for name, fn in (("linregr", lambda tb, uk: linregr(tb, use_kernel=uk)),
                     ("linregr_grouped", lambda tb, uk: linregr_grouped(
                         tb, "g", num_groups=5, use_kernel=uk))):
        got = fn(small_gpu, True).coef.cpu()
        want = fn(small, False).coef
        require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                f"{name} small: card vs CPU differ by "
                f"{float((got - want).abs().max())}")
    # Sketch states are integers: bitwise.  FM estimates go through a
    # float pow that the card and the CPU may round 1 ulp apart.
    got, want = mix(small_gpu), mix(small)
    require(torch.equal(got["countmin"].cpu(), want["countmin"]),
            "session countmin small: card vs CPU")
    require(torch.allclose(got["fm_distinct"].cpu(), want["fm_distinct"],
                           rtol=1e-6, atol=0),
            "session FM estimate small: card vs CPU")
    require(torch.allclose(got["linregr"].coef.cpu(), want["linregr"].coef,
                           rtol=1e-4, atol=1e-4), "session linregr small")
    for col, st in want["profile"].items():
        for key, v in st.items():
            require(torch.allclose(got["profile"][col][key].cpu(), v,
                                   rtol=1e-5, atol=1e-5 * float(
                                       v.abs().max().clamp(min=1))),
                    f"session profile small {col}.{key}")
    for agg_cls in (CountMinAggregate, FMAggregate):
        require(torch.equal(
            run_grouped(agg_cls(use_kernel=True), small_gpu, "g", 5,
                        finalize=False).cpu(),
            run_grouped(agg_cls(use_kernel=True), small, "g", 5,
                        finalize=False)),
                f"grouped {agg_cls.__name__} state small: card vs CPU")
    require(torch.equal(profile(small_gpu)["item"]["max"].cpu(),
                        profile(small)["item"]["max"]), "profile small")
    print("[main] small input: card kernels agree with the CPU port "
          "(sketch states bitwise, FM estimates within 1e-6, OLS and "
          "profile within 1e-4 / 1e-5)")

    # the repeated grouped statements, stage by stage: the same calls
    # that run_grouped makes, each ended by synchronize() (host clock)
    def grouped_stages(name, agg, columns):
        stage_s = {}
        gview, stage_s["group_by (memo hit)"] = timed(
            torch, lambda: t.group_by("g", G_MAIN).select(*columns))
        bs = segment_block_size(gview.n_rows, G_MAIN)
        layout, stage_s["aligned_blocks"] = timed(
            torch, lambda: gview.aligned_blocks(bs))
        ops = probe_segment_ops(agg, dict(gview.table.columns))
        states, stage_s["segment_fold (kernel)"] = timed(
            torch, lambda: segment_fold(agg, ops, *layout, G_MAIN,
                                        kernel_impl="cuda"))
        _, stage_s["final_grouped"] = timed(
            torch, lambda: agg.final_grouped(states))
        stage_s["rest of the statement"] = (seconds[name][1]
                                            - sum(stage_s.values()))
        print(f"[breakdown] {name}, repeated call {seconds[name][1]:.4f} s "
              "(host clock, synchronized): " + "; ".join(
                  f"{k} {v:.4f} s" for k, v in stage_s.items()))
        return layout

    cols, valid, bgids = grouped_stages(
        "linregr_grouped", LinregrAggregate(use_kernel=True), ("x", "y"))
    sk_cols, sk_valid, sk_bgids = grouped_stages(
        "countmin_grouped", CountMinAggregate(use_kernel=True), ("item",))

    # the repeated Session batch against its members run alone, each a
    # full scan of its own (host clock, synchronized)
    member_s = {}
    for name, stmt in (
            ("profile", lambda: profile(t, distinct_counts=True)),
            ("linregr", lambda: linregr(t, use_kernel=True)),
            ("countmin", lambda: execute(ScanAgg(
                CountMinAggregate(use_kernel=True), t, label="countmin"))),
            ("fm_distinct", lambda: fm_distinct_count(t))):
        _, member_s[name] = timed(torch, stmt)
    print(f"[breakdown] session batch, repeated call "
          f"{seconds['session batch'][1]:.4f} s; its members alone: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in member_s.items())
          + f" (sum {sum(member_s.values()):.4f} s)")

    # e. k-means on a blobs table made on the card from the seed: 10M
    # points around K_KM true centers, and the main table's groups g
    centers = torch.randn((K_KM, D_KM), generator=gen, device=dev) * CENTER_SD
    lab = torch.randint(0, K_KM, (N_MAIN,), generator=gen, device=dev)
    bx = centers[lab] + torch.randn((N_MAIN, D_KM), generator=gen,
                                    device=dev)
    del lab
    blobs = Table({"x": bx, "g": t["g"]})
    seeds, s_seed = timed(torch, lambda: kmeans_pp_seed(blobs, K_KM, SEED))
    print(f"[main] kmeans++ seeding, k = {K_KM} over {N_MAIN} x {D_KM}: "
          f"{s_seed:.3f} s ({K_KM - 1} fused scans)")
    km = {}
    # the main path's kmeans_assign launches by shape: the solo fits at
    # (N_MAIN, D_KM, K_KM), the grouped fit over one group's rows at a time
    km_launches = {"solo": 0, "grouped": 0}
    for name, kw in (("kernel, from k-means++", {"seed": SEED,
                                                 "use_kernel": True}),
                     ("kernel, repeated", {"init_centroids": seeds,
                                           "use_kernel": True}),
                     ("plain", {"init_centroids": seeds})):
        counters.zero()
        with trace_execution() as tr:
            km[name], s = timed(torch, lambda: kmeans_fit(
                blobs, K_KM, max_iters=KM_MAX_ITERS,
                reassign_frac_tol=KM_REASSIGN_TOL, **kw))
        launched = counters.read()
        res = km[name]
        engines = {e.engine for e in tr.kernels}
        require(res.converged, f"kmeans_fit {name}: not converged in "
                f"{KM_MAX_ITERS} rounds (sse trace tail "
                f"{res.sse_trace[-4:]})")
        want = 2 * res.n_iters if kw.get("use_kernel") else 0
        km_launches["solo"] += launched["kmeans_assign"]
        require(launched["kmeans_assign"] == want,
                f"kmeans_fit {name}: {launched['kmeans_assign']} "
                f"kmeans_assign launches, want {want} (2 per round)")
        require(engines == ({"cuda"} if kw.get("use_kernel") else set()),
                f"kmeans_fit {name}: trace kernel engines {engines}")
        seconds[f"kmeans_fit {name}"] = [s, s / res.n_iters]
        print(f"[main] kmeans_fit ({name}): {s:.3f} s, {res.n_iters} rounds, "
              f"{s / res.n_iters * 1e3:.2f} ms per round (host clock, "
              f"synchronized); kmeans_assign launches "
              f"{launched['kmeans_assign']}, sse {res.sse:.6e}")
    km_kern, plain_fit = km["kernel, repeated"], km["plain"]
    require(torch.equal(km_kern.centroids, km["kernel, from k-means++"]
                        .centroids), "kmeans_fit: the k-means++ fit and the "
            "fit from its seeds differ")
    d_km = float((km_kern.centroids - plain_fit.centroids).abs().max())
    require(torch.allclose(km_kern.centroids, plain_fit.centroids, rtol=1e-4,
                           atol=1e-3),
            f"kmeans_fit: kernel vs plain centroids differ by {d_km}")
    require(abs(km_kern.n_iters - plain_fit.n_iters) <= 2,
            f"kmeans_fit: rounds {km_kern.n_iters} (kernel) vs "
            f"{plain_fit.n_iters} (plain)")
    ones = torch.ones((N_MAIN,), device=dev)
    round_ms = 2 * cuda_ms(torch, lambda: km_ops.assign_and_reduce(
        bx, km_kern.centroids, ones), 10)
    share = round_ms / (seconds["kmeans_fit kernel, repeated"][1] * 1e3)
    print(f"[main] kmeans_fit: kernel vs plain centroids max diff "
          f"{d_km:.3e}, rounds {km_kern.n_iters} vs {plain_fit.n_iters}; "
          f"kmeans_assign takes {round_ms:.3f} ms of a round (2 launches, "
          f"CUDA events), {share:.1%} of the repeated fit's round")

    # the paper-faithful two-pass variant on the first N_TWO_PASS rows:
    # no kernel on its path.  Its round r ends with the centroids c_r, as
    # the fused round r does, but it counts the moves of the assignment to
    # c_r where the fused round counts those to c_(r-1): above a zero
    # tolerance it stops one round earlier.  So the fused fit is held to
    # the same number of rounds, on the plain path, whose argmin the
    # two-pass statements share (kernel and cuBLAS split a few near-tie
    # rows apart, and a blob shared by two seeds splits along a neutrally
    # stable direction, which such rows move over the rounds).
    t1 = Table({"x": bx[:N_TWO_PASS]})
    counters.zero()
    (two, s_two) = timed(torch, lambda: kmeans_fit(
        t1, K_KM, init_centroids=seeds, variant="two_pass",
        max_iters=KM_MAX_ITERS, reassign_frac_tol=KM_REASSIGN_TOL))
    require(counters.read()["kmeans_assign"] == 0, "two-pass launched")
    fused1 = kmeans_fit(t1, K_KM, init_centroids=seeds,
                        max_iters=two.n_iters,
                        reassign_frac_tol=KM_REASSIGN_TOL)
    kern1 = kmeans_fit(t1, K_KM, init_centroids=seeds, use_kernel=True,
                       max_iters=two.n_iters,
                       reassign_frac_tol=KM_REASSIGN_TOL)
    d_two = float((two.centroids - fused1.centroids).abs().max())
    require(two.converged and fused1.n_iters == two.n_iters
            and torch.allclose(two.centroids, fused1.centroids, rtol=1e-4,
                               atol=1e-3),
            f"kmeans_fit two_pass vs fused at {N_TWO_PASS} rows: converged "
            f"{two.converged}, rounds {two.n_iters}/{fused1.n_iters}, "
            f"centroids differ by {d_two}")
    print(f"[main] kmeans_fit two_pass, {N_TWO_PASS} rows: {s_two:.3f} s, "
          f"{two.n_iters} rounds, {s_two / two.n_iters * 1e3:.1f} ms per "
          f"round; centroids vs the fused fit (plain) after as many rounds "
          f"max diff {d_two:.3e}, vs the fused fit through the kernel "
          f"{float((two.centroids - kern1.centroids).abs().max()):.3e}")

    # GROUP BY: one k = K_KM_GROUPED model per group g, a shared seeding
    gseeds = kmeans_pp_seed(blobs, K_KM_GROUPED, SEED)
    gkw = {"init_centroids": gseeds, "max_iters": KM_MAX_ITERS,
           "reassign_frac_tol": KM_REASSIGN_TOL}
    counters.zero()
    with trace_execution() as tr:
        kg, s_first = timed(torch, lambda: kmeans_grouped(
            blobs, "g", K_KM_GROUPED, G_MAIN, use_kernel=True, **gkw))
    launched = counters.read()
    n_it = np.asarray(kg.n_iters)
    km_launches["grouped"] = launched["kmeans_assign"]
    print(f"[main] kmeans_grouped rounds per group: {n_it.tolist()}")
    require(bool(np.all(kg.converged)), f"kmeans_grouped: groups "
            f"{np.nonzero(~kg.converged)[0].tolist()} not converged")
    require(launched["kmeans_assign"] == 2 * int(n_it.sum()),
            f"kmeans_grouped: {launched['kmeans_assign']} launches, want "
            f"{2 * int(n_it.sum())} (2 per active group and round)")
    require({e.engine for e in tr.kernels} == {"cuda"},
            "kmeans_grouped: trace kernel engines")
    # the same fit through fit_grouped, for its stats (the repeated call)
    task = KMeansTask(gseeds, use_kernel=True)
    bg = Table({"x": bx, "g": t["g"]})
    fg, s_again = timed(torch, lambda: fit_grouped(
        task, bg, "g", G_MAIN, max_iters=KM_MAX_ITERS,
        tol=KM_REASSIGN_TOL + 0.5 / N_MAIN))
    require(np.array_equal(fg.n_iters, n_it), "kmeans_grouped vs "
            "fit_grouped: rounds differ")
    st = fg.stats
    gcounts = torch.bincount(t["g"].long(), minlength=G_MAIN).cpu().numpy()
    gbs = segment_block_size(N_MAIN, G_MAIN)
    nblk = -(-gcounts // gbs)
    rounds = int(n_it.max())
    act = [int(gcounts[n_it > i].sum()) for i in range(rounds)]
    require(st["layout"] == "segment" and st["block_size"] == gbs
            and st["rounds"] == rounds
            and st["blocks"] == int((n_it * nblk).sum())
            and st["blocks_full_scan"] == rounds * int(nblk.sum())
            and list(st["active_rows"]) == act and act[0] == N_MAIN,
            f"kmeans_grouped stats {st}")
    plain_g = kmeans_grouped(blobs, "g", K_KM_GROUPED, G_MAIN, **gkw)
    d_it = int(np.abs(np.asarray(plain_g.n_iters) - n_it).max())
    d_g = float((kg.centroids - plain_g.centroids).abs().max())
    require(bool(np.all(plain_g.converged)) and d_it <= 2,
            f"kmeans_grouped: plain rounds differ by up to {d_it}")
    print(f"[main] kmeans_grouped, G = {G_MAIN}, k = {K_KM_GROUPED}: first "
          f"{s_first:.3f} s, again (fit_grouped) {s_again:.3f} s (host "
          f"clock, synchronized); {rounds} rounds, {int(n_it.sum())} group "
          f"rounds ({(s_again / rounds) * 1e3:.1f} ms per round); launches "
          f"{launched['kmeans_assign']}; stats blocks {st['blocks']} of "
          f"{st['blocks_full_scan']} (full scans), block {gbs}; every group "
          f"converged; rounds vs plain differ by at most {d_it}, centroids "
          f"by {d_g:.3e}")
    seconds["kmeans_grouped"] = [s_first, s_again]

    # f. logistic regression (IRLS) over x with a 0/1 label from
    # sigmoid(x b), b ~ N(0, 1/K) so that the logits stay near unit scale
    b_l = torch.randn((K_MAIN,), generator=gen, device=dev) / K_MAIN ** 0.5
    yl = (torch.rand((N_MAIN,), generator=gen, device=dev)
          < torch.sigmoid(t["x"] @ b_l)).float()
    tl = Table({"x": t["x"], "y": yl, "g": t["g"]})
    for name, stmt in (("logregr", lambda: logregr(tl)),
                       ("logregr_grouped",
                        lambda: logregr_grouped(tl, "g", G_MAIN))):
        seconds[name] = []
        for _ in range(2):
            results[name], s = timed(torch, stmt)
            seconds[name].append(s)
        res = results[name]
        n_it = np.asarray(res.n_iters)
        require(bool(np.all(res.converged)), f"{name}: not converged")
        require(bool(torch.isfinite(res.coef).all()), f"{name}: coef")
        print(f"[main] {name}: first {seconds[name][0]:.3f} s, again "
              f"{seconds[name][1]:.3f} s (host clock, synchronized); rounds "
              f"{int(n_it.max())}, {seconds[name][1] / n_it.max() * 1e3:.1f} "
              "ms per round")
    lr64, s64 = timed(torch, lambda: logregr(
        Table({"x": t["x"].double(), "y": yl.double()}),
        block_size=1_000_000))
    solo = results["logregr"]
    d_lr = float((solo.coef.double() - lr64.coef).abs().max())
    require(lr64.converged and torch.allclose(
        solo.coef.double(), lr64.coef, rtol=IRLS_RTOL, atol=IRLS_ATOL),
        f"logregr: f32 vs float64 coef differ by {d_lr}")
    require(results["logregr_grouped"].coef.shape == (G_MAIN, K_MAIN),
            "logregr_grouped shape")
    print(f"[main] logregr: coef vs the float64 IRLS max diff {d_lr:.3e} "
          f"(float64 fit {s64:.3f} s, {lr64.n_iters} rounds); vs the true b "
          f"{float((solo.coef - b_l).abs().max()):.3e}")
    stream_host = {"yl": pinned_copy(torch, yl)}
    del yl, tl, lr64
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] max_memory_allocated {peak_gb:.2f} GB")
    torch.cuda.empty_cache()

    # the fits' states on a small dyadic input: the card (kernel) against
    # the CPU port (plain version), bitwise; the fits themselves allclose
    # with equal rounds; k-means++ picks the same rows
    sgen = torch.Generator().manual_seed(SEED)
    sc = (torch.randn((5, 8), generator=sgen) * 32).round() / 8
    sx = sc[torch.randint(0, 5, (4096,), generator=sgen)] + (
        torch.randn((4096, 8), generator=sgen) * 4).round() / 8
    sy = (torch.rand(4096, generator=sgen) < torch.sigmoid(
        sx @ torch.full((8,), 0.1))).float()
    small_cpu = Table({"x": sx, "y": sy})
    small_gpu = Table({"x": sx.to(dev), "y": sy.to(dev)})
    c0 = sc + 0.5
    for name, agg in (
            ("KMeansAggregate", lambda d_: KMeansAggregate(
                c0.to(d_), c0.flip(0).to(d_), use_kernel=True)),
            ("IRLSAggregate", lambda d_: IRLSAggregate(
                torch.zeros(8, device=d_)))):
        got = state_to_numpy(run_local(agg(dev), small_gpu, finalize=False))
        want = state_to_numpy(run_local(agg("cpu"), small_cpu,
                                        finalize=False))
        for q in want:
            same = np.array_equal(got[q], want[q]) if q != "ll" \
                else np.allclose(got[q], want[q], rtol=1e-6)
            require(same, f"small {name} state {q}: card vs CPU")
    require(torch.equal(kmeans_pp_seed(small_gpu, 5, SEED).cpu(),
                        kmeans_pp_seed(small_cpu, 5, SEED)),
            "small k-means++: card and CPU pick different seeds")
    for name, fn in (("kmeans_fit", lambda tb: kmeans_fit(
            tb, 5, init_centroids=c0.to(tb.device), use_kernel=True)),
                     ("logregr", lambda tb: logregr(tb))):
        got, want = fn(small_gpu), fn(small_cpu)
        a = got.centroids if name == "kmeans_fit" else got.coef
        b = want.centroids if name == "kmeans_fit" else want.coef
        require(got.n_iters == want.n_iters and torch.allclose(
            a.cpu(), b, rtol=1e-4, atol=1e-5),
            f"small {name}: card vs CPU rounds {got.n_iters}/"
            f"{want.n_iters}, max diff {float((a.cpu() - b).abs().max())}")
    print("[main] small input: KMeansAggregate (through kmeans_assign) and "
          "IRLSAggregate states bitwise equal to the CPU port's (ll within "
          "1e-6), the same k-means++ seeds, kmeans_fit and logregr with "
          "equal rounds and within 1e-4")

    # 5. timing at the main path's shapes -----------------------------------
    x, y = t["x"], t["y"]
    xs, ys = cols["x"], cols["y"]
    n2, nb = xs.shape[0], bgids.shape[0]
    n_valid = int(valid.sum())
    items = t["item"]
    all_rows = torch.ones((N_MAIN,), dtype=torch.bool, device=dev)
    sk_items = sk_cols["item"]
    sk_n2, sk_nb = sk_items.shape[0], sk_bgids.shape[0]
    sk_valid_n = int(sk_valid.sum())
    cm_kw = {"depth": 4, "width": 1024, "num_groups": G_MAIN}
    km_cents = km_kern.centroids
    # a point of reference, not the yardstick: the cuBLAS distance product
    # x c^T alone (no single PyTorch call assigns and reduces)
    xc_ms = cuda_ms(torch, lambda: torch.matmul(bx, km_cents.T), 20)
    print(f"[timing] kmeans_assign reference: cuBLAS x @ c.T alone at "
          f"({N_MAIN}, {D_KM}) x ({D_KM}, {K_KM}) f32: {xc_ms:.4f} ms")
    # a point of reference for countmin, not the yardstick: torch.bincount
    # over the precomputed flat buckets d * width + h_d(item), the
    # counting half alone (no single PyTorch call hashes and counts)
    flat = (_hash_rows(items, 4, 1024) + 1024 * torch.arange(
        4, device=dev)[:, None]).reshape(-1)
    bc_ms = cuda_ms(torch, lambda: torch.bincount(flat, minlength=4 * 1024),
                    20)
    require(torch.equal(torch.bincount(flat, minlength=4 * 1024).view(
        4, 1024).to(torch.int32), cm_ops.countmin_block(items, all_rows, 4,
                                                        1024)),
            "countmin reference: bincount disagrees with the kernel")
    print(f"[timing] countmin reference: torch.bincount over the "
          f"{flat.numel()} precomputed flat buckets alone (int64): "
          f"{bc_ms:.4f} ms")
    del flat
    l2_flush = torch.empty((32 * 2 ** 20,), dtype=torch.float32, device=dev)
    fm_kw = {"num_hashes": 8, "bits": 32, "num_groups": G_MAIN}
    # Operations and bytes: each kernel package's cost count (the one
    # that the dry run and the op counter read too).  X^T X is symmetric,
    # so only its k (k + 1) / 2 distinct entries, plus X^T y (and, per
    # group, y^2), each a multiply and an add per row; sum(y) and n one add
    # per row; segment_linregr counts the valid rows, the ones the
    # function needs.  The sketches need PIPE_OPS_PER_HASH integer
    # instructions per valid row and hash, on the slowest pipe
    # (int_ops_seconds).  Bytes: each input read once, each output
    # written once.
    sl_ops, sl_bytes = sf_ops.linregr_cost(n2, K_MAIN, nb, G_MAIN,
                                           rows=n_valid)
    # column_stats, the profile transition's kernel, at the main path's
    # shapes against its plain version: dyadic draws (a generator of
    # their own), so every sum is exact and the two agree bit for bit;
    # section b held it on the main path's x against float64
    gen_cs = torch.Generator(device=dev)
    gen_cs.manual_seed(SEED + 9)
    errs["column_stats"] = 0.0
    for shape in ((N_MAIN, K_MAIN), (N_MAIN,)):
        c = dyadic(torch, gen_cs, shape, dev)
        errs["column_stats"] = max(errs["column_stats"], *(
            bitwise(torch, f"column_stats {shape}", got, want)
            for got, want in zip(cs_ops.column_stats(c, all_rows),
                                 column_stats_ref(c, all_rows))))
        del c
    print(f"[kernels] column_stats ({N_MAIN}, {K_MAIN}) and ({N_MAIN},) "
          "dyadic: bitwise equal to the plain version")
    specs = (
        ("xtx", "src/repro_torch/csrc/xtx.cu",
         "src/repro/kernels/xtx/kernel.py:29",
         lambda: xtx_ops.xtx_xty(x, y), lambda: xtx_xty_ref(x, y),
         lambda: torch.matmul(x.T, x),
         xtx_ops.xtx_cost(N_MAIN, K_MAIN)[0] / PEAK_F32_FLOPS,
         xtx_ops.xtx_cost(N_MAIN, K_MAIN)[1], 5, 2,
         [N_MAIN, K_MAIN], ("xtx_upper_kernel", "xtx_reduce_kernel")),
        ("segment_linregr", "src/repro_torch/csrc/segment_linregr.cu",
         "src/repro/kernels/segment_fold/kernel.py:52",
         lambda: sf_ops.segment_linregr(xs, ys, valid, bgids,
                                        num_groups=G_MAIN),
         lambda: segment_linregr_ref(xs, ys, valid, bgids,
                                     num_groups=G_MAIN),
         None, sl_ops / PEAK_F32_FLOPS, sl_bytes, 5, 2,
         [n2, K_MAIN, nb, G_MAIN],
         ("segment_partial_kernel", "segment_reduce_kernel")),
        ("countmin", "src/repro_torch/csrc/countmin.cu",
         "src/repro/kernels/countmin/kernel.py:34",
         lambda: cm_ops.countmin_block(items, all_rows, 4, 1024),
         lambda: countmin_block_ref(items, all_rows, 4, 1024), None,
         int_ops_seconds("countmin", float(N_MAIN) * 4, sms, clock_hz),
         cm_ops.countmin_cost(N_MAIN, 4, 1024)[1], 20, 1,
         [N_MAIN, 4, 1024], ("countmin_kernel",)),
        ("segment_countmin", "src/repro_torch/csrc/segment_sketch.cu",
         "src/repro/kernels/segment_fold/kernel.py:125",
         lambda: sf_ops.segment_countmin(sk_items, sk_valid, sk_bgids,
                                         **cm_kw),
         lambda: segment_countmin_ref(sk_items, sk_valid, sk_bgids, **cm_kw),
         None,
         int_ops_seconds("segment_countmin", float(sk_valid_n) * 4, sms,
                         clock_hz),
         sf_ops.sketch_cost(sk_n2, sk_nb, G_MAIN * 4 * 1024)[1], 20, 1,
         [sk_n2, sk_nb, G_MAIN, 4, 1024], ("segment_countmin_kernel",)),
        ("segment_fm", "src/repro_torch/csrc/segment_sketch.cu",
         "src/repro/kernels/segment_fold/kernel.py:180",
         lambda: sf_ops.segment_fm(sk_items, sk_valid, sk_bgids, **fm_kw),
         lambda: segment_fm_ref(sk_items, sk_valid, sk_bgids, **fm_kw),
         None,
         int_ops_seconds("segment_fm", float(sk_valid_n) * 8, sms,
                         clock_hz),
         sf_ops.sketch_cost(sk_n2, sk_nb, G_MAIN * 8 * 32)[1], 20, 1,
         [sk_n2, sk_nb, G_MAIN, 8, 32], ("segment_fm_kernel",)),
        # a multiply and an add per row, centroid and feature; x and the
        # mask in, assign and mind out, the centroids in and the sums out
        ("kmeans_assign", "src/repro_torch/csrc/kmeans_assign.cu",
         "src/repro/kernels/kmeans_assign/kernel.py:26",
         lambda: km_ops.assign_and_reduce(bx, km_cents, ones),
         lambda: assign_and_reduce_ref(bx, km_cents, ones), None,
         km_ops.assign_cost(N_MAIN, D_KM, K_KM)[0] / PEAK_F32_FLOPS,
         km_ops.assign_cost(N_MAIN, D_KM, K_KM)[1], 20, 2,
         [N_MAIN, D_KM, K_KM],
         ("kmeans_assign_kernel", "kmeans_reduce_kernel")),
        # replaces no Pallas kernel: the reference's profile is plain jnp;
        # bytes bound it (about 7 f32 operations a value)
        ("column_stats", "src/repro_torch/csrc/column_stats.cu",
         "none (src/repro/core/templates.py ProfileAggregate.transition, "
         "plain jnp)",
         lambda: cs_ops.column_stats(x, all_rows),
         lambda: column_stats_ref(x, all_rows), None,
         cs_ops.column_stats_cost(N_MAIN, K_MAIN)[0] / PEAK_F32_FLOPS,
         cs_ops.column_stats_cost(N_MAIN, K_MAIN)[1], 20, 2,
         [N_MAIN, K_MAIN],
         ("column_stats_partial_kernel", "column_stats_reduce_kernel")),
    )
    rows = []
    for (name, source, replaces, kern, plain, lib, op_s, nbytes, reps,
         per_call, shape, kernel_names) in specs:
        ms = cuda_ms(torch, kern, reps)
        dev_ms = device_ms(torch, kern, reps, kernel_names)
        plain_ms = cuda_ms(torch, plain, 2)
        lib_ms = cuda_ms(torch, lib, reps) if lib is not None else None
        t_ops, t_bytes = op_s * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": counters.total[name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": lib_ms, "launches_per_call": per_call,
               "device_ms": dev_ms, "ops_ms": t_ops, "bytes_ms": t_bytes,
               "shape": shape, "bound_share": max(t_ops, t_bytes) / ms}
        if name in F32_OPS_KERNELS:
            row["tflops"] = op_s * PEAK_F32_FLOPS / (ms * 1e-3) / 1e12
        if name in ("countmin", "segment_countmin"):
            # the column arrives cold in a statement: 128 MB written
            # between launches; device time beside both
            row["cold_ms"] = cold_ms(torch, kern, 10, l2_flush)
            dev_s = "not measured" if dev_ms is None else f"{dev_ms:.4f}"
            print(f"[timing] {name} {shape}: events back to back {ms:.4f} "
                  f"ms, device (torch.profiler) {dev_s} ms, L2 cold "
                  f"{row['cold_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
                  f"({row['bound_by']}); {smi}")
        if name == "kmeans_assign":
            row["launches_by_shape"] = {
                f"({N_MAIN}, {D_KM}, {K_KM})": km_launches["solo"],
                f"grouped (one group's rows, {D_KM}, {K_KM_GROUPED})":
                    km_launches["grouped"]}
        print(json.dumps({"kernel": row}))
        rows.append(row)

    # kmeans_assign at the grouped fit's launch shape: one group's share of
    # the rows (N_MAIN / G_MAIN), k = K_KM_GROUPED, from its seeds
    n_g = N_MAIN // G_MAIN
    xg, mg = bx[:n_g], ones[:n_g]
    g_ms = cuda_ms(torch, lambda: km_ops.assign_and_reduce(xg, gseeds, mg),
                   200)
    g_plain = cuda_ms(torch, lambda: assign_and_reduce_ref(xg, gseeds, mg), 20)
    g_ops, g_bytes = km_ops.assign_cost(n_g, D_KM, K_KM_GROUPED)
    g_ops, g_bytes = (g_ops / PEAK_F32_FLOPS * 1e3,
                      g_bytes / PEAK_BYTES * 1e3)
    print(json.dumps({"kernel_at_grouped_shape": {
        "name": "kmeans_assign", "shape": [n_g, D_KM, K_KM_GROUPED],
        "launches": km_launches["grouped"], "ms": g_ms, "plain_ms": g_plain,
        "bound_ms": max(g_ops, g_bytes),
        "bound_by": "operations" if g_ops >= g_bytes else "bytes",
        "ops_ms": g_ops, "bytes_ms": g_bytes,
        "bound_share": max(g_ops, g_bytes) / g_ms}}))

    # h. the analytics server, with the tables of a-f dropped but for the
    # Zipf item column; the kernels line's launches include this phase
    srv_item = t["item"]
    stream_host["bx"] = pinned_copy(torch, bx)
    del (t, cols, valid, bgids, sk_cols, sk_valid, sk_bgids, bx, blobs, bg,
         view, x, y, xs, ys, items, all_rows, sk_items, ones, specs, results,
         km, km_kern, plain_fit, km_cents, t1, fg, kg, plain_g, two, fused1,
         kern1, xg, mg, l2_flush)
    gc.collect()
    torch.cuda.empty_cache()
    before = dict(counters.total)
    steps, h_host = server_section(torch, dev, counters, errs, srv_item, smi)
    del srv_item
    gc.collect()
    torch.cuda.empty_cache()

    # i. the stream engine, from pinned host copies of section h's first
    # N_MAIN rows, section e's blobs and section f's label
    stream_host.update(h_host)
    del h_host
    i_steps = stream_section(torch, dev, counters, errs, stream_host, seeds,
                             smi)
    del stream_host
    gc.collect()
    torch.cuda.empty_cache()

    # j. the measured calibration on the card, then the methods of the
    # tenth slice at full size
    j_steps = methods_section(torch, dev, counters, errs, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # k. the convex layer and what runs on it, at full size
    k_steps = convex_section(torch, dev, counters, errs, smi)
    for row in rows:
        name = row["name"]
        row["launches"] = counters.total[name]
        if name == "xtx":  # of them, the narrow kernel's (K <= K_NARROW)
            row["launches_narrow"] = counters.total["xtx_narrow"]
        by_step = {f"{kind} {step}": got[name]
                   for kind, st in (("server", steps), ("stream", i_steps),
                                    ("methods", j_steps),
                                    ("convex", k_steps))
                   for step, got in st.items() if got.get(name)}
        if by_step:
            row["launches_by_shape"] = {
                **row.get("launches_by_shape",
                          {"phases a-f (main path)": before[name]}),
                **by_step}
            print(json.dumps({"kernel_launches": {
                "name": name, "launches": row["launches"],
                **({"launches_narrow": row["launches_narrow"]}
                   if name == "xtx" else {}),
                "launches_by_shape": row["launches_by_shape"]}}))
    gc.collect()
    torch.cuda.empty_cache()

    # g. the LM path, once the analytics tables are dropped
    print(f"[lm] memory held after dropping the analytics tables: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    row = lm_section(torch, dev, counters, errs)
    gc.collect()
    torch.cuda.empty_cache()

    # l. the other LM families at full width and depth, once section g's
    # models are freed
    fam = families_section(torch, dev, counters, smi)
    row["launches"] = counters.total["flash_attention"]
    row["launches_tc"] = counters.total["flash_attention_tc"]
    row["launches_by_shape"] = {
        f"g {LM_ARCH} {tuple(FLASH_MAIN)} causal": row.pop("g_launches"),
        **{f"l {arch} {tuple(k['shape'])} "
           f"{'causal' if k['causal'] else 'non-causal'}":
           fam["launches"][arch] for arch, k in fam["kernel"].items()}}
    row["family_shapes"] = fam["kernel"]
    gc.collect()
    torch.cuda.empty_cache()

    # m. LM training at full width and depth, once section l's models are
    # freed: its flash forward launches join row 7's, its corpus profile's
    # Count-Min launches row 5's, and the backward kernel is row 8
    tr = train_section(torch, dev, counters, errs, smi)
    row["max_abs_err"] = errs["flash_attention"]
    row["launches"] = counters.total["flash_attention"]
    row["launches_tc"] = counters.total["flash_attention_tc"]
    row["launches_by_shape"].update(tr["flash_launches"])
    print(json.dumps({"kernel": row}))
    rows.append(row)
    for r in rows:
        if r["name"] == "countmin":
            r["launches"] = counters.total["countmin"]
            r["launches_by_shape"] = {**r.get("launches_by_shape", {}),
                                      **tr["countmin_launches"]}
            print(json.dumps({"kernel_launches": {
                "name": "countmin", "launches": r["launches"],
                "launches_by_shape": r["launches_by_shape"]}}))
    print(json.dumps({"kernel": tr["row"]}))
    rows.append(tr["row"])
    driver = tr["driver"]
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # n. the sharded engine on meshes of SHARD_SEGS segments of this card,
    # once section m's model is freed: its launches join rows 1-6
    shard = sharded_section(torch, dev, counters, errs, smi)
    for r in rows:
        by_step = {f"sharded {step}": got[r["name"]]
                   for step, got in shard["launches"].items()
                   if got.get(r["name"])}
        if by_step:
            r["launches"] = counters.total[r["name"]]
            r["max_abs_err"] = errs[r["name"]]
            r["launches_by_shape"] = {**r.get("launches_by_shape", {}),
                                      **by_step}
            print(json.dumps({"kernel_launches": {
                "name": r["name"], "launches": r["launches"],
                "launches_by_shape": r["launches_by_shape"]}}))

    # o. the LM's distribution on meshes of this card, once section n's
    # tables are freed: its launches join rows 5, 7 and 8
    gc.collect()
    torch.cuda.empty_cache()
    dist = dist_section(torch, dev, counters, smi, driver)
    for r in rows:
        by_step = {step: got[r["name"]]
                   for step, got in dist["launches"].items()
                   if got.get(r["name"])}
        if by_step:
            r["launches"] = counters.total[r["name"]]
            if "launches_tc" in r:
                r["launches_tc"] = counters.total[f"{r['name']}_tc"]
            r["launches_by_shape"] = {**r.get("launches_by_shape", {}),
                                      **by_step}
            print(json.dumps({"kernel_launches": {
                "name": r["name"], "launches": r["launches"],
                "launches_by_shape": r["launches_by_shape"]}}))

    # p. the dry run, and the dry run against the card, once section o's
    # models are freed: its launches join rows 7 and 8
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_section(torch, dev, counters, smi)
    for r in rows:
        by_step = {step: got[r["name"]]
                   for step, got in dry["launches"].items()
                   if got.get(r["name"])}
        if by_step:
            r["launches"] = counters.total[r["name"]]
            if "launches_tc" in r:
                r["launches_tc"] = counters.total[f"{r['name']}_tc"]
            r["launches_by_shape"] = {**r.get("launches_by_shape", {}),
                                      **by_step}
            print(json.dumps({"kernel_launches": {
                "name": r["name"], "launches": r["launches"],
                "launches_by_shape": r["launches_by_shape"]}}))

    # 6. summary ------------------------------------------------------------
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in ("name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")},
         **{k: r[k] for k in ("ffma_source",) if k in r}}
        for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
