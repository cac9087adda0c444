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
      through ``xtx`` and ``countmin``, against the statements run solo
      on the plain versions;
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
   over the precomputed buckets (a point of reference);
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
   timed over 64 group passes and scaled.  Then the methods of MADlib's Table 1 that
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
g. then, with the analytics tables dropped, the LM serving path:
   the flash_attention kernels against their plain version, each call
   held to the kernel the wrapper must pick (f32 at the reference's test
   shapes and a ragged S through the FFMA kernel; bf16 at every D of the
   repo's configs and at qwen3-8b's layer shape through the tensor-core
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
   version and scaled_dot_product_attention.

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
# 64, 96, 128) with ragged S and GQA through the tensor-core kernel, and a
# D % 8 != 0 that the wrapper sends to the FFMA kernel by rule
FLASH_BF16_SHAPES = [(1, 4, 1, 1, 16, True, "tc"),
                     (3, 6, 2, 77, 64, True, "tc"),
                     (2, 8, 2, 300, 96, False, "tc"),
                     (1, 4, 2, 1000, 128, True, "tc"),
                     (3, 6, 2, 300, 128, False, "tc"),
                     (1, 4, 2, 77, 20, True, "ffma")]
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
# positions whose top two logits (use_flash=False) lie more than
# TOP1_GAP_STEPS bf16 steps apart, the overall share is printed, and the
# logits differ by at most LOGIT_STEPS bf16 steps at the largest logit (the
# paths' roundings differ in every layer and reach the logits through 36
# bf16 residual adds).  In f32, at full depth, top-1 must agree on >=
# TOP1_AGREE of all positions and the logits within 1e-3 of the largest.
TOP1_AGREE, TOP1_GAP_STEPS, LOGIT_STEPS = 0.99, 4, 16
# teacher-forced decode against forward on the 2-layer f32 model: positions
DECODE_CHECK_LEN = 32


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


def flash_bound_ms(b, hq, hk, s, d) -> tuple[float, float]:
    """(operations ms, bytes ms) of causal attention at (B, Hq, Hk, S, D)
    in bf16: 4 B Hq D S (S + 1) / 2 operations (the two products over the
    unmasked pairs) over the bf16 tensor-core peak; q and o, k and v each
    read or written once, 2 bytes an element, over the memory rate."""
    ops = 4.0 * b * hq * d * s * (s + 1) / 2
    nbytes = 2.0 * (2 * b * hq * s * d + 2 * b * hk * s * d)
    return ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def lm_section(torch, dev, counters, errs) -> dict:
    """Section g, the LM serving path at qwen3-8b's full width: the
    flash_attention kernel against its plain version, the prefill forward
    through it (every layer), decode through ``serve``, and the kernel's
    timing.  Returns the kernel's row."""
    import dataclasses
    import math

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

    def bf16_row_ratio(got, want):
        """The worst row (b, h, s): max |got - want| along D over max
        |want| along D (0 where both are 0)."""
        want = want.float()
        err_ = (got.float() - want).abs().amax(-1)
        scale_ = want.abs().amax(-1)
        ratio = torch.where(err_ == 0, torch.zeros_like(err_),
                            err_ / scale_)
        return float(ratio.max())

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
        row = bf16_row_ratio(got, want)
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
    row = bf16_row_ratio(got, want)
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
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, b, hq,
            k.shape[1], s, d, *q.stride()[:3], *k.stride()[:3],
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
    top2 = torch.topk(plain, 2, dim=-1).values.float()
    gap = top2[..., 0] - top2[..., 1]
    step = 2.0 ** (torch.floor(torch.log2(top2[..., 0].abs())) - 7)
    decided = gap > TOP1_GAP_STEPS * step
    top = float(plain.abs().max())
    limit = LOGIT_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    print(f"[lm] forward, bf16: use_flash=False's top two logits equal at "
          f"{float((gap == 0).float().mean()):.2%} of positions, within "
          f"{TOP1_GAP_STEPS} bf16 steps at "
          f"{1 - float(decided.float().mean()):.2%}")
    # the same forward with the kernel's plain version in its place
    entry = registry.get("flash_attention")
    registry._REGISTRY["flash_attention"] = dataclasses.replace(
        entry, cuda=entry.ref)
    try:
        ref_logits, _ = M.forward(model, toks)
    finally:
        registry._REGISTRY["flash_attention"] = entry
    for name, other in (("use_flash=False (chunked)", plain),
                        ("the kernel's plain version", ref_logits)):
        same = logits.argmax(-1) == other.argmax(-1)
        agree, agree_dec = (float(same.float().mean()),
                            float(same[decided].float().mean()))
        d_logit = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(logits.split(512, 1),
                                      other.split(512, 1)))
        print(f"[lm] forward, bf16: flash vs {name}: top-1 agree on "
              f"{agree:.4%} of positions, {agree_dec:.4%} where the top two "
              f"lie over {TOP1_GAP_STEPS} steps apart; max |dlogit| "
              f"{d_logit:.4f} (max |logit| {top:.3f}; limit {LOGIT_STEPS} "
              f"bf16 steps there, {limit:.4f})")
        require(agree_dec >= TOP1_AGREE,
                f"forward vs {name}: top-1 agreement {agree_dec}")
        require(d_logit <= limit, f"forward vs {name}: max |dlogit| "
                f"{d_logit}")
    del logits, plain, ref_logits, top2, gap, step, decided

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
    short = toks[:, :DECODE_CHECK_LEN]
    fwd32, _ = M.forward(model, short)
    state = M.init_decode_state(cfg2, LM_BATCH, DECODE_CHECK_LEN, device=dev)
    steps = []
    for t in range(DECODE_CHECK_LEN):
        lg, state = M.decode_step(model, state, short[:, t:t + 1], t)
        steps.append(lg)
    dec = torch.stack(steps, 1)
    d_dec = float((dec - fwd32).abs().max())
    require(torch.allclose(dec, fwd32, rtol=2e-3, atol=2e-4),
            f"f32 decode vs forward: max diff {d_dec}")
    print(f"[lm] {cfg2.n_layers} layers at full width, f32: flash vs "
          f"use_flash=False max |dlogit| {d32:.3e} (max |logit| {top:.3f}, "
          f"limit 1e-3 of it); teacher-forced decode_step vs forward over "
          f"{DECODE_CHECK_LEN} positions max diff {d_dec:.3e} (rtol 2e-3, "
          "atol 2e-4)")
    del model, fwd32, dec, state, steps, toks
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
    for name in ("xtx", "countmin", "segment_linregr", "segment_countmin"):
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
    counters = Counters({"xtx": xtx_ops, "segment_linregr": sf_ops,
                         "countmin": cm_ops, "segment_countmin": sf_ops,
                         "segment_fm": sf_ops, "kmeans_assign": km_ops,
                         "flash_attention": fa_ops,
                         "flash_attention_tc": fa_ops,
                         "flash_attention_ffma": fa_ops})

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
                "kmeans_assign", "segment_partial", "segment_reduce"):
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
        require(events == [("countmin", "cuda"), ("xtx", "cuda")],
                f"session batch: trace kernel events {events}")
        require(launched["xtx"] > 0 and launched["countmin"] > 0,
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
    # Operations the function needs: X^T X is symmetric, so only its
    # k (k + 1) / 2 distinct entries, plus X^T y (and, per group, y^2),
    # each a multiply and an add per row; sum(y) and n one add per row.
    # The sketches need PIPE_OPS_PER_HASH integer instructions per valid
    # row and hash, on the slowest pipe (int_ops_seconds).  Bytes: each
    # input read once, each output written once.
    specs = (
        ("xtx", "src/repro_torch/csrc/xtx.cu",
         "src/repro/kernels/xtx/kernel.py:29",
         lambda: xtx_ops.xtx_xty(x, y), lambda: xtx_xty_ref(x, y),
         lambda: torch.matmul(x.T, x),
         float(N_MAIN) * K_MAIN * (K_MAIN + 3) / PEAK_F32_FLOPS,
         4.0 * (N_MAIN * (K_MAIN + 1) + K_MAIN * (K_MAIN + 1)), 5, 2,
         [N_MAIN, K_MAIN], ("xtx_upper_kernel", "xtx_reduce_kernel")),
        ("segment_linregr", "src/repro_torch/csrc/segment_linregr.cu",
         "src/repro/kernels/segment_fold/kernel.py:52",
         lambda: sf_ops.segment_linregr(xs, ys, valid, bgids,
                                        num_groups=G_MAIN),
         lambda: segment_linregr_ref(xs, ys, valid, bgids,
                                     num_groups=G_MAIN),
         None,
         float(n_valid) * ((K_MAIN + 1) * (K_MAIN + 2) + 2) / PEAK_F32_FLOPS,
         4.0 * n2 * (K_MAIN + 1) + n2 + 4.0 * nb
         + 4.0 * G_MAIN * (K_MAIN * (K_MAIN + 1) + 3), 5, 2,
         [n2, K_MAIN, nb, G_MAIN],
         ("segment_partial_kernel", "segment_reduce_kernel")),
        ("countmin", "src/repro_torch/csrc/countmin.cu",
         "src/repro/kernels/countmin/kernel.py:34",
         lambda: cm_ops.countmin_block(items, all_rows, 4, 1024),
         lambda: countmin_block_ref(items, all_rows, 4, 1024), None,
         int_ops_seconds("countmin", float(N_MAIN) * 4, sms, clock_hz),
         5.0 * N_MAIN + 4.0 * 4 * 1024, 20, 1, [N_MAIN, 4, 1024],
         ("countmin_kernel",)),
        ("segment_countmin", "src/repro_torch/csrc/segment_sketch.cu",
         "src/repro/kernels/segment_fold/kernel.py:125",
         lambda: sf_ops.segment_countmin(sk_items, sk_valid, sk_bgids,
                                         **cm_kw),
         lambda: segment_countmin_ref(sk_items, sk_valid, sk_bgids, **cm_kw),
         None,
         int_ops_seconds("segment_countmin", float(sk_valid_n) * 4, sms,
                         clock_hz),
         5.0 * sk_n2 + 4.0 * sk_nb + 4.0 * G_MAIN * 4 * 1024, 20, 1,
         [sk_n2, sk_nb, G_MAIN, 4, 1024], ("segment_countmin_kernel",)),
        ("segment_fm", "src/repro_torch/csrc/segment_sketch.cu",
         "src/repro/kernels/segment_fold/kernel.py:180",
         lambda: sf_ops.segment_fm(sk_items, sk_valid, sk_bgids, **fm_kw),
         lambda: segment_fm_ref(sk_items, sk_valid, sk_bgids, **fm_kw),
         None,
         int_ops_seconds("segment_fm", float(sk_valid_n) * 8, sms,
                         clock_hz),
         5.0 * sk_n2 + 4.0 * sk_nb + 4.0 * G_MAIN * 8 * 32, 20, 1,
         [sk_n2, sk_nb, G_MAIN, 8, 32], ("segment_fm_kernel",)),
        # a multiply and an add per row, centroid and feature; x and the
        # mask in, assign and mind out, the centroids in and the sums out
        ("kmeans_assign", "src/repro_torch/csrc/kmeans_assign.cu",
         "src/repro/kernels/kmeans_assign/kernel.py:26",
         lambda: km_ops.assign_and_reduce(bx, km_cents, ones),
         lambda: assign_and_reduce_ref(bx, km_cents, ones), None,
         2.0 * N_MAIN * K_KM * D_KM / PEAK_F32_FLOPS,
         4.0 * N_MAIN * D_KM + 12.0 * N_MAIN + 8.0 * K_KM * D_KM, 20, 2,
         [N_MAIN, D_KM, K_KM],
         ("kmeans_assign_kernel", "kmeans_reduce_kernel")),
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
    g_ops = 2.0 * n_g * K_KM_GROUPED * D_KM / PEAK_F32_FLOPS * 1e3
    g_bytes = (4.0 * n_g * D_KM + 12.0 * n_g
               + 8.0 * K_KM_GROUPED * D_KM) / PEAK_BYTES * 1e3
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
    for row in rows:
        name = row["name"]
        row["launches"] = counters.total[name]
        by_step = {f"{kind} {step}": got[name]
                   for kind, st in (("server", steps), ("stream", i_steps),
                                    ("methods", j_steps))
                   for step, got in st.items() if got.get(name)}
        if by_step:
            row["launches_by_shape"] = {
                **row.get("launches_by_shape",
                          {"phases a-f (main path)": before[name]}),
                **by_step}
            print(json.dumps({"kernel_launches": {
                "name": name, "launches": row["launches"],
                "launches_by_shape": row["launches_by_shape"]}}))
    gc.collect()
    torch.cuda.empty_cache()

    # g. the LM path, once the analytics tables are dropped
    print(f"[lm] memory held after dropping the analytics tables: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    row = lm_section(torch, dev, counters, errs)
    print(json.dumps({"kernel": row}))
    rows.append(row)

    # 6. summary ------------------------------------------------------------
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
