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
   the sketch kernels bitwise on any items (integer counts);
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
   path's shapes, beside the bound;
g. then, with the analytics tables dropped, the LM serving path:
   the flash_attention kernel against its plain version (f32 at the
   reference's test shapes and a ragged S, bf16 at qwen3-8b's layer
   shape, causality); the prefill forward of qwen3-8b at full width and
   depth (bf16, weights drawn on the card from a seed, 2 x 4096 tokens)
   through flash_attention, one launch per layer, against the
   ``use_flash=False`` path; two full-width layers in f32, where the two
   agree within 1e-3 and teacher-forced decode reproduces the forward;
   ``serve("qwen3-8b", reduced=False)``; the kernel's timing at
   (2, 32, 8, 4096, 128) and at prefill_32k's (1, 32, 8, 32768, 128)
   beside its bound, the plain version and scaled_dot_product_attention.

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
# bf16: both compute in f32 from the same bf16 inputs and round the output
# to bf16 once, so they may differ by one bf16 step (8 significant bits):
# 2^-7 x max |plain|
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
        got = {name: getattr(mod, attr)
               for name, (mod, attr) in self.where.items()}
        for name, n in got.items():
            self.total[name] += n
        return got


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


def flash_ptxas(lines: list[str]) -> list[str]:
    """ptxas' lines (registers, spills) for the flash_attention entries."""
    out, keep = [], False
    for line in lines:
        if "Compiling entry" in line:
            keep = "flash_attention" in line
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

    def qkv(b, hq, hk, s, d, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d))]

    # the kernel against its plain version: f32 at the reference's test
    # shapes and a ragged S; bf16 at qwen3-8b's layer shape; causality
    err = 0.0
    for b, hq, hk, s, d, causal in FLASH_F32_SHAPES:
        q, k, v = qkv(b, hq, hk, s, d)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        require(e <= FLASH_F32_ATOL,
                f"flash_attention f32 {(b, hq, hk, s, d, causal)}: "
                f"max |kernel - plain| {e} > {FLASH_F32_ATOL}")
        err = max(err, e)
        print(f"[lm] flash_attention f32 (B, Hq, Hk, S, D) = "
              f"{(b, hq, hk, s, d)}, causal {causal}: max |kernel - plain| "
              f"{e:.3e}")
    q, k, v = qkv(*FLASH_MAIN, torch.bfloat16)
    got = fa_ops.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    e = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    require(e <= FLASH_BF16_RTOL * scale, f"flash_attention bf16 "
            f"{FLASH_MAIN}: max |kernel - plain| {e} > 2^-7 x {scale}")
    del want
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v)]
    require(torch.equal(fa_ops.flash_attention(*strided), got),
            "flash_attention: (B, S, H, D) strides change the result")
    print(f"[lm] flash_attention bf16 {FLASH_MAIN}: max |kernel - plain| "
          f"{e:.3e} (max |plain| {scale:.3e}; limit 2^-7 of it); the same "
          f"bits from (B, S, H, D) storage through its strides")
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
    print("[lm] flash_attention causality: keys and values from position "
          "40 on moved, outputs before 40 bitwise the same")
    errs["flash_attention"] = err
    torch.cuda.empty_cache()

    # timing, before the forward's profile: the main path's layer shape
    # and prefill_32k's sequence
    out = {}
    for shape, reps in ((FLASH_MAIN, 10), (FLASH_LONG, 2)):
        q, k, v = qkv(*shape, torch.bfloat16)
        t_ops, t_bytes = flash_bound_ms(*shape)
        ms = cuda_ms(torch, lambda: fa_ops.flash_attention(q, k, v), reps)
        dev_ms = device_ms(torch, lambda: fa_ops.flash_attention(q, k, v),
                           1, ("flash_attention_kernel",))
        plain_ms = (cuda_ms(torch, lambda: flash_attention_ref(q, k, v), 2)
                    if shape == FLASH_MAIN else None)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps)
        out[shape] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "ops_ms": t_ops,
                      "bytes_ms": t_bytes}
        plain_txt = (f"{plain_ms:.3f} ms" if plain_ms is not None else
                     "not run (its (S, S) f32 scores take "
                     f"{4.0 * shape[0] * shape[1] * shape[3] ** 2 / 1e9:.0f}"
                     " GB)")
        print(f"[timing] flash_attention {shape} bf16 causal: {ms:.3f} ms "
              f"(CUDA events), device {dev_ms} ms; bound "
              f"{max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f}, bytes "
              f"{t_bytes:.4f}); plain {plain_txt}; "
              f"scaled_dot_product_attention {lib_ms:.3f} ms")
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
    require(launched["flash_attention"] == cfg.n_layers,
            f"forward: {launched['flash_attention']} flash_attention "
            f"launches, want {cfg.n_layers} (one per layer)")
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
    flash_dev = device_ms(torch, fwd, 1, ("flash_attention_kernel",))
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
    logits, _ = M.forward(model, toks)
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
            "source": "src/repro_torch/csrc/flash_attention.cu",
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
                         "flash_attention": fa_ops})

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
    flash_lines = flash_ptxas(_build.last_build["ptxas"])
    require(bool(flash_lines), "build: no ptxas lines for flash_attention")
    for line in flash_lines:
        print(f"[build] flash_attention: {line}")
    _build.lib()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for src in ("countmin", "segment_sketch"):
        for fn, mix in sass_mix(cuobjdump,
                                _build.BUILD_DIR / f"{src}.o").items():
            print(f"[build] SASS {fn}: " + ", ".join(
                f"{op} {n}" for op, n in mix.items() if n))

    # 3. kernels against their plain versions -------------------------------
    errs: dict[str, float] = {}
    for n, k in ((4096, 7), (1_000_000, 80), (N_MAIN, K_MAIN)):
        x = dyadic(torch, gen, (n, k), dev)
        y = dyadic(torch, gen, (n,), dev)
        got = dict(zip(("xtx", "xty"), xtx_ops.xtx_xty(x, y)))
        want = dict(zip(("xtx", "xty"), xtx_xty_ref(x, y)))
        torch.cuda.synchronize()
        require(all(torch.equal(got[q], want[q]) for q in want),
                f"xtx ({n}, {k}) dyadic: not bitwise equal "
                f"(max err {max_err(torch, got, want)[0]})")
        x = torch.randn((n, k), generator=gen, device=dev)
        y = torch.randn((n,), generator=gen, device=dev)
        got = dict(zip(("xtx", "xty"), xtx_ops.xtx_xty(x, y)))
        plain = dict(zip(("xtx", "xty"), xtx_xty_ref(x, y)))
        x64 = x.double()
        exact = {"xtx": x64.T @ x64, "xty": x64.T @ y.double()}
        del x64
        errs["xtx"] = gauss_check(torch, f"xtx ({n}, {k})", got, plain,
                                  exact)
        print(f"[kernels] xtx ({n}, {k}): dyadic bitwise")
        del x, y, got, plain, exact

    def segment_layout(cols, num_groups, used, sentinels, base=None):
        """A real aligned_blocks layout: ids 0..used-1 only (the rest are
        empty groups), padded by pad_blocks_to with ``sentinels`` blocks."""
        n = next(iter(cols.values())).shape[0]
        g = torch.randint(0, used, (n,), generator=gen, dtype=torch.int32,
                          device=dev)
        view = Table({**cols, "g": g}).group_by("g", num_groups)
        real = int((-(-view.counts.long() // 4096)).sum())
        pbase = None if base is None else view.permute(base)
        out, valid, bgids = view.aligned_blocks(
            4096, pbase, pad_blocks_to=real + sentinels)
        require(int((bgids == num_groups).sum()) == sentinels,
                "sentinel blocks")
        return out, valid, bgids

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
            require(all(torch.equal(got[q], want[q]) for q in want),
                    "segment_linregr dyadic: not bitwise equal (max err "
                    f"{max_err(torch, got, want)[0]})")
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

    def sketch_items(n):
        keys = zipf[:n].clone()
        wide = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)
        u = torch.rand((n,), generator=gen, device=dev)
        keys = torch.where(u < 0.1, wide, keys)
        keys = torch.where((u >= 0.1) & (u < 0.3), -keys, keys)
        mask = torch.rand((n,), generator=gen, device=dev) < 0.9
        return keys, mask

    errs.update(countmin=0.0, segment_countmin=0.0, segment_fm=0.0)
    # widths of a power of two take the AND path, 1000 the division path
    for n, depth, width in ((4096, 4, 1024), (1_000_000, 8, 4096),
                            (1_000_000, 3, 1000), (N_MAIN, 4, 1024)):
        items, mask = sketch_items(n)
        require(bool((items < 0).any()), "negative items present")
        got = cm_ops.countmin_block(items, mask, depth, width)
        want = countmin_block_ref(items, mask, depth, width)
        errs["countmin"] = max(errs["countmin"], bitwise(
            torch, f"countmin ({n}, {depth}, {width})", got, want))
        require(int(got.sum()) == depth * int(mask.sum()),
                "countmin: counts do not add up to depth x valid rows")
        print(f"[kernels] countmin ({n}, depth {depth}, width {width}), "
              f"negative items and a ragged mask: bitwise")
    items, mask = sketch_items(N_MAIN)
    cols, valid, bgids = segment_layout({"item": items}, G_MAIN, G_MAIN - 8,
                                        5, base=mask)
    seg_items = cols["item"]
    del cols, items, mask
    checks = [("segment_countmin", sf_ops.segment_countmin,
               segment_countmin_ref, {"depth": depth, "width": width})
              for depth, width in ((4, 1024), (3, 1000))]
    checks += [("segment_fm", sf_ops.segment_fm, segment_fm_ref,
                {"num_hashes": 8, "bits": bits}) for bits in (16, 32)]
    for name, kern, plain, kw in checks:
        got = kern(seg_items, valid, bgids, num_groups=G_MAIN, **kw)
        want = plain(seg_items, valid, bgids, num_groups=G_MAIN, **kw)
        errs[name] = max(errs[name], bitwise(torch, f"{name} {kw}", got,
                                             want))
        require(int(got[G_MAIN - 8:].abs().sum()) == 0,
                f"{name}: empty groups not zero")
        require(int(got[:G_MAIN - 8].sum()) > 0, f"{name}: nothing counted")
        print(f"[kernels] {name} {kw}: {seg_items.shape[0]} rows, "
              f"{bgids.shape[0]} blocks, G={G_MAIN} with 8 empty groups and "
              "5 sentinel blocks: bitwise")
    del seg_items, valid, bgids, got, want
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
         [N_MAIN, K_MAIN], ("xtx_partial_kernel", "xtx_reduce_kernel")),
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
         ("countmin_shared_kernel", "countmin_global_kernel")),
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
               "shape": shape}
        print(json.dumps({"kernel": row}))
        rows.append(row)

    # g. the LM path, once the analytics tables of a-f are dropped
    del (t, cols, valid, bgids, sk_cols, sk_valid, sk_bgids, bx, blobs, bg,
         view, x, y, xs, ys, items, all_rows, sk_items, ones, specs, results,
         km, km_kern, plain_fit, km_cents, t1, fg, kg, plain_g, two, fused1,
         kern1)
    gc.collect()
    torch.cuda.empty_cache()
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
