#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure ends the run with a non-zero exit:

1. device  — the card's name, count and power limit (fails without CUDA);
2. build   — the CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
   with ptxas' registers and spills;
3. kernels — each kernel against its plain PyTorch version on the card:
   bitwise on dyadic data, within a stated tolerance on Gaussian data;
4. main path — ``linregr`` and ``linregr_grouped`` on a 10,000,000-row,
   160-variable f32 table made on the card from a seed, through the
   kernels (launch counters and trace events checked), against the same
   statements on the plain versions and against the CPU port on a small
   input; then the grouped statement's stages timed one by one;
5. timing  — CUDA-event times of each kernel, its plain version and the
   library call at the main path's shapes, beside the bound.

The last line is ``{"ok": true, "device": {...}}``.  Imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20121208
N_MAIN, K_MAIN, G_MAIN = 10_000_000, 160, 64
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Gaussian data: the kernel sums in another order than cuBLAS or the
# block loop, so the two differ by the f32 rounding of sums over up to
# 1e7 rows.  Both are held against a float64 sum of the same inputs: the
# kernel's max error may exceed neither twice the plain version's nor
# GAUSS_RTOL * max|float64 sum|, whichever is larger.
GAUSS_RTOL = 1e-5


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def dyadic(torch, gen, shape, dev):
    """Values in {-1/8, 0, 1/8}: every partial sum of up to 1e7 products
    is a multiple of 1/64 below 2^18 in magnitude, exact in f32, so any
    summation order gives the same bits."""
    return torch.randint(-1, 2, shape, generator=gen, dtype=torch.int8,
                         device=dev).float() / 8


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import trace_execution
    from repro_torch.core.aggregates import (
        probe_segment_ops, segment_block_size, segment_fold)
    from repro_torch.core.table import Table, synthetic_regression_table
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_fold import ops as sf_ops
    from repro_torch.kernels.segment_fold.ref import segment_linregr_ref
    from repro_torch.kernels.xtx import ops as xtx_ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref
    from repro_torch.methods.linregr import (
        LinregrAggregate, linregr, linregr_grouped)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # 1. device -------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)

    # 2. build --------------------------------------------------------------
    _build.build(force=True)
    print(f"[build] {_build.last_build['seconds']:.1f} s -> {_build.LIB_PATH}")
    for line in _build.last_build["ptxas"]:
        print(f"[build] {line}")
    _build.lib()

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

    def segment_layout(x, y, num_groups, used, sentinels):
        """A real aligned_blocks layout: ids 0..used-1 only (the rest are
        empty groups), padded by pad_blocks_to with ``sentinels`` blocks."""
        g = torch.randint(0, used, (x.shape[0],), generator=gen,
                          dtype=torch.int32, device=dev)
        view = Table({"x": x, "y": y, "g": g}).group_by("g", num_groups)
        real = int((-(-view.counts.long() // 4096)).sum())
        cols, valid, bgids = view.aligned_blocks(
            4096, pad_blocks_to=real + sentinels)
        return cols["x"], cols["y"], valid, bgids

    for label, make in (("dyadic", dyadic),
                        ("gaussian", lambda t, g_, s, d: torch.randn(
                            s, generator=g_, device=d))):
        x = make(torch, gen, (N_MAIN, K_MAIN), dev)
        y = make(torch, gen, (N_MAIN,), dev)
        xs, ys, valid, bgids = segment_layout(x, y, G_MAIN, G_MAIN - 8, 5)
        del x, y
        require(int((bgids == G_MAIN).sum()) == 5, "sentinel blocks")
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

    # 4. main path ----------------------------------------------------------
    t, b_true = synthetic_regression_table(SEED, N_MAIN, K_MAIN)
    t = t.with_column("g", torch.randint(0, G_MAIN, (N_MAIN,), generator=gen,
                                         dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    seconds = {}
    results = {}
    for name, stmt, counter_mod, counter in (
            ("linregr", lambda: linregr(t, use_kernel=True), xtx_ops,
             "xtx_launches"),
            ("linregr_grouped",
             lambda: linregr_grouped(t, "g", num_groups=G_MAIN,
                                     use_kernel=True),
             sf_ops, "segment_linregr_launches")):
        # twice: the first run pays the partitioning sort and the host
        # index build of the layout (memoized after), the second does not
        xtx_ops.xtx_launches = 0
        sf_ops.segment_linregr_launches = 0
        with trace_execution() as tr:
            seconds[name] = []
            for _ in range(2):
                t0 = time.perf_counter()
                results[name] = stmt()
                torch.cuda.synchronize()
                seconds[name].append(time.perf_counter() - t0)
        launches[name] = getattr(counter_mod, counter)
        engines = [e.engine for e in tr.kernels]
        require(launches[name] > 0, f"{name}: {counter} did not rise")
        require(engines and all(e == "cuda" for e in engines),
                f"{name}: trace kernel events {engines}")
        print(f"[main] {name}: first {seconds[name][0]:.3f} s, again "
              f"{seconds[name][1]:.3f} s (host clock, synchronized); "
              f"{counter}={launches[name]}, trace kernel events {engines}, "
              f"sorts {len(tr.sorts)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] max_memory_allocated {peak_gb:.2f} GB")

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

    # small input: the card's kernel path against the CPU port
    small, _ = synthetic_regression_table(SEED + 1, 4096, 7, device="cpu")
    small = small.with_column("g", torch.arange(4096, dtype=torch.int32) % 5)
    small_gpu = Table({k: v.to(dev) for k, v in small.columns.items()})
    for name, fn in (("linregr", lambda tb, uk: linregr(tb, use_kernel=uk)),
                     ("linregr_grouped", lambda tb, uk: linregr_grouped(
                         tb, "g", num_groups=5, use_kernel=uk))):
        got = fn(small_gpu, True).coef.cpu()
        want = fn(small, False).coef
        require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                f"{name} small: card vs CPU differ by "
                f"{float((got - want).abs().max())}")
    print("[main] small input: card kernels agree with the CPU port")

    # the repeated grouped statement, stage by stage: the same calls that
    # run_grouped makes, each ended by synchronize() (host clock)
    def staged(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    agg = LinregrAggregate(use_kernel=True)
    stage_s = {}
    view, stage_s["group_by (memo hit)"] = staged(
        lambda: t.group_by("g", G_MAIN).select("x", "y"))
    bs = segment_block_size(view.n_rows, G_MAIN)
    (cols, valid, bgids), stage_s["aligned_blocks"] = staged(
        lambda: view.aligned_blocks(bs))
    ops = probe_segment_ops(agg, dict(view.table.columns))
    states, stage_s["segment_fold (kernel)"] = staged(
        lambda: segment_fold(agg, ops, cols, valid, bgids, G_MAIN,
                             kernel_impl="cuda"))
    _, stage_s["final_grouped"] = staged(lambda: agg.final_grouped(states))
    stage_s["rest of the statement"] = (seconds["linregr_grouped"][1]
                                        - sum(stage_s.values()))
    print("[breakdown] linregr_grouped, repeated call "
          f"{seconds['linregr_grouped'][1]:.4f} s (host clock, "
          "synchronized): " + "; ".join(f"{k} {v:.4f} s"
                                        for k, v in stage_s.items()))
    del states

    # 5. timing at the main path's shapes -----------------------------------
    x, y = t["x"], t["y"]
    xs, ys = cols["x"], cols["y"]
    n2, nb = xs.shape[0], bgids.shape[0]
    n_valid = int(valid.sum())
    # Operations the function needs: X^T X is symmetric, so only its
    # k (k + 1) / 2 distinct entries, plus X^T y (and, per group, y^2),
    # each a multiply and an add per row; sum(y) and n one add per row.
    rows = []
    specs = (
        ("xtx", "src/repro_torch/csrc/xtx.cu",
         "src/repro/kernels/xtx/kernel.py:29",
         lambda: xtx_ops.xtx_xty(x, y), lambda: xtx_xty_ref(x, y),
         lambda: torch.matmul(x.T, x),
         float(N_MAIN) * K_MAIN * (K_MAIN + 3),
         4.0 * (N_MAIN * (K_MAIN + 1) + K_MAIN * (K_MAIN + 1)), 5),
        ("segment_linregr", "src/repro_torch/csrc/segment_linregr.cu",
         "src/repro/kernels/segment_fold/kernel.py:52",
         lambda: sf_ops.segment_linregr(xs, ys, valid, bgids,
                                        num_groups=G_MAIN),
         lambda: segment_linregr_ref(xs, ys, valid, bgids,
                                     num_groups=G_MAIN),
         None,
         float(n_valid) * ((K_MAIN + 1) * (K_MAIN + 2) + 2),
         4.0 * n2 * (K_MAIN + 1) + n2 + 4.0 * nb
         + 4.0 * G_MAIN * (K_MAIN * (K_MAIN + 1) + 3), 5),
    )
    for name, source, replaces, kern, plain, lib, flops, nbytes, reps in specs:
        ms = cuda_ms(torch, kern, reps)
        plain_ms = cuda_ms(torch, plain, 2)
        lib_ms = cuda_ms(torch, lib, reps) if lib is not None else None
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[
                   "linregr" if name == "xtx" else "linregr_grouped"],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": lib_ms, "launches_per_call": 2,
               "shape": ([N_MAIN, K_MAIN] if name == "xtx"
                         else [n2, K_MAIN, nb, G_MAIN])}
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
