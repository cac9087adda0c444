#!/usr/bin/env python3
"""Where a kernel's time goes: time variants of it with one phase cut out.

    python3 tools/kernel_split.py                 # this checkout
    python3 tools/kernel_split.py --root DIR      # another checkout
    python3 tools/kernel_split.py --only countmin,segment_countmin \
        --variants full                           # some kernels, variants
    python3 tools/kernel_split.py --only flash_attention_bwd

For ``kmeans_assign`` (at the main path's (10M, 32, 64) and the grouped
launch's (156,250, 32, 8)), ``segment_linregr`` (10.2M rows, K = 160,
G = 64), ``countmin`` (10M Zipf(1.1) items, every row valid, depth 4,
width 1024) and ``segment_countmin`` (the same items grouped by 64
uniform ids into aligned_blocks' layout), each variant is a copy of
``src/repro_torch/csrc`` under ``build/split/<variant>/`` whose source
has a phase switched off by a text edit and a ``-D`` flag, built by nvcc
into a library of its own.  Each is timed by CUDA events on the same
inputs as the full kernel; the Count-Min variants also by torch.profiler
(device time of the kernel alone) and with the L2 flushed before each
launch.  The variants compute wrong results: they only split the time.
The port's sources are not changed.  ``--root`` points at another
checkout of the port (say the parent commit, from ``git archive``): its
sources, and its wrappers' sizing, are used; each kernel takes the first
edit set whose anchors all occur in its source, and is skipped when none
does.  ``flash_attention_bwd`` needs no variant: one wrapper call launches
its three kernels (tensor cores in bf16, FFMA in f32), and
torch.profiler gives each one's device time (run
it in a process of its own, before other work: inside chip_smoke.py's
process the profiler records no device time for the ctypes library's
launches).  Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "split"

# (file, text, text with the phase behind a 0/1 macro)
KMEANS_EDITS = [
    ("kmeans_assign.cu",
     "for (int ra = next_row(); ra >= 0; ra = next_row()) {",
     "for (int ra = SPLIT_OWNER ? next_row() : -1; ra >= 0; "
     "ra = next_row()) {"),
    ("kmeans_assign.cu", "if (key[r] >= 0) atomicOr(",
     "if (SPLIT_MATCH && key[r] >= 0) atomicOr("),
    ("kmeans_assign.cu", "if (next < tiles)",
     "if (SPLIT_STAGE && next < tiles)"),
    ("kmeans_assign.cu", "for (int q = 0; q < dq4; ++q) {",
     "for (int q = 0; q < (SPLIT_FFMA ? dq4 : 0); ++q) {"),
]
# the design before the bitmap scatter: its per-row scatter loop takes
# SPLIT_OWNER, its synchronous staging of later tiles SPLIT_STAGE
KMEANS_EDITS_SERIAL_SCATTER = [
    ("kmeans_assign.cu", "for (int r0 = 0; r0 < TILE_ROWS; r0 += 32) {",
     "for (int r0 = 0; r0 < (SPLIT_OWNER ? TILE_ROWS : 0); r0 += 32) {"),
    ("kmeans_assign.cu", "if (nchunks > 1 || k0 == 0) {",
     "if ((nchunks > 1 || k0 == 0) && (SPLIT_STAGE || tile == blockIdx.x)) {"),
    ("kmeans_assign.cu", "for (int q = 0; q < dn; ++q) {",
     "for (int q = 0; q < (SPLIT_FFMA ? dn : 0); ++q) {"),
]
# variant: (SPLIT_OWNER, SPLIT_MATCH, SPLIT_STAGE, SPLIT_FFMA)
KMEANS_VARIANTS = {
    "full": (1, 1, 1, 1), "no_owner_sums": (0, 1, 1, 1),
    "no_scatter": (0, 0, 1, 1), "no_stage": (1, 1, 0, 1),
    "no_scatter_no_stage": (0, 0, 0, 1), "staging_and_frame": (0, 0, 1, 0),
    "frame": (0, 0, 0, 0),
}
SEGMENT_EDITS = [
    ("gram_upper.cuh", "if (valid != nullptr) mask(c + 1);",
     "if (SPLIT_MASK && valid != nullptr) mask(c + 1);"),
]
SEGMENT_VARIANTS = {"full": (1,), "no_mask_pass": (0,)}
# Count-Min (countmin.cu, and segment_sketch.cu's segment_countmin): the
# row loop (SPLIT_ROWS), the hash (SPLIT_HASH: cut, the item stands in for
# it), the shared atomics (SPLIT_ATOMIC: cut, a store under an unlikely
# hash keeps the loads and the hash alive) and the clear and flush
# (SPLIT_FLUSH; with the rows cut the flush adds every counter, as if all
# were nonzero).  The first edits of each set are the bucket code shared
# by both kernels.
_CM_BUCKET = [
    ("sketch_hash.cuh", "const uint32_t h = sketch_hash(x, d);",
     "const uint32_t h = SPLIT_HASH ? sketch_hash(x, d) : x + d;"),
    ("sketch_hash.cuh",
     "atomicAdd(&hist[d * width + (pow2 ? h & (width - 1u) : h % width)], 1);",
     "if (SPLIT_ATOMIC) atomicAdd(&hist[d * width + (pow2 ? h & "
     "(width - 1u) : h % width)], 1); else if (h == 0x2545F491u) "
     "hist[d] = (int)x;"),
]
# the design with one CTA per 256 rows' stride (countmin) or per block
# (segment_countmin), each clearing and flushing its own histogram
COUNTMIN_EDITS_PER_CTA = _CM_BUCKET + [
    ("countmin.cu", "if (mask[r]) countmin_add(hist,",
     "if (SPLIT_ROWS && mask[r]) countmin_add(hist,"),
    ("countmin.cu",
     "for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;",
     "for (int i = threadIdx.x; i < (SPLIT_FLUSH ? cells : 0); "
     "i += blockDim.x) hist[i] = 0;"),
    ("countmin.cu", "if (c) atomicAdd(&out[i], c);",
     "if (SPLIT_FLUSH && (c || !SPLIT_ROWS)) atomicAdd(&out[i], c);"),
]
SEGCM_EDITS_PER_BLOCK = _CM_BUCKET + [
    ("segment_sketch.cu", "if (valid[base + r])",
     "if (SPLIT_ROWS && valid[base + r])"),
    ("segment_sketch.cu",
     "for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;",
     "for (int i = threadIdx.x; i < (SPLIT_FLUSH ? cells : 0); "
     "i += blockDim.x) hist[i] = 0;"),
    ("segment_sketch.cu", "if (c) atomicAdd(&slot[i], c);",
     "if (SPLIT_FLUSH && (c || !SPLIT_ROWS)) atomicAdd(&slot[i], c);"),
]
# the persistent design: CTAs over ranges of rows (countmin) or of blocks,
# flushed per run of one gid (segment_countmin), with the row loop (its
# hash and atomic in CountMinStage::add) and the flush in sketch_hash.cuh
_CM_RUNS = [
    ("sketch_hash.cuh", "const uint32_t h = fmix32(x1[r] * p);",
     "const uint32_t h = SPLIT_HASH ? fmix32(x1[r] * p) : x1[r] + d;"),
    ("sketch_hash.cuh", "if (kAllValid || v[r]) atomicAdd(row + b, 1);",
     "if (SPLIT_ATOMIC) { if (kAllValid || v[r]) atomicAdd(row + b, 1); } "
     "else if (h == 0x2545F491u) row[0] = (int)x1[r];"),
    ("sketch_hash.cuh", "if (c) atomicAdd(&dst[j], c);",
     "if (c || !SPLIT_ROWS) atomicAdd(&dst[j], c);"),
]
_CM_CLEAR = ("for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;",
             "for (int i = threadIdx.x; i < (SPLIT_FLUSH ? cells : 0); "
             "i += blockDim.x) hist[i] = 0;")
COUNTMIN_EDITS_RUNS = _CM_RUNS + [
    ("countmin.cu", "countmin_rows(hist, items, mask, r0, r1,",
     "if (SPLIT_ROWS) countmin_rows(hist, items, mask, r0, r1,"),
    ("countmin.cu", *_CM_CLEAR),
    ("countmin.cu", "countmin_flush(hist, cells, out);",
     "if (SPLIT_FLUSH) countmin_flush(hist, cells, out);"),
]
SEGCM_EDITS_RUNS = _CM_RUNS + [
    ("segment_sketch.cu", "countmin_rows(kShared ? hist : slot,",
     "if (SPLIT_ROWS) countmin_rows(kShared ? hist : slot,"),
    ("segment_sketch.cu", *_CM_CLEAR),
    ("segment_sketch.cu", "countmin_flush(hist, cells, slot);",
     "if (SPLIT_FLUSH) countmin_flush(hist, cells, slot);"),
]
# variant: (SPLIT_ROWS, SPLIT_HASH, SPLIT_ATOMIC, SPLIT_FLUSH)
CM_VARIANTS = {
    "full": (1, 1, 1, 1), "no_flush": (1, 1, 1, 0),
    "loads_and_hash": (1, 1, 0, 0), "loads_only": (1, 0, 0, 0),
    "clear_and_flush": (0, 1, 1, 1), "frame": (0, 0, 0, 0),
}
CM_FLAGS = ("SPLIT_ROWS", "SPLIT_HASH", "SPLIT_ATOMIC", "SPLIT_FLUSH")
SPLITS = ("kmeans_assign", "segment_linregr", "countmin", "segment_countmin",
          "flash_attention_bwd")
# (B, Hq, Hk, S, D, causal): stablelm-1.6b's training layer and qwen3-8b's
BWD_SPLIT_SHAPES = ((2, 32, 32, 4096, 64, True), (2, 32, 8, 4096, 128, True))


def flash_bwd_split(torch, ev, reps: int = 5) -> None:
    """The flash_attention backward's three kernels (rows, dK/dV, dQ; one
    wrapper call launches all three: the tensor-core ones in bf16, the
    FFMA ones in f32) split by torch.profiler's device time of each,
    beside CUDA events of the whole call, at BWD_SPLIT_SHAPES in bf16 and
    f32.  Uses the checkout's own wrapper and sources (a checkout whose
    backward takes no lse is called without it); no variant is built."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops as fa_ops
    if not hasattr(fa_ops, "flash_attention_bwd"):
        print("[split] flash_attention_bwd: skipped (not in this checkout)")
        return
    takes_lse = "lse" in inspect.signature(
        fa_ops.flash_attention_bwd).parameters
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20121208)
    for b, hq, hk, s, d, causal in BWD_SPLIT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            # (B, S, H, D) storage seen through transpose(1, 2), as the
            # model's projections give them
            q, k, v, do = [torch.randn((b, s, h, d), generator=gen,
                                       device=dev).to(dtype).transpose(1, 2)
                           for h in (hq, hk, hk, hq)]
            if takes_lse:
                o, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                                return_lse=True)
                extra = (lse,)
            else:
                o, extra = fa_ops.flash_attention(q, k, v,
                                                  causal=causal), ()

            def call():
                fa_ops.flash_attention_bwd(q, k, v, o, do, *extra,
                                           causal=causal)

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            parts = {}
            for e in prof.key_averages():
                for part in ("rows", "dkdv", "dq"):
                    if f"flash_bwd_{part}" in e.key:
                        parts[part] = parts.get(part, 0.0) + getattr(
                            e, "device_time_total", 0.0) / reps / 1e3
            split = (", ".join(f"{n} {t:.3f}" for n, t in parts.items())
                     + f" (sum {sum(parts.values()):.3f})" if parts
                     else "not measured")
            print(f"[split] flash_attention_bwd {(b, hq, hk, s, d)} "
                  f"{'bf16' if dtype == torch.bfloat16 else 'f32'} "
                  f"{'causal' if causal else 'non-causal'}: events "
                  f"{ev(call, reps):.3f} ms a call; device ms by kernel: "
                  f"{split}", flush=True)
            del q, k, v, do, o, extra


def edit_set(csrc: Path, sets):
    """The first edit set whose every anchor occurs once in csrc, or None."""
    for edits in sets:
        if all((csrc / f).exists() and (csrc / f).read_text().count(old) == 1
               for f, old, _new in edits):
            return edits
    return None


def build(csrc: Path, name: str, target: str, edits, flags: dict[str, int]):
    """Copy csrc, apply the edits, start nvcc; returns (lib path, proc)."""
    src = OUT / name
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(csrc, src)
    for fname, old, new in edits:
        path = src / fname
        path.write_text(path.read_text().replace(old, new))
    lib = src / "lib.so"
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,"
           "code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-I", str(src), *(f"-D{k}={v}" for k, v in flags.items()),
           str(src / target), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def zipf_items(torch, gen, n, dev, keys=1_000_000, s=1.1):
    """(n,) int32 keys in [0, keys), P(k) proportional to (k + 1)^-s, as
    chip_smoke.py draws the main path's ``item`` column."""
    w = torch.arange(1, keys + 1, dtype=torch.float64, device=dev) ** -s
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=dev)
    return torch.searchsorted(cdf, u).clamp_(max=keys - 1).to(torch.int32)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="checkout whose port is split (default: this one)")
    ap.add_argument("--only", default=",".join(SPLITS),
                    help="comma-separated kernels to split (default: all)")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to build, such as full "
                         "(default: every variant of each kernel)")
    args = ap.parse_args()
    root = args.root.resolve()
    only = set(args.only.split(","))
    if not only <= set(SPLITS):
        ap.error(f"--only takes some of {', '.join(SPLITS)}")
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    csrc = root / "src" / "repro_torch" / "csrc"
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.aggregates import segment_block_size
    from repro_torch.core.table import Table
    from repro_torch.kernels.countmin import ops as cm_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.segment_fold import ops as sf_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(f"[split] sources: {csrc}")
    # kernel: (edit set, prefix, source, variants, flags)
    plans = {
        "kmeans_assign": (
            edit_set(csrc, [KMEANS_EDITS, KMEANS_EDITS_SERIAL_SCATTER]),
            "km_", "kmeans_assign.cu", KMEANS_VARIANTS,
            ("SPLIT_OWNER", "SPLIT_MATCH", "SPLIT_STAGE", "SPLIT_FFMA")),
        "segment_linregr": (edit_set(csrc, [SEGMENT_EDITS]), "seg_",
                            "segment_linregr.cu", SEGMENT_VARIANTS,
                            ("SPLIT_MASK",)),
    }
    for kernel, prefix, target, sets in (
            ("countmin", "cm_", "countmin.cu",
             [COUNTMIN_EDITS_RUNS, COUNTMIN_EDITS_PER_CTA]),
            ("segment_countmin", "segcm_", "segment_sketch.cu",
             [SEGCM_EDITS_RUNS, SEGCM_EDITS_PER_BLOCK])):
        edits = edit_set(csrc, sets)
        plans[kernel] = (edits, prefix, target, CM_VARIANTS, CM_FLAGS)
    def ev(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    jobs = {}
    for kernel, (edits, prefix, target, variants, flags) in plans.items():
        if kernel not in only:
            continue
        print(f"[split] {kernel}: "
              f"{'edits found' if edits else 'skipped (no edit set)'}")
        for name, f in variants.items() if edits else ():
            if args.variants and name not in args.variants.split(","):
                continue
            jobs[f"{kernel} {name}"] = build(csrc, prefix + name, target,
                                             edits, dict(zip(flags, f)))
    if "flash_attention_bwd" in only:
        flash_bwd_split(torch, ev)
    libs = {}
    for key, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(lib))

    def device_ms(fn, reps):
        """Device time per call of the kernels (memsets left out), from
        torch.profiler; None when it records none."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if "kernel" in e.key)
        return us / reps / 1e3 if us > 0 else None

    def cold_ms(fn, reps, flush):
        """Event time of each launch alone, with ``flush`` (larger than
        the L2) written before it, so that the inputs arrive from HBM, and
        a sleep on the stream long enough that the host has enqueued the
        launch before the first event fires."""
        total = 0.0
        for i in range(reps):
            flush.fill_(i)
            torch.cuda._sleep(200_000)  # the host enqueues fn meanwhile
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20121208)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # blobs: 64 true centers N(0, 10^2), unit noise; centroids near them
    for n, d, k in ((10_000_000, 32, 64), (156_250, 32, 8)):
        if not any(key.startswith("kmeans_assign") for key in libs):
            break
        centers = torch.randn((k, d), generator=gen, device=dev) * 10.0
        lab = torch.randint(0, k, (n,), generator=gen, device=dev)
        x = centers[lab] + torch.randn((n, d), generator=gen, device=dev)
        c = centers + 0.1 * torch.randn((k, d), generator=gen, device=dev)
        m = torch.ones((n,), device=dev)
        splits = km_ops.splits_for(n, k, d, sms)
        # an older wrapper sized the scratch as the partial alone
        scratch = getattr(km_ops, "scratch_floats", lambda k, d: k * d + k)
        outs = [torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((n,), device=dev),
                torch.empty((splits, scratch(k, d)), device=dev),
                torch.empty((k, d), device=dev), torch.empty((k,), device=dev)]
        ptrs = [t.data_ptr() for t in (x, c, m, *outs)]
        reps = 20 if n > 1_000_000 else 200
        for key, lib in libs.items():
            if not key.startswith("kmeans_assign"):
                continue
            fn = lib.madlib_kmeans_assign
            fn.argtypes = [P] * 8 + [L, I, I, I, P]
            call = (lambda fn=fn: fn(*ptrs, n, d, k, splits, stream))
            print(f"[split] {key} ({n}, {d}, {k}), {splits} CTAs: "
                  f"{ev(call, reps):.4f} {ev(call, reps):.4f} ms")
        del x, c, m, outs, lab, centers

    N, K, G = 10_000_000, 160, 64
    if any(key.startswith("segment_linregr") for key in libs):
        x = torch.randn((N, K), generator=gen, device=dev)
        y = torch.randn((N,), generator=gen, device=dev)
        g = torch.randint(0, G, (N,), generator=gen, dtype=torch.int32,
                          device=dev)
        cols, valid, bgids = Table({"x": x, "y": y, "g": g}).group_by(
            "g", G).aligned_blocks(4096)
        del x, y, g
        nb, bs = bgids.shape[0], cols["x"].shape[0] // bgids.shape[0]
        spb, rows = sf_ops.block_splits(bs)
        w = K + 2
        partials = torch.empty((nb * spb, w * (w + 1) // 2), device=dev)
        outs = [torch.empty(s, device=dev) for s in
                ((G, K, K), (G, K), (G,), (G,), (G,))]
        ptrs = [t.data_ptr() for t in (cols["x"], cols["y"], valid, bgids,
                                       partials, *outs)]
        for key, lib in libs.items():
            if not key.startswith("segment_linregr"):
                continue
            fn = lib.madlib_segment_linregr
            fn.argtypes = [P] * 10 + [I] * 6 + [P]
            call = (lambda fn=fn: fn(*ptrs, nb, bs, K, G, spb, rows, stream))
            print(f"[split] {key} ({cols['x'].shape[0]}, {K}, {nb} blocks, "
                  f"G {G}): {ev(call, 5):.4f} {ev(call, 5):.4f} ms")
        del cols, valid, bgids, partials, outs, ptrs

    if not any("countmin" in key for key in libs):
        print(smi)
        return 0
    # the main path's Count-Min inputs: 10M Zipf(1.1) items, every row
    # valid (countmin); the same items grouped by 64 uniform ids into
    # aligned_blocks' layout (segment_countmin); depth 4, width 1024
    depth, width = 4, 1024
    items = zipf_items(torch, gen, N, dev)
    mask = torch.ones((N,), dtype=torch.bool, device=dev)
    g = torch.randint(0, G, (N,), generator=gen, dtype=torch.int32,
                      device=dev)
    cols, valid, bgids = Table({"item": items, "g": g}).group_by(
        "g", G).aligned_blocks(segment_block_size(N, G))
    seg_items = cols["item"]
    nb, bs = bgids.shape[0], seg_items.shape[0] // bgids.shape[0]
    cm_out = torch.empty((depth, width), dtype=torch.int32, device=dev)
    seg_out = torch.empty((G, depth, width), dtype=torch.int32, device=dev)
    flush = torch.empty((32 * 2 ** 20,), dtype=torch.float32, device=dev)
    # the wrapper's CTA sizing, where the checkout's wrapper has one
    rows_per_cta = getattr(cm_ops, "cta_rows", None)
    blocks_per_cta = getattr(sf_ops, "cta_blocks", None)
    cm_args = [items.data_ptr(), mask.data_ptr(), cm_out.data_ptr(), N,
               depth, width]
    cm_types = [P, P, P, L, I, I]
    if rows_per_cta is not None:
        cm_args.append(rows_per_cta(N, sms))
        cm_types.append(L)
    seg_args = [seg_items.data_ptr(), valid.data_ptr(), bgids.data_ptr(),
                seg_out.data_ptr(), nb, bs, depth, width, G]
    seg_types = [P, P, P, P, I, I, I, I, I]
    if blocks_per_cta is not None:
        seg_args.append(blocks_per_cta(nb, sms))
        seg_types.append(I)
    for key, lib in libs.items():
        if key.startswith("countmin"):
            fn, args, types = lib.madlib_countmin, cm_args, cm_types
            what = f"({N}, {depth}, {width})"
        elif key.startswith("segment_countmin"):
            fn, args, types = lib.madlib_segment_countmin, seg_args, \
                seg_types
            what = f"({seg_items.shape[0]} rows, {nb} blocks of {bs}, G {G}, " \
                f"{depth}, {width})"
        else:
            continue
        fn.argtypes = types + [P]
        call = (lambda fn=fn, args=args: fn(*args, stream))
        dms = device_ms(call, 20)
        print(f"[split] {key} {what}: events {ev(call, 20):.4f} "
              f"{ev(call, 20):.4f} ms, device "
              f"{'not measured' if dms is None else f'{dms:.4f}'} ms, "
              f"L2 cold {cold_ms(call, 10, flush):.4f} ms")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
