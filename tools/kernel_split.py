#!/usr/bin/env python3
"""Where a kernel's time goes: time variants of it with one phase cut out.

    python3 tools/kernel_split.py                 # this checkout
    python3 tools/kernel_split.py --root DIR      # another checkout

For ``kmeans_assign`` (at the main path's (10M, 32, 64) and the grouped
launch's (156,250, 32, 8)) and ``segment_linregr`` (10.2M rows, K = 160,
G = 64), each variant is a copy of ``src/repro_torch/csrc`` under
``build/split/<variant>/`` whose source has a phase switched off by a
text edit and a ``-D`` flag, built by nvcc into a library of its own.
Each is timed by CUDA events on the same inputs as the full kernel.  The
variants compute wrong results: they only split the time.  The port's
sources are not changed.  ``--root`` points at another checkout of the
port (say the parent commit, from ``git archive``): its sources, and its
wrappers' sizing, are used; each kernel takes the first edit set whose
anchors all occur in its source, and is skipped when none does.  Needs
an NVIDIA GPU with nvcc.
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


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="checkout whose port is split (default: this one)")
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    csrc = root / "src" / "repro_torch" / "csrc"
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.table import Table
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.segment_fold import ops as sf_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(f"[split] sources: {csrc}")
    jobs = {}
    km_edits = edit_set(csrc, [KMEANS_EDITS, KMEANS_EDITS_SERIAL_SCATTER])
    seg_edits = edit_set(csrc, [SEGMENT_EDITS])
    for name, f in KMEANS_VARIANTS.items() if km_edits else ():
        jobs["kmeans_assign " + name] = build(
            csrc, "km_" + name, "kmeans_assign.cu", km_edits,
            dict(zip(("SPLIT_OWNER", "SPLIT_MATCH", "SPLIT_STAGE",
                      "SPLIT_FFMA"), f)))
    for name, f in SEGMENT_VARIANTS.items() if seg_edits else ():
        jobs["segment_linregr " + name] = build(
            csrc, "seg_" + name, "segment_linregr.cu", seg_edits,
            {"SPLIT_MASK": f[0]})
    print(f"[split] kmeans_assign: {'edits found' if km_edits else 'skipped'}"
          f"; segment_linregr: {'edits found' if seg_edits else 'skipped'}")
    libs = {}
    for key, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(lib))

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

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20121208)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # blobs: 64 true centers N(0, 10^2), unit noise; centroids near them
    for n, d, k in ((10_000_000, 32, 64), (156_250, 32, 8)):
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
    if not seg_edits:
        print(smi)
        return 0

    N, K, G = 10_000_000, 160, 64
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
        print(f"[split] {key} ({cols['x'].shape[0]}, {K}, {nb} blocks, G "
              f"{G}): {ev(call, 5):.4f} {ev(call, 5):.4f} ms")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
