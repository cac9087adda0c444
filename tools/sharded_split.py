#!/usr/bin/env python3
"""Where a sharded statement's time goes on one card.

    python3 tools/sharded_split.py                  # 24 segments, 3 reps
    python3 tools/sharded_split.py --segments 8 --reps 5

Builds chip_smoke.py section n's dyadic 10,000,000 x 160 table (``x``,
``y``, a Zipf ``item``) from the same seed on the card, pads it to a
multiple of ``--segments`` (its mask rides along) and distributes it over
that many segments of ``cuda:0``.  Then, for the local table and the
distributed one, the best of ``--reps`` host-clock times (synchronized)
of each member of section n's Session batch alone (profile of ``x`` and
``y``, linregr through ``xtx``, Count-Min through ``countmin``, FM) and of
the whole batch, and the batch's device time from torch.profiler's CUDA
activity (the sum of every kernel's self time; a run of its own, so the
ctypes library's launches are seen).  The host clock less the device
time is what the segments' host work adds.

Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--segments", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Session, Table, make_mesh, run_many
    from repro_torch.core.templates import ProfileAggregate
    from repro_torch.kernels import _build
    from repro_torch.methods.linregr import LinregrAggregate
    from repro_torch.methods.sketches import CountMinAggregate, FMAggregate

    if not torch.cuda.is_available():
        print("sharded_split: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 25)             # section n's draws, in order
    n, p = cs.N_MAIN, args.segments
    base = Table({"x": cs.dyadic(torch, gen, (n, cs.K_MAIN), dev),
                  "y": cs.dyadic(torch, gen, (n,), dev),
                  "item": cs.zipf_items(torch, gen, n, dev)})
    tbl, mask = base.pad_to(-(-n // p) * p)
    del base
    dist = tbl.distribute(make_mesh((p,), ("data",), devices=[dev] * p))
    members = (
        ("profile", ProfileAggregate, ("x", "y")),
        ("linregr", lambda: LinregrAggregate(use_kernel=True), ("x", "y")),
        ("countmin", lambda: CountMinAggregate(use_kernel=True),
         ("item",)),
        ("fm", FMAggregate, ("item",)))

    def batch(tb):
        s = Session()
        hs = [s.scan(make(), tb, columns=cols, mask=mask)
              for _, make, cols in members]
        s.run()
        return [h.result() for h in hs]

    def best(fn):
        fn()
        return min(cs.timed(torch, fn)[1] for _ in range(args.reps))

    def device_s(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages()) / 1e6

    smi = cs.nvidia_smi()
    row = {}
    for name, make, cols in members:
        for engine, tb in (("sharded", dist), ("local", tbl)):
            row[f"{name} {engine}"] = best(lambda: run_many(
                [make()], tb.select(*cols), mask=mask))
    for engine, tb in (("sharded", dist), ("local", tbl)):
        row[f"batch {engine}"] = best(lambda: batch(tb))
        row[f"batch {engine} device"] = device_s(lambda: batch(tb))
    print(f"[split] at {p} segments (seconds, best of {args.reps}): "
          + ", ".join(f"{k} {v:.5f}" for k, v in row.items()) + f"; {smi}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
