#!/usr/bin/env python3
"""What the program's spans cost on this host: per ``span()`` call, and
per statement.

    python3 tools/span_cost.py

Per call (median of 7 timings of 200,000 calls each, microseconds):

* ``call_off``: ``span(...)`` alone, with the profiler off;
* ``with_off``: a whole ``with span(...):`` block, the same way (the
  interpreter's own ``with`` on the no-op context included), and
  ``with_empty``: a ``with`` block on ``contextlib.nullcontext()`` with
  no ``span()`` call, for comparison;
* ``with_profiled``: the block while torch.profiler records the CPU
  (the ``madlib::`` range).

Per statement: ``linregr(use_kernel=True)`` and ``profile`` on a
256 x 8 table on the CPU in one thread (host work only), the median of
31 rounds of 200 statements, with the spans off and with ``span``
replaced by the no-op context in every module that calls it
(``none``); rounds of the two alternate.  Prints one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CALLERS = ("repro_torch.core.plan", "repro_torch.core.session",
           "repro_torch.core.aggregates", "repro_torch.kernels.registry")


def _per_call(fn, n=200_000, reps=7) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn(n)
        times.append((time.perf_counter() - t) / n * 1e6)
    return statistics.median(times)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Table
    from repro_torch.core import trace as trace_mod
    from repro_torch.methods.linregr import linregr
    from repro_torch.methods.profile import profile as mad_profile
    span = trace_mod.span
    empty = contextlib.nullcontext()

    def calls(n):
        for _ in range(n):
            span("fold")

    def blocks(n):
        for _ in range(n):
            with span("fold"):
                pass

    def empties(n):
        for _ in range(n):
            with empty:
                pass

    def loop(n):
        for _ in range(n):
            pass

    base = _per_call(loop)
    out = {"host": _host(), "torch": torch.__version__}
    out["call_off"] = _per_call(calls) - base
    out["with_off"] = _per_call(blocks) - base
    out["with_empty"] = _per_call(empties) - base
    with profile(activities=[ProfilerActivity.CPU]):
        out["with_profiled"] = _per_call(blocks, n=2_000, reps=5) - base

    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    tbl = Table({"x": torch.randn(256, 8, generator=g),
                 "y": torch.randn(256, generator=g)})
    statements = {"linregr": lambda: linregr(tbl, use_kernel=True),
                  "profile": lambda: mad_profile(tbl)}
    mods = [sys.modules[m] for m in CALLERS]
    real = [m.span for m in mods]
    off = (lambda name: trace_mod._OFF)

    def rounds(stmt, mode, k=200):
        if mode == "none":
            for m in mods:
                m.span = off
        try:
            t = time.perf_counter()
            for _ in range(k):
                stmt()
            return (time.perf_counter() - t) / k * 1e6
        finally:
            for m, s in zip(mods, real):
                m.span = s

    for name, stmt in statements.items():
        for _ in range(20):  # warm
            stmt()
        times = {"none": [], "off": []}
        for _ in range(31):
            for mode in times:
                times[mode].append(rounds(stmt, mode))
        med = {m: statistics.median(v) for m, v in times.items()}
        out[f"{name}_us"] = med
        out[f"{name}_off_minus_none_us"] = med["off"] - med["none"]
    print(json.dumps(out), flush=True)
    return 0


def _host() -> str:
    return f"{platform.machine()}, {os.cpu_count()} CPUs"


if __name__ == "__main__":
    sys.exit(main())
