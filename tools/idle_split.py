#!/usr/bin/env python3
"""The device's idle time per statement in one traced benchmark run,
split four ways by the program's spans.

    python3 tools/idle_split.py --workload fig4-k160.linregr --seed 7 \
        --seconds 30

It runs the cell as ``bench/run.py --trace 1`` does (``run_cell``, in
this process) and prints one JSON line: the run's ``correct``, its
per-layer metrics, the traced statements per second, the idle ms per
statement that ``device_idle`` implies (window x idle share / statements
answered), the four parts of ``harness/program_spans.idle_by_layer`` in
ms per statement (``plan``, ``fold``, ``final`` and ``outside``, which
no metric reports) and their sum, the number of idle gaps between merged
device intervals, and the ``madlib::`` names among the breakdown's
device operations (there should be none).  On a checkout whose program has no
spans the parts are ``null``.  Run one seed a process, as the benchmark
does.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "bench"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("idle_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from harness import program_spans
    from harness.core import run_cell

    out = run_cell(args.workload, args.seed, args.seconds, True)
    split, gaps = program_spans.last_split()
    dev = out["device"]
    answered = out["attempted"] - out["failed"]
    implied = 1e3 * (dev["window_s"] - dev["busy_s"]) / answered
    parts = (None if split is None
             else {k: 1e3 * v / answered for k, v in split.items()})
    ops = out["breakdown"]["device_ops"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": out["correct"], "answered": answered,
        "card": torch.cuda.get_device_name(0),
        "metrics": {k: m["value"] for k, m in out["metrics"].items()},
        "traced_stmts_per_s": answered / dev["window_s"],
        "window_s": dev["window_s"], "busy_s": dev["busy_s"],
        "gaps": gaps,
        "implied_idle_ms": implied,
        "parts_ms": parts,
        "parts_sum_ms": None if parts is None else sum(parts.values()),
        "madlib_device_ops": [n for n, _ in ops
                              if n.startswith(program_spans.PREFIX)],
        "idle_gaps": out["breakdown"]["idle_gaps"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
