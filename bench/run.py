"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port of MADlib).

Run from the root of a checkout::

    python3 bench/run.py --workload fig4-k320.linregr --seed 7 \
        --seconds 30 --trace 0

It makes the cell's table on the card from ``--seed``, warms every
statement of the cell's mix, measures for ``--seconds`` seconds, and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks``: each number compared with the reference beside its limit,
also printed as the last lines of standard error.  Without a card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result; it exits with 3 and no result when a module of JAX or of the
JAX package was loaded.

Two more modes read the numbers that the limits are set from, several
seeds in one process: ``--check-seeds 1,2,3`` runs the cell on each
seed and prints one line of checks each; ``--control --check-seeds
1,2,3`` puts the reference computed in TF32 in the program's place.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))


def _checks_text(checks: dict) -> list[str]:
    return [f"check {name} = {v!r} (limit {lim!r})"
            for name, (v, lim) in checks.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--check-seeds", default=None,
                   help="comma-separated seeds, run in one process")
    p.add_argument("--control", action="store_true",
                   help="with --check-seeds: the TF32 reference in the "
                        "program's place")
    args = p.parse_args(argv)
    # the configurations run the planner uncalibrated
    os.environ.pop("MADJAX_CALIBRATION", None)

    import torch

    from harness.core import (forbidden_modules, load_spec, resolve,
                              run_cell, run_control)

    chips = int(resolve(load_spec(), args.workload)[0]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    if args.check_seeds:
        seeds = [int(s) for s in args.check_seeds.split(",")]
        for seed in seeds:
            t = time.perf_counter()
            if args.control:
                checks, readings = run_control(args.workload, seed)
                res = {"seed": seed, "control": "tf32",
                       "correct": all(v <= lim for v, lim in checks.values()),
                       "readings": readings, "checks": checks}
            else:
                out = run_cell(args.workload, seed, args.seconds,
                               bool(args.trace), t_start=t)
                res = {"seed": seed, "correct": out["correct"],
                       "attempted": out["attempted"],
                       "failed": out["failed"], "metrics": out["metrics"],
                       "readings": out.get("readings", {}),
                       "checks": out["checks"]}
            res["seconds"] = time.perf_counter() - t
            print(json.dumps(res), flush=True)
        return 0
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules loaded that the benchmark may not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    print("\n".join(_checks_text(out["checks"])), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
