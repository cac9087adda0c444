#!/usr/bin/env python3
"""The grouped plans the card's measured calibration picks, on a checkout.

    python3 tools/calib_choices.py                # this checkout
    python3 tools/calib_choices.py --root DIR     # another checkout

Runs ``chip_smoke.py`` section j's calibration sweep (its rows, groups,
blocks and reps) with the port of the checkout at ``--root`` (say the
parent commit, unpacked by ``git archive``) and prints, for each
(rows, groups) bucket and aggregate class, the grouped method (segment
or masked) the planner picks under the heuristic and under that
calibration, with the calibrated seconds of each method.  Then section
j's main-path statement, ``linregr_grouped`` over 10^7 dyadic rows of
K = 160 in 64 groups: the method ``explain()`` names under the
calibration, and the statement's first and repeated seconds under each
method.  One JSON line each for the buckets and the statement, with the
card's name and power limit.  The sweep writes its calibration under
that checkout's ``build/calibration/``.  Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose port runs (default: this one)")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch.core import GroupedScanAgg, Session, Table, calibration
    from repro_torch.core import execute
    from repro_torch.core.plan import select_grouped_method
    from repro_torch.launch.calibrate import calibrate
    from repro_torch.methods.linregr import LinregrAggregate

    if not torch.cuda.is_available():
        print("calib_choices: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = cs.nvidia_smi()
    t0 = time.perf_counter()
    _, path = calibrate(
        cs.CAL_ROWS, cs.CAL_GROUPS, cs.CAL_REPS, cs.CAL_BLOCKS, device=dev,
        out=str(root / "build" / "calibration" / "cuda.json"),
        masked_groups_max=cs.CAL_MASKED_GROUPS_MAX, log=lambda s: None)
    s_sweep = time.perf_counter() - t0
    buckets = []
    for rows in cs.CAL_ROWS:
        for groups in cs.CAL_GROUPS:
            for cls in ("xtx", "sketch"):
                heur = select_grouped_method(rows, groups, segment_ok=True,
                                             agg_cls=cls)[0]
                with calibration.use(path):
                    meas, costs, _ = select_grouped_method(
                        rows, groups, segment_ok=True, agg_cls=cls)
                buckets.append({"rows": rows, "groups": groups,
                                "class": cls, "heuristic": heur,
                                "measured": meas, "seconds": costs})
                print(f"[calib] {root.name}: rows={rows} groups={groups} "
                      f"{cls}: heuristic {heur}, calibrated {meas}; "
                      + ", ".join(f"{m} {v * 1e3:.3f} ms"
                                  for m, v in costs.items()))
    print(json.dumps({"root": str(root), "sweep_s": s_sweep,
                      "buckets": buckets, "device": smi}))

    # section j's statement, on section h's dyadic table, in its order
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 18)
    n, k, g = cs.N_MAIN, cs.K_MAIN, cs.G_MAIN
    td = Table({"x": cs.dyadic(torch, gen, (n, k), dev),
                "y": cs.dyadic(torch, gen, (n,), dev)})
    td = Table(dict(td.columns, g=torch.randint(
        0, g, (n,), generator=gen, dtype=torch.int32, device=dev)))
    sess = Session()
    sess.grouped_scan(LinregrAggregate(use_kernel=True), td, "g", g,
                      columns=("x", "y"), label="linregr_grouped")
    with calibration.use(path):
        text = sess.explain()
    planned = text.split("grouped-scan [", 1)[1].split("]", 1)[0]
    secs = {}
    for method in ("segment", "masked"):
        def stmt():
            with calibration.use(path):
                return execute(GroupedScanAgg(
                    LinregrAggregate(use_kernel=True), td, "g", g,
                    columns=("x", "y"), method=method,
                    label="linregr_grouped"))
        secs[method] = [cs.timed(torch, stmt)[1] for _ in range(2)]
    print(f"[calib] {root.name}: linregr_grouped ({n} x {k}, G = {g}) "
          f"planned {planned}; segment {secs['segment']} s, masked "
          f"{secs['masked']} s (first, repeated); {smi}")
    print(json.dumps({"root": str(root), "statement": "linregr_grouped",
                      "rows": n, "k": k, "groups": g, "planned": planned,
                      "seconds": secs, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
