"""Measured cost calibration harness: fills the planner's statistics
catalog (:mod:`repro_torch.core.calibration`) with times taken where the
port runs.

    python -m repro_torch.launch.calibrate                  # on the card
    python -m repro_torch.launch.calibrate --tiny --device cpu --out c.json

The port's counterpart of the reference ``benchmarks/calibrate.py``.  It
times every (engine x aggregate class x shape bucket) cell on
``--device`` (the card unless ``--device cpu``):

* engines: ``local``, ``grouped-segment`` and ``grouped-masked``, the
  keys :func:`repro_torch.core.plan.select_grouped_method` and the scan
  pass look up (one card has no sharded engine);
* aggregate classes: ``xtx`` (``LinregrAggregate`` over 8 variables) and
  ``sketch`` (``CountMinAggregate(4, 128)``), both with
  ``use_kernel=True``: the CUDA kernels on the card (``xtx``,
  ``segment_linregr``, ``countmin``, ``segment_countmin``), their plain
  versions on the CPU, so the times are those of the path users run;
  ``generic`` is the per-cell mean of the measured classes;
* shape buckets: the ``--rows`` x ``--groups`` grid, group ids drawn
  with P(g) proportional to 1 / (g + 1);
* the grouped-block sweep: the segment engine over ``xtx`` at each of
  ``--block-sizes`` (a block is skipped when two of them exceed the
  rows), recording per bucket the measured best ``block``, the
  ``heuristic_block`` and the whole ``sweep``
  (:func:`repro_torch.core.aggregates.segment_block_size` reads
  ``block``).

``--masked-groups-max M`` bounds the masked cells: a masked pass scans
the whole table once per group whatever its rows, so above M groups the
cell times the pass over M groups and scales it by groups / M, and the
entry records ``measured_groups``.

Each cell runs once untimed, then ``--reps`` times; the best counts.  On
the card each run is timed by CUDA events around it (host work inside
the call, such as the layout's index build, shows as the gap it leaves),
on the CPU by the host clock.  The JSON has the reference's schema
(``backend`` is ``"cuda"`` or ``"cpu"``, ``timestamp`` ISO, ``kernels``
``{}``: the port's wrappers derive their grids and take no tuned
parameter) plus a top-level ``device`` (the card's name and power limit
from nvidia-smi) that the loader ignores.  The reference's replayed XLA
statistics are not applicable here (``hlo_context``); their tooling is
ROADMAP item 13.

The file goes to ``--out`` (default ``build/calibration/<backend>.json``
under the working directory) and changes nothing until the caller
activates it (``calibration.use(path)`` or ``MADJAX_CALIBRATION``).
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable

import torch

from ..core import calibration
from ..core.aggregates import run_grouped, run_local, segment_block_size
from ..core.table import Table
from ..device import resolve_device
from ..methods.linregr import LinregrAggregate
from ..methods.sketches import CountMinAggregate

_DIMS = 8
_SKETCH = (4, 128)
HLO_CONTEXT = ("not applicable: the port replays no compiled-program "
               "statistics (ROADMAP item 13)")


def _xtx_cols(gen, rows, dev):
    return {"x": torch.randn((rows, _DIMS), generator=gen, device=dev),
            "y": torch.randn((rows,), generator=gen, device=dev)}


def _sketch_cols(gen, rows, dev):
    return {"item": torch.randint(0, 10_000, (rows,), generator=gen,
                                  dtype=torch.int32, device=dev)}


# aggregate class -> (factory, columns builder)
CLASSES: dict[str, tuple[Callable, Callable]] = {
    "xtx": (lambda: LinregrAggregate(use_kernel=True), _xtx_cols),
    "sketch": (lambda: CountMinAggregate(*_SKETCH, use_kernel=True),
               _sketch_cols),
}


def _time(fn, reps: int, dev: torch.device) -> float:
    """Best seconds of ``reps`` runs after one untimed run."""
    fn()
    best = float("inf")
    for _ in range(max(1, reps)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            s = time.perf_counter() - t0
        best = min(best, s)
    return best


def _skewed_gids(gen, rows: int, groups: int, dev) -> torch.Tensor:
    """Group ids with P(g) proportional to 1 / (g + 1), drawn through the
    cumulative weights."""
    w = 1.0 / torch.arange(1, groups + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((rows,), generator=gen, dtype=torch.float64, device=dev)
    return torch.searchsorted(cdf, u).clamp_(max=groups - 1).to(torch.int32)


def _fmt(s: float) -> str:
    return f"{s:.4f} s" if s >= 1.0 else f"{s * 1e3:.3f} ms"


def measure(rows_list, groups_list, reps: int, block_sizes, *,
            device=None, masked_groups_max: int | None = None,
            log=print) -> dict:
    """The ``engines`` and ``grouped_block`` tables (see
    :class:`~repro_torch.core.calibration.Calibration`)."""
    dev = resolve_device(device)
    engines: dict[str, dict[str, list]] = {}
    grouped_block: list = []

    def put(engine, cls, entry):
        engines.setdefault(engine, {}).setdefault(cls, []).append(entry)

    for rows in rows_list:
        gen = torch.Generator(device=dev)
        gen.manual_seed(rows)
        for cls, (make, build) in CLASSES.items():
            cols = build(gen, rows, dev)
            tbl = Table(dict(cols))
            s = _time(lambda: run_local(make(), tbl), reps, dev)
            put("local", cls, {"rows": rows, "seconds": s})
            log(f"  local/{cls} rows={rows}: {_fmt(s)}")
            for groups in groups_list:
                gids = _skewed_gids(gen, rows, groups, dev)
                view = Table(dict(cols, g=gids)).group_by("g", groups)
                gb = {"rows": rows, "groups": groups}
                s = _time(lambda: run_grouped(make(), view,
                                              method="segment"), reps, dev)
                put("grouped-segment", cls, {**gb, "seconds": s})
                log(f"  grouped-segment/{cls} rows={rows} groups={groups}: "
                    f"{_fmt(s)}")
                m = groups if masked_groups_max is None \
                    else min(groups, masked_groups_max)
                mview = view if m == groups else Table(
                    dict(cols, g=gids % m)).group_by("g", m)
                s = _time(lambda: run_grouped(make(), mview,
                                              method="masked"), reps, dev)
                entry = {**gb, "seconds": s * groups / m}
                if m != groups:
                    entry["measured_groups"] = m
                put("grouped-masked", cls, entry)
                log(f"  grouped-masked/{cls} rows={rows} groups={groups}: "
                    f"{_fmt(entry['seconds'])}"
                    + (f" (timed over {m} groups)" if m != groups else ""))
                del gids, view, mview
            del cols, tbl

        # grouped-block sweep: the measured best segment block per bucket
        # (class-independent: the xtx workload drives it)
        make, build = CLASSES["xtx"]
        cols = build(gen, rows, dev)
        for groups in groups_list:
            view = Table(dict(cols, g=_skewed_gids(gen, rows, groups, dev))
                         ).group_by("g", groups)
            timed = {}
            for bs in block_sizes:
                if bs * 2 > max(rows, 1):
                    continue
                timed[bs] = _time(lambda b=bs: run_grouped(
                    make(), view, method="segment", block_size=b), reps, dev)
            if timed:
                best = min(timed, key=timed.get)
                heur = segment_block_size(rows, groups)
                grouped_block.append(
                    {"rows": rows, "groups": groups, "block": best,
                     "heuristic_block": heur,
                     "sweep": {str(b): s for b, s in timed.items()}})
                log(f"  block sweep rows={rows} groups={groups}: best={best} "
                    f"({_fmt(timed[best])}), heuristic={heur} "
                    + (f"({_fmt(timed[heur])})" if heur in timed
                       else "(not swept)"))
            del view
        del cols

    # generic = the mean of the measured classes, cell by cell
    for table in engines.values():
        buckets: dict[tuple, list] = {}
        for entries in table.values():
            for e in entries:
                buckets.setdefault((e["rows"], e.get("groups")),
                                   []).append(e["seconds"])
        table["generic"] = [
            {"rows": r, **({"groups": g} if g is not None else {}),
             "seconds": sum(ss) / len(ss)}
            for (r, g), ss in sorted(buckets.items())]
    return {"engines": engines, "grouped_block": grouped_block}


def card_description(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    device type where there is no card."""
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index or 0)],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def calibrate(rows_list, groups_list, reps: int, block_sizes, *,
              device=None, out: str | None = None,
              masked_groups_max: int | None = None,
              log=print) -> tuple[calibration.Calibration, str]:
    """Measure, write the JSON and return ``(calibration, path)``."""
    dev = resolve_device(device)
    backend = dev.type
    log(f"calibrating backend={backend} rows={list(rows_list)} "
        f"groups={list(groups_list)} reps={reps} "
        f"blocks={list(block_sizes)}")
    tables = measure(rows_list, groups_list, reps, block_sizes, device=dev,
                     masked_groups_max=masked_groups_max, log=log)
    cal = calibration.Calibration(
        backend=backend, timestamp=time.strftime("%Y-%m-%dT%H:%M:%S"),
        engines=tables["engines"], kernels={},
        grouped_block=tables["grouped_block"])
    path = out or f"build/calibration/{backend}.json"
    calibration.save(cal, path, extra={"device": card_description(dev),
                                       "hlo_context": HLO_CONTEXT})
    log(f"wrote {path}")
    return calibration.load(path), path


def _ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="1048576,4194304,10000000",
                    help="comma list of row-bucket sizes")
    ap.add_argument("--groups", default="8,64,1024",
                    help="comma list of group-bucket sizes")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--block-sizes", default="64,128,256,512,1024,2048,4096",
                    help="segment block sizes for the grouped sweep")
    ap.add_argument("--masked-groups-max", type=int, default=None,
                    help="time masked cells over at most this many groups "
                         "and scale (default: every group)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke size: one 4096-row bucket, 8 groups, "
                         "blocks 64 and 256, reps 1")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    ap.add_argument("--out", default=None,
                    help="output path (default: "
                         "build/calibration/<backend>.json)")
    args = ap.parse_args(argv)
    if args.tiny:
        rows_list, groups_list, reps, blocks = [4096], [8], 1, [64, 256]
    else:
        rows_list, groups_list = _ints(args.rows), _ints(args.groups)
        reps, blocks = args.reps, _ints(args.block_sizes)
    cal, path = calibrate(rows_list, groups_list, reps, blocks,
                          device=args.device, out=args.out,
                          masked_groups_max=args.masked_groups_max)
    probe = cal.engine_seconds("grouped-segment", "xtx", rows_list[0],
                               groups_list[0])
    print(f"lookup grouped-segment/xtx rows={rows_list[0]} "
          f"groups={groups_list[0]}: "
          f"{'MISSING' if probe is None else _fmt(probe)}")
    return path


if __name__ == "__main__":
    main()
