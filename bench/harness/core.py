"""One run of one cell: set-up, warm-up, the measured window, the traced
reading, then the comparison with the reference.

Everything that belongs to one configuration, traffic mix, statement or
metric is a file found by its name: ``configs/<file>`` (from
``BENCHMARK.json``) with its ``columns/<generator>.py``,
``mixes/<traffic>.json``, ``statements/<name>.py`` and
``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from .data import Data
from .loop import ClosedLoop
from .tracing import DeviceTrace, Spans, launch_counters

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level module names the program must not load (whole names: the
# port's own name begins with "repro")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` under the benchmark's folder, as a module."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    mod_name = f"bench_{folder}_{name}".replace("-", "_").replace(".", "_")
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a name
    ``<base>.<kind>`` that has no file of its own, ``metrics/<base>.py``
    (one quantity split by the kind of cell, each part with its own
    bound)."""
    if (BENCH / "metrics" / f"{name}.py").is_file() or "." not in name:
        return load_module("metrics", name)
    return load_module("metrics", name.split(".")[0])


def resolve(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """The cell named ``workload``: its entry, configuration and mix."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, config, mix


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with ``trace`` the per-layer ones, that name the cell (or name no
    cells)."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a metric reads (see ``metrics/``)."""

    def __init__(self, device):
        self.spans = Spans(torch.device(device))
        self.window = None
        self.answered: list = []
        self.setup_s = None
        self.trace: DeviceTrace | None = None
        self.launched: dict = {}


def _statements(mix: dict) -> dict:
    return {s["statement"]: load_module("statements", s["statement"])
            for s in mix["round"]}


def judge(window, mix: dict, config: dict, statements: dict,
          data: Data) -> dict:
    """Every number compared, as ``name -> (value, limit)``: every
    answer of the window against the reference over the whole table,
    which the reference makes again from the seed."""
    ok = [r for r in window.records
          if r.error is None and r.answer is not None]
    checks: dict = {}

    def put(name, value, limit):
        """Keep the worst reading of each number; a limit of ``None``
        marks a number that is read but not compared."""
        old = checks.get(name)
        if old is None or value > old[0]:
            checks[name] = (value, limit)

    blocks = list(data.base_blocks())
    for i, spec in enumerate(mix["round"]):
        st = statements[spec["statement"]]
        args = spec.get("args", {})
        mine = [r for r in ok if r.index == i]
        if not mine:
            continue
        ref = st.reference(blocks, config, args)
        for r in mine:
            for k, v in st.compare(r.answer, ref, args).items():
                put(f"{spec['statement']}.{k}", v, st.LIMITS[k])
        del ref
    del blocks
    return checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", rows: int | None = None,
             t_start: float | None = None) -> dict:
    """One run; returns the result line's object (``checks`` holds each
    number compared with its limit, as ``[value, limit]``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec()
    cell, config, mix = resolve(spec, workload)
    dev = torch.device(device)
    statements = _statements(mix)
    metric_specs = cell_metrics(spec, workload, trace)
    readers = {m["name"]: metric_reader(m["name"]) for m in metric_specs}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.core import Table

    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    data = Data(config, seed, dev, rows)
    table = Table(data.columns_on_device())
    loop = ClosedLoop(mix, table, statements, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["data"] = time.perf_counter() - t
    t = time.perf_counter()
    loop.warm_up()
    phases["warm_up"] = time.perf_counter() - t
    ctx = Context(dev)
    if trace:
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(ctx)
    before = launch_counters()
    ctx.setup_s = time.perf_counter() - t_start
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t_a = time.perf_counter()
            window = loop.run_window(seconds)
            t_b = time.perf_counter()
        labels = {f"statement {s['statement']}" for s in mix["round"]}
        ctx.trace = DeviceTrace(prof, t_b - t_a, labels)
    else:
        window = loop.run_window(seconds)
    after = launch_counters()
    ctx.launched = {k: after[k] - before.get(k, 0) for k in after}
    ctx.spans.close()
    ctx.window = window
    ctx.answered = [r for r in window.records
                    if r.error is None and r.answer is not None]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if trace and dev.type == "cuda":
        missing = ctx.trace.missing_kernels(ctx.launched)
        if missing:
            raise RuntimeError(
                "the profiler's trace lacks kernels the program counted as "
                "launched in the window: " + ", ".join(missing))
        if ctx.trace.busy_s <= 0:
            raise RuntimeError("the profiler's trace holds no device time")
    metrics = {}
    for m in metric_specs:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        breakdown = ctx.trace.breakdown()
    # the program's state goes before the reference runs
    del loop, table
    if trace:
        del prof
    ctx.trace = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(window, mix, config, statements, data)
    failed = sum(r.error is not None or r.answer is None
                 for r in window.records)
    readings = {k: v for k, (v, lim) in checks.items() if lim is None}
    checks = {k: c for k, c in checks.items() if c[1] is not None}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": len(window.records),
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # where set-up went: imports (with the card's start), the table, the
    # warm-up (with the kernel library's build or load)
    out["setup_phases"] = phases
    if readings:
        out["readings"] = dict(sorted(readings.items()))
    errors = sorted({r.error for r in window.records if r.error})
    if errors:
        out["errors"] = errors[:3]
    # each number compared beside its limit: the line's last key
    out["checks"] = {k: [v, lim] for k, (v, lim) in sorted(checks.items())}
    return out


def run_control(workload: str, seed: int, *, device: str = "cuda",
                rows: int | None = None) -> tuple[dict, dict]:
    """The control: the reference in TF32 put in the program's place, at
    the cell's table as made, held to the same limits.  Returns the
    numbers compared, as ``name -> [value, limit]``, and those only
    read, as ``name -> value``."""
    spec = load_spec()
    _, config, mix = resolve(spec, workload)
    statements = _statements(mix)
    data = Data(config, seed, torch.device(device), rows)
    blocks = list(data.base_blocks())
    checks: dict = {}
    for spec_ in mix["round"]:
        st = statements[spec_["statement"]]
        args = spec_.get("args", {})
        ref = st.reference(blocks, config, args)
        ctl = st.reference(blocks, config, args, tf32=True)
        for k, v in st.compare(ctl, ref, args).items():
            name = f"{spec_['statement']}.{k}"
            if name not in checks or v > checks[name][0]:
                checks[name] = [v, st.LIMITS[k]]
    compared = {k: c for k, c in sorted(checks.items()) if c[1] is not None}
    read = {k: c[0] for k, c in sorted(checks.items()) if c[1] is None}
    return compared, read
