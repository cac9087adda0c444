"""What the traced run reads: the program's launch counters, spans the
benchmark wraps around program calls, and torch.profiler's trace of the
window.

The device arithmetic (the union of device intervals, the busy and idle
seconds) is chip_smoke.py's ``device_busy``, copied.  ``breakdown``
names the device operations that took the most time and the idle gaps,
summed by the host operation that was running at each gap's midpoint.
"""

from __future__ import annotations

import bisect
import json
import re
import sys
from pathlib import Path

import torch

KERNEL_NAMES = json.loads(
    (Path(__file__).with_name("kernel_names.json")).read_text())


def launch_counters() -> dict:
    """Every ``<name>_launches`` global of the program's kernel wrappers
    (``repro_torch.kernels.*.ops``), by ``<name>``."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not (mod_name.startswith("repro_torch.kernels.")
                and mod_name.endswith(".ops")) or mod is None:
            continue
        for attr, val in vars(mod).items():
            if attr.endswith("_launches") and isinstance(val, int):
                out[attr[:-len("_launches")]] = val
    return out


def interval_union(ivs):
    """Merged [start, end) intervals of ``ivs``."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def interval_length(ivs) -> float:
    return sum(b - a for a, b in ivs)


class Spans:
    """What the benchmark keeps of program calls in the traced run: the
    tensor shapes of a registry kernel's launches (``shapes``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.shapes: dict[str, list[tuple]] = {}
        self._undo: list = []

    def wrap_kernel(self, kernel: str) -> None:
        """Keep the tensor shapes of every launch of registry kernel
        ``kernel`` (re-registered through the program's public
        ``registry.register`` with a recording wrapper)."""
        from repro_torch.kernels import registry
        entry = registry.get(kernel)
        shapes = self.shapes.setdefault(kernel, [])

        def recorded(*args, **kwargs):
            shapes.append(tuple(tuple(a.shape) for a in args
                                if isinstance(a, torch.Tensor)))
            return entry.cuda(*args, **kwargs)

        registry.register(kernel, ref=entry.ref, cuda=recorded,
                          cost=entry.cost, overwrite=True)
        self._undo.append(lambda: registry.register(
            kernel, ref=entry.ref, cuda=entry.cuda, cost=entry.cost,
            overwrite=True))

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []


class DeviceTrace:
    """torch.profiler's trace of the window: device intervals (kernels,
    copies, sets) and host operations, in microseconds."""

    def __init__(self, prof, window_s: float, labels=()):
        self.window_s = window_s
        labels = set(labels)
        self.kernels: list[tuple[str, float, float]] = []
        self.device_ops: list[tuple[str, float, float]] = []
        host = []
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            on_device = getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA
            if on_device and (getattr(e, "is_user_annotation", False)
                              or e.name in labels):
                # a record_function label, which the profiler also puts
                # on the device's timeline: no device work of its own
                continue
            if on_device:
                self.device_ops.append((e.name, a, b))
                if not e.name.startswith(("Memcpy", "Memset")):
                    self.kernels.append((e.name, a, b))
            else:
                host.append((a, b, e.name))
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]
        self.busy = interval_union([(a, b) for _, a, b in self.device_ops])
        self.busy_s = interval_length(self.busy) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose names match ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.kernels if rx.search(n)) / 1e6

    def host_op_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self._host_starts, t)
        for a, b, name in reversed(self._host[max(0, i - 4096):i]):
            if b >= t:
                return name
        return "no host operation traced"

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, float] = {}
        for n, a, b in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(self.busy, self.busy[1:])]
        by_host: dict[str, float] = {}
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
            name = self.host_op_at((a + b) / 2)
            by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
        return {
            "device_ops": [[n, s] for n, s in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                by_host.items(), key=lambda kv: -kv[1])[:top]]}

    def missing_kernels(self, launched: dict) -> list[str]:
        """Counters that moved in the window with no kernel of theirs in
        the trace."""
        missing = []
        for name, count in sorted(launched.items()):
            if count <= 0:
                continue
            pats = KERNEL_NAMES.get(name, [re.escape(name)])
            if not any(re.search(p, k) for p in pats
                       for k, _, _ in self.kernels):
                missing.append(f"{name} ({count} launches)")
        return missing
