"""Measured cost calibration: the planner's statistics catalog.

The port's own copy of the reference ``core/calibration.py``, with the
same JSON schema and the same activation rule, so a file written by
either package loads in the other.  The harness
(:mod:`repro_torch.launch.calibrate`) times every (engine x aggregate
class x shape bucket) cell where it runs (the card, or the CPU when
asked) and writes one JSON file.  When a calibration is ACTIVE, the
planner (:mod:`repro_torch.core.plan`) ranks grouped methods by
interpolated measured seconds instead of the rows-moved heuristic,
``explain()`` renders ``measured <backend>@<timestamp>``, and
:func:`repro_torch.core.aggregates.segment_block_size` takes the
measured best block.  :func:`kernel_param` is kept for the schema: the
port's CUDA wrappers derive their grid from the shapes and read no tuned
parameter.

Activation is NEVER implicit: a calibration file lying on disk changes
nothing.  :func:`current` returns a calibration only when one was
activated (:func:`use` / :func:`activate`) or named by the
``MADJAX_CALIBRATION`` environment variable, the reference's name for
it; with none, every consumer keeps the heuristics.

Lookup: measurements are bucketed by shape (``rows``, optionally
``groups``).  A query picks the nearest bucket in log2 space and scales
its seconds linearly in rows, a first-order model that keeps the
ranking the measurements established, which is all method selection
consumes.  Aggregate classes fall back to ``"generic"`` when the
specific class (``"xtx"``, ``"sketch"``) was not measured.

Standard library only: it imports at the bottom of the core layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from typing import Any, Iterator

__all__ = [
    "Calibration", "activate", "current", "deactivate", "kernel_param",
    "load", "save", "use",
]


def _bucket_distance(entry: dict, rows: int, groups: int | None) -> float:
    d = abs(math.log2(max(rows, 1))
            - math.log2(max(int(entry.get("rows", 1)), 1)))
    if groups is not None and entry.get("groups"):
        d += abs(math.log2(max(groups, 1))
                 - math.log2(max(int(entry["groups"]), 1)))
    return d


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One backend's measured cost tables.

    ``engines``: engine key -> aggregate class -> list of bucket entries
    ``{"rows": int, "groups": int?, "seconds": float, ...}`` (extra keys
    are carried but not consumed).  ``kernels``: kernel name -> tuned
    parameter dict.  ``grouped_block``: bucket entries ``{"rows",
    "groups", "block"}``, the measured best segment block per bucket.
    """

    backend: str
    timestamp: str
    engines: dict[str, dict[str, list]]
    kernels: dict[str, dict[str, Any]]
    grouped_block: list
    source: str | None = None

    @staticmethod
    def from_dict(d: dict, source: str | None = None) -> "Calibration":
        return Calibration(
            backend=str(d.get("backend", "unknown")),
            timestamp=str(d.get("timestamp", "unknown")),
            engines=dict(d.get("engines", {})),
            kernels=dict(d.get("kernels", {})),
            grouped_block=list(d.get("grouped_block", [])),
            source=source,
        )

    def to_dict(self) -> dict:
        return {"backend": self.backend, "timestamp": self.timestamp,
                "engines": self.engines, "kernels": self.kernels,
                "grouped_block": self.grouped_block}

    def engine_seconds(self, engine: str, agg_class: str, rows: int,
                       groups: int | None = None) -> float | None:
        """Interpolated measured seconds for one candidate, or None when
        this calibration has no bucket for it (the caller then falls back
        to the heuristic for ALL candidates: units never mix)."""
        table = self.engines.get(engine)
        if not table:
            return None
        entries = table.get(agg_class) or table.get("generic")
        if not entries:
            return None
        best = min(entries, key=lambda e: _bucket_distance(e, rows, groups))
        base_rows = max(int(best.get("rows", 1)), 1)
        return float(best["seconds"]) * (max(rows, 1) / base_rows)

    def kernel_param(self, kernel: str, param: str):
        return (self.kernels.get(kernel) or {}).get(param)

    def grouped_block_size(self, rows: int, groups: int) -> int | None:
        """Measured best segment block for the nearest shape bucket."""
        if not self.grouped_block:
            return None
        best = min(self.grouped_block,
                   key=lambda e: _bucket_distance(e, rows, groups))
        b = best.get("block")
        return None if b is None else int(b)


# ---------------------------------------------------------------------------
# Activation: explicit, stack-scoped, or by environment variable.
# ---------------------------------------------------------------------------

_ACTIVE: list[Calibration] = []
_ENV_CACHE: dict[str, Calibration] = {}


def load(path: str) -> Calibration:
    with open(path) as f:
        return Calibration.from_dict(json.load(f), source=str(path))


def save(cal: Calibration, path: str, extra: dict | None = None) -> str:
    """Write ``cal`` as JSON; ``extra`` adds top-level keys that the
    loader ignores (the harness records the card there)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({**(extra or {}), **cal.to_dict()}, f, indent=2,
                  sort_keys=True)
        f.write("\n")
    return path


def activate(cal: Calibration) -> Calibration:
    _ACTIVE.append(cal)
    return cal


def deactivate(cal: Calibration) -> None:
    _ACTIVE.remove(cal)


@contextlib.contextmanager
def use(cal: "Calibration | str") -> Iterator[Calibration]:
    """Scope a calibration (object or JSON path) over a block::

        with calibration.use("build/calibration/cuda.json"):
            print(explain(statements))   # costs render as measured
    """
    c = load(cal) if isinstance(cal, str) else cal
    activate(c)
    try:
        yield c
    finally:
        deactivate(c)


def current() -> Calibration | None:
    """The active calibration: the innermost :func:`use`/:func:`activate`
    scope, else the ``MADJAX_CALIBRATION`` file (cached per path), else
    None: heuristics everywhere."""
    if _ACTIVE:
        return _ACTIVE[-1]
    path = os.environ.get("MADJAX_CALIBRATION")
    if not path:
        return None
    hit = _ENV_CACHE.get(path)
    if hit is None:
        hit = load(path)  # loud on a missing or garbled file
        _ENV_CACHE[path] = hit
    return hit


def kernel_param(kernel: str, param: str, default=None):
    """Tuned kernel parameter from the active calibration (``default``
    when none is active or the kernel was not tuned).  No wrapper of the
    port reads one."""
    cal = current()
    if cal is None:
        return default
    v = cal.kernel_param(kernel, param)
    return default if v is None else v
