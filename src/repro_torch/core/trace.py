"""Host-side execution tracing: the plan layer's observability hooks.

The port's copy of the reference package's ``core/trace.py``, the same
in behaviour.  Engines record one event per physical data pass
(``kind="scan"``), ``Table.sort_permutation`` one per sort actually
performed (``kind="sort"``), and every kernel dispatch one
``kind="kernel"`` event whose ``engine`` is the resolved implementation
(``"ref"`` or ``"cuda"``).  Tests wrap executions in
:func:`trace_execution` and count, never time.  The serving, join and
view kinds (``admission``, ``cache_hit``, ``join``, ``cache_reject``,
``delta``) and :meth:`Trace.summary`'s rollups of them are kept so that
later slices record into the same structure.

Spans are the port's own; the reference's module has none.
:func:`span` marks an interval of the statement path: ``statement``
(the front end), ``plan`` (the planner), ``fold`` and ``final`` (the
engines) and ``dispatch`` (a kernel's host side).  While torch.profiler
records, a span is the profiler range ``madlib::<name>``, on the
profiler's clock beside the device's intervals; otherwise it is one
shared no-op context.  Spans never reach :attr:`Trace.events`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch


@dataclasses.dataclass
class Event:
    kind: str               # "scan" | "sort" | "fit" | "delta" | "kernel"
    #                       | "admission" | "cache_hit" | "join"
    #                       | "cache_reject"
    engine: str | None      # "local" / "sharded" / "grouped-segment" / ...;
    # for kind="kernel" this is the RESOLVED implementation ("ref" /
    # "cuda"), with detail carrying the kernel name and requested impl
    detail: dict[str, Any]


class Trace:
    """An ordered list of engine events, with kind-filtered views."""

    def __init__(self):
        self.events: list[Event] = []

    def _kind(self, kind: str) -> list[Event]:
        return [e for e in self.events if e.kind == kind]

    @property
    def scans(self) -> list[Event]:
        return self._kind("scan")

    @property
    def sorts(self) -> list[Event]:
        return self._kind("sort")

    @property
    def fits(self) -> list[Event]:
        return self._kind("fit")

    @property
    def deltas(self) -> list[Event]:
        return self._kind("delta")

    @property
    def kernels(self) -> list[Event]:
        """Kernel dispatch resolutions — one per physical execution that
        consulted the registry; ``engine`` is the resolved impl."""
        return self._kind("kernel")

    @property
    def admissions(self) -> list[Event]:
        """Admission-window drains — one per drained per-table window
        (however triggered: count threshold, timeout, flush, demand, or
        the background drainer); ``detail`` carries the base table id,
        window size, planned/deduped/cache-hit statement counts,
        ``scans_saved``, and the ``opened_at``/``drained_at``/``latency``
        timestamps isolation assertions are built from."""
        return self._kind("admission")

    @property
    def joins(self) -> list[Event]:
        """Sort-merge join key resolutions actually performed
        (``Join.resolve`` memo misses; hits are silent) — N joined
        statements over one (fact, dim, key) triple record ONE."""
        return self._kind("join")

    @property
    def cache_rejects(self) -> list[Event]:
        """Statements the semantic fingerprint refused to identify for
        the result cache because they read more than one table;
        ``detail["tables"]`` lists the table ids involved."""
        return self._kind("cache_reject")

    @property
    def cache_hits(self) -> list[Event]:
        """Statements answered from the server's version-keyed result
        cache (``detail["source"] == "cache"``) or a registered
        materialized view (``"view"``).  ``detail["refresh"]`` says what
        the answer really cost: ``"none"``/``"noop"``/``"delta"`` cost
        zero physical scans, ``"rescan"`` re-read the table inside the
        hit path."""
        return self._kind("cache_hit")

    def summary(self) -> dict:
        """Counts per event kind, plus the admission windows' aggregate
        sharing tallies (``scans_saved`` / ``deduped`` summed across
        windows) — what benches and serving logs print.  When admission
        events are present, ``out["by_table"]`` breaks the serving
        tallies down per base table (keyed by the admission events'
        ``detail["table"]`` id): windows drained, statements admitted,
        scans saved, dedups and cache hits — the cross-table rollup for
        per-table admission windows."""
        out: dict[str, Any] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        sorts = self._kind("sort")
        if sorts:
            # per-table sort rollup: sort dedup across a star schema
            # ("one argsort per (table, key)") is asserted from these
            # counts, never from timing
            by_sorts: dict[Any, int] = {}
            for e in sorts:
                t = e.detail.get("table")
                by_sorts[t] = by_sorts.get(t, 0) + 1
            out["sorts_by_table"] = by_sorts
        admissions = self._kind("admission")
        for field in ("scans_saved", "deduped"):
            total = sum(e.detail.get(field, 0) for e in admissions)
            if total:
                out[field] = total
        if admissions:
            by: dict[Any, dict[str, int]] = {}
            for e in admissions:
                row = by.setdefault(e.detail.get("table"), {
                    "windows": 0, "statements": 0, "scans_saved": 0,
                    "deduped": 0, "cache_hits": 0})
                row["windows"] += 1
                row["statements"] += e.detail.get("window", 0)
                row["scans_saved"] += e.detail.get("scans_saved", 0)
                row["deduped"] += e.detail.get("deduped", 0)
                row["cache_hits"] += e.detail.get("cache_hits", 0)
            out["by_table"] = by
        return out


_ACTIVE: list[Trace] = []


def record(kind: str, engine: str | None = None, **detail: Any) -> None:
    """Record one event on every active trace (no-op when none are)."""
    for t in _ACTIVE:
        t.events.append(Event(kind, engine, detail))


@contextlib.contextmanager
def trace_execution() -> Iterator[Trace]:
    """Collect engine events for the dynamic extent of the block::

        with trace_execution() as t:
            session.run()
        assert len(t.scans) == 1

    Nestable; every active trace sees every event.
    """
    t = Trace()
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.remove(t)


_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager around one interval of the statement path:
    the profiler range ``madlib::<name>`` while torch.profiler records,
    else one shared no-op context (the check is its whole cost)."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(f"madlib::{name}")
