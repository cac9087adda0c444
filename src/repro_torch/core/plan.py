"""Logical plans over the engine matrix: the declarative layer (§3.2).

The port's counterpart of the reference ``core/plan.py``, for the
statements the OLS slice needs.  Method wrappers emit logical nodes
(:class:`ScanAgg`, :class:`GroupedScanAgg`); :func:`plan` fuses
compatible statements into ONE pass each (one ``run_many`` per
``(table, mask, block size)``, one ``run_grouped`` per ``(table, key)``)
and picks the grouped method from the rows-moved heuristic;
:func:`execute` runs one statement through it.

Fusion is refused loudly when it would be wrong: statements with
different tables, masks or block partitionings never fold together.
Iterative fits (:class:`IterativeFit`) are statements too: each owns
its driver loop and never fuses, but a grouped fit shares the
partitioning sort with grouped scans of the same ``(table, key)``
through the ``group_by`` memo.  The join and stream nodes, the measured
calibration and ``explain()`` wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from .aggregates import (
    Aggregate, FusedAggregate, probe_segment_ops, run_grouped, run_many,
    segment_block_size,
)
from .iterative import IterativeTask, fit, fit_grouped
from .table import GroupedView, Table


# ---------------------------------------------------------------------------
# Logical plan nodes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ScanAgg:
    """One-pass aggregate over a table (``SELECT agg(...) FROM t``).
    ``columns`` is the statement's projection: a tuple of names or a
    ``{target: source}`` mapping; None = the whole table."""

    agg: Aggregate
    table: Table
    columns: Any = None
    mask: Any = None             # base row filter, table row order
    block_size: int | None = None
    engine: str = "auto"         # "auto" | "local"
    label: str | None = None     # the statement's name in a Session


@dataclasses.dataclass(eq=False)
class GroupedScanAgg:
    """Grouped aggregate (``SELECT g, agg(...) FROM t GROUP BY g``).
    ``table`` may be a prebuilt :class:`GroupedView` (``group_col``
    ignored); otherwise the view comes from the memoized
    ``Table.group_by``."""

    agg: Aggregate
    table: Any                   # Table | GroupedView
    group_col: str | None = None
    num_groups: int | None = None
    columns: Any = None
    mask: Any = None
    block_size: int | None = None
    method: str = "auto"         # "auto" | "segment" | "masked"
    label: str | None = None     # the statement's name in a Session


@dataclasses.dataclass(eq=False)
class IterativeFit:
    """Iterative model fit (the §3.1.2 driver pattern as a statement).

    ``group_col`` set -> ``fit_grouped``; else ``fit``.  Fit statements
    never fuse with one another (each owns its driver loop), but they
    share partitioning sorts with grouped scans through the same
    ``group_by`` memo.  ``blocks`` (the streaming engine), ``mesh`` and
    ``row_axes`` (the sharded engine) are not ported yet."""

    task: IterativeTask
    table: Table | None = None
    blocks: Callable | None = None
    group_col: str | None = None
    num_groups: int | None = None
    max_iters: int = 100
    tol: float | None = 1e-6
    engine: str = "auto"         # fit(): "auto" | "local"
    mode: str = "compiled"       # fit(): "compiled" | "host"
    layout: str = "auto"         # fit_grouped(): "auto"|"segment"|"masked"
    block_size: int | None = None
    mask: Any = None
    warm_start: Any = None
    mesh: Any = None
    row_axes: Any = None
    jit: bool = True
    label: str | None = None


# ---------------------------------------------------------------------------
# Projection adapter — a member sees exactly its statement's columns.
# ---------------------------------------------------------------------------

def _normalize_projection(columns) -> dict[str, str] | None:
    if columns is None:
        return None
    if isinstance(columns, Mapping):
        return dict(columns)
    return {name: name for name in columns}


class _Projected(Aggregate):
    """Feed a fused member only its statement's (possibly renamed)
    columns; merge, final and the kernel hook delegate to the wrapped
    aggregate, so fusion stays a pure scan-sharing transform."""

    merge_ops = None  # never consulted: every path below delegates

    def __init__(self, agg: Aggregate, columns):
        self.agg = agg
        self.projection = _normalize_projection(columns)

    def _project(self, block):
        if self.projection is None:
            return block
        return {tgt: block[src] for tgt, src in self.projection.items()}

    def init(self, block):
        return self.agg.init(self._project(block))

    def transition(self, state, block, mask):
        return self.agg.transition(state, self._project(block), mask)

    def merge(self, a, b):
        return self.agg.merge(a, b)

    def segment_ops(self, state):
        return self.agg.segment_ops(state)

    def final(self, state):
        return self.agg.final(state)

    def final_grouped(self, states):
        return self.agg.final_grouped(states)

    @property
    def segment_kernel(self):
        return self.agg.segment_kernel

    @property
    def kernel_impl(self):
        return self.agg.kernel_impl

    def segment_kernel_args(self, columns, valid, block_gids, num_groups):
        return self.agg.segment_kernel_args(self._project(columns), valid,
                                            block_gids, num_groups)


def _member_agg(node) -> Aggregate:
    columns = getattr(node, "columns", None)
    if columns is None:
        return node.agg
    return _Projected(node.agg, columns)


# ---------------------------------------------------------------------------
# Cost model: the rows-moved heuristic behind grouped method selection.
# The port has one scan engine, "local", so a scan pass has nothing to
# select; the sharded engines bring the scan side of the model with them.
# ---------------------------------------------------------------------------

def grouped_cost(method: str, rows: int, groups: int, block: int) -> float:
    """The segment layout scans the group-aligned blocks once (padding at
    most one partial block per group); the masked fallback scans the full
    table once per group."""
    if method == "segment":
        return float(rows + groups * block)
    if method == "masked":
        return float(rows * groups)
    raise ValueError(f"grouped_cost: unknown method {method!r}")


def select_grouped_method(rows: int, groups: int, *, segment_ok: bool,
                          block_size: int | None = None,
                          forced: str = "auto"
                          ) -> tuple[str, dict[str, float]]:
    """Pick segment vs masked for a grouped pass: ``(method, candidate
    costs)``; a generic-merge aggregate (``segment_ok=False``) removes
    the segment candidate."""
    bs = segment_block_size(rows, groups, block_size)
    costs = {method: grouped_cost(method, rows, groups, bs)
             for method in (("segment",) if segment_ok else ())
             + ("masked",)}
    if forced != "auto":
        if forced == "segment" and not segment_ok:
            raise ValueError(
                "method='segment' forced on a generic-merge aggregate "
                "(agg.segment_ops() is None); use 'masked'")
        if forced not in ("segment", "masked"):
            raise ValueError(f"unknown grouped method {forced!r}")
        return forced, costs
    return min(costs, key=lambda m: costs[m]), costs


# ---------------------------------------------------------------------------
# Physical passes.
# ---------------------------------------------------------------------------

def _mask_key(mask) -> Any:
    """Fusion identity of a base mask: object identity, so equal-content
    masks planned apart stay apart."""
    return None if mask is None else id(mask)


@dataclasses.dataclass
class PhysicalPass:
    """One physical engine execution covering >= 1 statements."""

    kind: str                       # "scan" | "grouped" | "fit"
    engine: str
    members: list                   # [(statement index, node), ...]
    cost: float
    run: Callable[[], dict]         # -> {statement index: result}


def fused_scan_pass(members: Sequence[tuple[int, ScanAgg]], *,
                    engine: str = "auto") -> PhysicalPass:
    """ONE shared-scan pass from compatible ScanAgg statements.  Members
    whose table, mask or block partitioning differ are rejected with an
    error, never silently folded together."""
    nodes = [n for _, n in members]
    base = nodes[0]
    if any(n.table is not base.table for n in nodes):
        raise ValueError(
            "fused_scan_pass: statements scan different tables — "
            "cross-table fusion is not a shared scan")
    if len({_mask_key(n.mask) for n in nodes}) > 1:
        raise ValueError(
            "fused_scan_pass: mixed-mask fusion rejected — run_many "
            "applies ONE base mask to every fused aggregate, so fusing "
            "statements with different mask= would silently apply one "
            "statement's filter to the others; plan them as separate "
            "passes")
    if len({n.block_size for n in nodes}) > 1:
        raise ValueError(
            "fused_scan_pass: members use different block_size values — "
            "fusing them would change their fold partitioning (and "
            "bit-exactness) vs solo execution")

    forced = base.engine if engine == "auto" else engine
    if forced not in ("auto", "local"):
        raise ValueError(f"unknown scan engine {forced!r} (the port has "
                         "'local'; the sharded engine is not ported)")
    idx = [i for i, _ in members]
    aggs = [_member_agg(n) for n in nodes]

    def run():
        out = run_many(aggs, base.table, block_size=base.block_size,
                       mask=base.mask, engine="local")
        return dict(zip(idx, out))

    return PhysicalPass(kind="scan", engine="local", members=list(members),
                        cost=float(base.table.n_rows), run=run)


def _grouped_view(node) -> GroupedView:
    if isinstance(node.table, GroupedView):
        return node.table
    if node.group_col is None:
        raise ValueError("GroupedScanAgg needs group_col (or a "
                         "prebuilt GroupedView)")
    return node.table.group_by(node.group_col, node.num_groups)


def _resolve_groups(node) -> int:
    if isinstance(node.table, GroupedView):
        return node.table.num_groups
    if node.num_groups is not None:
        return int(node.num_groups)
    # the version-checked memo: appended rows may bring new group ids
    view = node.table.cached_group_by(node.group_col, None)
    if view is not None:
        return view.num_groups
    return int(node.table[node.group_col].to(torch.int32).max()) + 1


def fused_grouped_pass(members: Sequence[tuple[int, GroupedScanAgg]]
                       ) -> PhysicalPass:
    """ONE grouped pass (one sort, one partitioned scan) for compatible
    grouped statements, with :func:`fused_scan_pass`'s loud rejections."""
    nodes = [n for _, n in members]
    base = nodes[0]
    if any(n.table is not base.table for n in nodes):
        raise ValueError("fused_grouped_pass: statements group different "
                         "tables/views")
    if any(n.group_col != base.group_col for n in nodes):
        raise ValueError("fused_grouped_pass: statements group by "
                         "different key columns")
    if len({_mask_key(n.mask) for n in nodes}) > 1:
        raise ValueError(
            "fused_grouped_pass: mixed-mask fusion rejected — one base "
            "mask applies to every fused grouped aggregate")
    if len({(n.num_groups, n.block_size, n.method) for n in nodes}) > 1:
        raise ValueError("fused_grouped_pass: members disagree on "
                         "num_groups/block_size/method")

    base_tbl = base.table.table if isinstance(base.table, GroupedView) \
        else base.table
    groups = _resolve_groups(base)
    rows = base.table.n_rows

    # the segment path needs EVERY member segment-reducible
    data_cols = dict(base_tbl.columns)
    data_cols.pop(base.group_col, None)
    member_aggs = [_member_agg(n) for n in nodes]
    segment_ok = all(probe_segment_ops(a, data_cols) is not None
                     for a in member_aggs)
    method, costs = select_grouped_method(
        rows, groups, segment_ok=segment_ok, block_size=base.block_size,
        forced=base.method)

    idx = [i for i, _ in members]
    projections = [_normalize_projection(n.columns) for n in nodes]

    def run():
        view = _grouped_view(base)
        if all(p is not None for p in projections):
            union = sorted({src for p in projections for src in p.values()})
            view = view.select(*union)
        out = run_grouped(FusedAggregate(member_aggs), view,
                          block_size=base.block_size, mask=base.mask,
                          method=method)
        return dict(zip(idx, out))

    return PhysicalPass(
        kind="grouped", engine=f"grouped-{method}", members=list(members),
        cost=costs[method], run=run)


def _fit_pass(index: int, node: IterativeFit) -> PhysicalPass:
    """The physical pass of ONE fit statement: its own driver loop."""
    if node.blocks is not None:
        raise NotImplementedError(
            "IterativeFit(blocks=...) (fit_stream) is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 3: run_stream)")
    if node.table is None:
        raise ValueError("IterativeFit needs a table")
    if node.group_col is not None:
        engine = f"grouped-{node.layout}"
    else:
        engine = "local" if node.engine == "auto" else node.engine

    def run():
        if node.group_col is not None:
            res = fit_grouped(node.task, node.table, node.group_col,
                              node.num_groups, max_iters=node.max_iters,
                              tol=node.tol, block_size=node.block_size,
                              mask=node.mask, warm_start=node.warm_start,
                              layout=node.layout, mesh=node.mesh,
                              row_axes=node.row_axes, jit=node.jit)
        else:
            res = fit(node.task, node.table, max_iters=node.max_iters,
                      tol=node.tol, engine=node.engine, mode=node.mode,
                      block_size=node.block_size, mask=node.mask,
                      warm_start=node.warm_start, mesh=node.mesh,
                      row_axes=node.row_axes, jit=node.jit)
        return {index: res}

    return PhysicalPass(kind="fit", engine=engine, members=[(index, node)],
                        cost=node.max_iters * float(node.table.n_rows),
                        run=run)


@dataclasses.dataclass
class PhysicalPlan:
    passes: list[PhysicalPass]
    n_statements: int

    def execute(self) -> list:
        """Run every pass; results come back in statement order."""
        out: dict[int, Any] = {}
        for p in self.passes:
            out.update(p.run())
        return [out[i] for i in range(self.n_statements)]


def plan(statements: Sequence[Any]) -> PhysicalPlan:
    """Compile logical statements into a physical plan: fuse compatible
    scans, dedup sorts, select engines.  Pass order follows each pass's
    first statement."""
    statements = list(statements)
    groups: dict[Any, list] = {}
    for i, node in enumerate(statements):
        if isinstance(node, ScanAgg):
            key = ("scan", id(node.table), _mask_key(node.mask),
                   node.block_size, node.engine)
        elif isinstance(node, GroupedScanAgg):
            key = ("grouped", id(node.table), node.group_col,
                   node.num_groups, _mask_key(node.mask), node.block_size,
                   node.method)
        elif isinstance(node, IterativeFit):
            key = ("fit", i)  # fits never fuse
        else:
            raise TypeError(f"not a logical plan node: {node!r}")
        groups.setdefault(key, []).append((i, node))

    build = {"scan": fused_scan_pass, "grouped": fused_grouped_pass}
    passes = [_fit_pass(*members[0]) if key[0] == "fit"
              else build[key[0]](members)
              for key, members in groups.items()]
    return PhysicalPlan(passes, len(statements))


def execute(node) -> Any:
    """Execute one logical statement through the planner: the
    single-statement path every method wrapper uses."""
    return plan([node]).execute()[0]
