"""Logical plans over the engine matrix: the declarative layer (§3.2).

The port's counterpart of the reference ``core/plan.py``.  Method
wrappers emit logical nodes (:class:`ScanAgg`, :class:`GroupedScanAgg`,
:class:`JoinedGroupedScanAgg`, :class:`IterativeFit`,
:class:`StreamAgg`); :func:`plan` fuses compatible statements into ONE
pass each (one ``run_many`` per ``(table, mask, block size)``, one
``run_grouped`` per ``(table, key)``, one shared key resolution and
segment scan per ``(fact, dim, key, attr)`` star triple, one
``run_stream`` fold per block source, which is mandatory there: a shared
iterator can be consumed only once), filters the engines through the
capability matrix :data:`ENGINE_CAPS`, and picks the scan engine (local
or sharded over a distributed table's segments) and the grouped method
by measured seconds when an active calibration
(:mod:`repro_torch.core.calibration`) covers every candidate, else by
the rows-moved heuristic; :func:`execute` runs one statement through it
and :func:`explain` renders the physical plan, line for line as the
reference renders it.

Fusion is refused loudly when it would be wrong: statements with
different tables, masks or block partitionings never fold together.
Iterative fits (:class:`IterativeFit`) are statements too: each owns
its driver loop and never fuses, but a grouped fit shares the
partitioning sort with grouped scans of the same ``(table, key)``
through the ``group_by`` memo.

Fingerprints: :func:`statement_fingerprint` (aggregate identity, what a
living view pins) and :func:`semantic_fingerprint` (the aggregate's
``cache_key``, what the analytics server caches and dedups on).  Masked,
view-backed and multi-table statements never get a semantic
fingerprint.  The reference's jit flag has no counterpart in eager
PyTorch, so it is absent from both.

``explain()`` renders the reference's text line for line.  Where the two
packages' statements differ, they differ only in kernel impl names,
which the statements carry and the plan text never shows:

======================  =========================  =======================
what                    reference                  port
======================  =========================  =======================
forced kernel impl      ``use_kernel="pallas"``    ``use_kernel="cuda"``
trace ``kernel`` event  ``engine="pallas"``        ``engine="cuda"``
======================  =========================  =======================
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch

from . import calibration as _calibration
from .aggregates import (
    Aggregate, FusedAggregate, probe_segment_ops, run_grouped, run_many,
    run_stream, segment_block_size,
)
from .iterative import (
    IterativeTask, _as_state, _segment_task_ok, fit, fit_grouped, fit_stream,
)
from ..distributed import sharding as _sh
from .join import Join
from .table import GroupedView, Table
from .trace import record as _record, span

# ---------------------------------------------------------------------------
# The capability matrix: which cross-cutting features each engine honors.
# The planner filters candidate engines through it before costing them.
# ---------------------------------------------------------------------------

ENGINE_CAPS: dict[str, dict[str, bool]] = {
    "local":           {"mask": True,  "group_by": False, "fit": True,
                        "stream": False},
    "sharded":         {"mask": True,  "group_by": False, "fit": True,
                        "stream": False},
    "stream":          {"mask": False, "group_by": False, "fit": True,
                        "stream": True},
    "grouped-segment": {"mask": True,  "group_by": True,  "fit": True,
                        "stream": False},
    "grouped-masked":  {"mask": True,  "group_by": True,  "fit": True,
                        "stream": False},
    "sharded-grouped": {"mask": True,  "group_by": True,  "fit": True,
                        "stream": False},
}


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
    engine: str = "auto"         # "auto" | "local" | "sharded"
    jit: bool = True             # the reference's; eager either way
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
    mesh: Any = None             # None -> the table's mesh (may be None)
    row_axes: Any = None
    jit: bool = True             # the reference's; eager either way
    label: str | None = None     # the statement's name in a Session


@dataclasses.dataclass(eq=False)
class JoinedGroupedScanAgg:
    """Grouped aggregate over an equi-join (``SELECT dim.attr, agg(...)
    FROM fact JOIN dim GROUP BY dim.attr``).  ``join`` is a
    :class:`~repro_torch.core.join.Join`; the planner resolves it by the
    memoized device-side sort-merge into a fact-aligned group-id column
    and routes the result through the ordinary grouped core.  Statements
    over one (fact, dim, key, attr) triple fuse into ONE pass;
    ``num_groups`` defaults to ``max(dim.attr) + 1``; ``mask`` and
    ``columns`` are in FACT row order.  ``mesh`` (the fact table's when
    None) runs the pass on the sharded grouped engine."""

    agg: Aggregate
    join: Join
    num_groups: int | None = None
    columns: Any = None
    mask: Any = None
    block_size: int | None = None
    method: str = "auto"         # "auto" | "segment" | "masked"
    mesh: Any = None             # None -> the fact table's mesh
    row_axes: Any = None
    jit: bool = True             # the reference's; eager either way
    label: str | None = None


@dataclasses.dataclass(eq=False)
class IterativeFit:
    """Iterative model fit (the §3.1.2 driver pattern as a statement).

    ``blocks`` set (a zero-argument factory of block iterables) ->
    ``fit_stream`` on ``device`` (the card unless ``device="cpu"``);
    ``group_col`` set -> ``fit_grouped``; else ``fit``.  Fit statements
    never fuse with one another (each owns its driver loop), but they
    share partitioning sorts with grouped scans through the same
    ``group_by`` memo.  ``mesh`` and ``row_axes`` (the table's when None)
    run the fit on the sharded engine."""

    task: IterativeTask
    table: Table | None = None
    blocks: Callable | None = None
    group_col: str | None = None
    num_groups: int | None = None
    max_iters: int = 100
    tol: float | None = 1e-6
    engine: str = "auto"         # fit(): "auto" | "local" | "sharded"
    mode: str = "compiled"       # fit(): "compiled" | "host"
    layout: str = "auto"         # fit_grouped(): "auto"|"segment"|"masked"
    block_size: int | None = None
    mask: Any = None
    warm_start: Any = None
    mesh: Any = None
    row_axes: Any = None
    jit: bool = True
    label: str | None = None
    device: Any = None           # fit_stream(): where the state lives


@dataclasses.dataclass(eq=False)
class StreamAgg:
    """One-pass aggregate over an out-of-core block stream.

    ``blocks`` is an iterable of column dicts or a zero-arg factory.
    Statements sharing the same ``blocks`` object MUST fuse (the planner
    does): a shared iterator can only be consumed once.  ``device`` is
    where the fold state lives: the card unless ``device="cpu"``.
    """

    agg: Aggregate
    blocks: Any
    columns: Any = None          # projection
    label: str | None = None
    device: Any = None


Node = ("ScanAgg | GroupedScanAgg | JoinedGroupedScanAgg | IterativeFit"
        " | StreamAgg")


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

    def mesh_merge(self, states):
        return self.agg.mesh_merge(states)

    @property
    def segment_kernel(self):
        return self.agg.segment_kernel

    @property
    def kernel_impl(self):
        return self.agg.kernel_impl

    @property
    def cost_class(self):
        return self.agg.cost_class

    def segment_kernel_args(self, columns, valid, block_gids, num_groups):
        return self.agg.segment_kernel_args(self._project(columns), valid,
                                            block_gids, num_groups)


def _member_agg(node) -> Aggregate:
    columns = getattr(node, "columns", None)
    if columns is None:
        return node.agg
    return _Projected(node.agg, columns)


# ---------------------------------------------------------------------------
# Cost model.  With an ACTIVE measured calibration candidates rank by
# interpolated measured seconds; otherwise by the rows-moved heuristic.
# ---------------------------------------------------------------------------

_HEURISTIC = {"kind": "heuristic"}


def _agg_cost_class(aggs) -> str:
    """Calibration bucket of a (possibly fused) pass: the members' shared
    ``cost_class`` when they agree, else the generic tables."""
    classes = {getattr(a, "cost_class", "generic") for a in aggs}
    return classes.pop() if len(classes) == 1 else "generic"


def _measured_costs(cand_keys: Mapping[str, str], agg_cls: str, rows: int,
                    groups: int | None = None):
    """``(costs_in_seconds, source)`` from the active calibration, or
    None unless EVERY candidate is covered: measured seconds never rank
    against heuristic row counts in one comparison."""
    cal = _calibration.current()
    if cal is None:
        return None
    costs = {}
    for cand, key in cand_keys.items():
        s = cal.engine_seconds(key, agg_cls, rows, groups)
        if s is None:
            return None
        costs[cand] = s
    return costs, {"kind": "measured", "backend": cal.backend,
                   "timestamp": cal.timestamp}


def scan_cost(engine: str, rows: int, segs: int = 1) -> float:
    """Rows-moved cost of a one-pass scan: ``local`` folds every row in
    one fold (a table spread over more than one segment pays a gather
    first); ``sharded`` is the two-phase pattern, each segment's chunk
    plus one merge step per segment.  At ``segs == 1`` the merge term
    breaks the tie to local."""
    if engine == "local":
        return float(rows) * (2.0 if segs > 1 else 1.0)
    if engine == "sharded":
        return math.ceil(rows / segs) + segs
    raise ValueError(f"scan_cost: unknown engine {engine!r}")


def grouped_cost(method: str, rows: int, groups: int, block: int,
                 segs: int = 1) -> float:
    """The segment layout scans the group-aligned blocks once (padding at
    most one partial block per group); the masked fallback scans the full
    table once per group.  Over several segments each scans its chunk,
    plus G partial states per segment to merge."""
    if method == "segment":
        base = rows + groups * block
    elif method == "masked":
        base = rows * groups
    else:
        raise ValueError(f"grouped_cost: unknown method {method!r}")
    if segs > 1:
        return math.ceil(base / segs) + groups * segs
    return float(base)


def _capable(engine: str, *, mask: bool = False, group_by: bool = False,
             stream: bool = False) -> bool:
    """Can ``engine`` honor what the statement needs?
    (``sharded-grouped[segment]`` looks up ``sharded-grouped``.)"""
    caps = ENGINE_CAPS[engine.split("[")[0]]
    return ((not mask or caps["mask"])
            and (not group_by or caps["group_by"])
            and (not stream or caps["stream"]))


def select_scan_engine(rows: int, mesh=None, row_axes=None, *,
                       mask: bool = False, forced: str = "auto",
                       agg_cls: str = "generic"
                       ) -> tuple[str, dict[str, float], dict]:
    """Pick local vs sharded for a one-pass scan: ``(engine, candidate
    costs, cost source)``.  Candidates pass :data:`ENGINE_CAPS` for what
    the statement needs (``mask``) and rank by measured seconds when the
    active calibration covers them all (bucket ``agg_cls``), else by
    :func:`scan_cost`.  A forced ``"sharded"`` without a mesh is local,
    as ``run_sharded`` is."""
    segs = _sh.mesh_segments(mesh, row_axes)
    candidates = ["local"] + (["sharded"] if mesh is not None else [])
    costs = {e: scan_cost(e, rows, segs) for e in candidates
             if _capable(e, mask=mask)}
    source = _HEURISTIC
    measured = _measured_costs({e: e for e in costs}, agg_cls, rows)
    if measured is not None:
        costs, source = measured
    if forced != "auto":
        if forced not in ("local", "sharded"):
            raise ValueError(f"unknown scan engine {forced!r}")
        if forced == "sharded" and mesh is None:
            forced = "local"
        return forced, costs, source
    return min(costs, key=lambda e: costs[e]), costs, source


def select_grouped_method(rows: int, groups: int, *, segment_ok: bool,
                          block_size: int | None = None, segs: int = 1,
                          mask: bool = False, forced: str = "auto",
                          agg_cls: str = "generic"
                          ) -> tuple[str, dict[str, float], dict]:
    """Pick segment vs masked for a grouped pass: ``(method, candidate
    costs, cost source)``; a generic-merge aggregate
    (``segment_ok=False``) removes the segment candidate, and both pass
    :data:`ENGINE_CAPS`.  Candidates rank by measured seconds
    (calibration keys ``grouped-<method>``, or ``sharded-grouped-
    <method>`` over more than one segment; bucket ``agg_cls``) when the
    active calibration covers them all."""
    bs = segment_block_size(rows, groups, block_size)
    costs = {}
    for method in (("segment",) if segment_ok else ()) + ("masked",):
        if _capable(f"grouped-{method}", mask=mask, group_by=True):
            costs[method] = grouped_cost(method, rows, groups, bs, segs)
    source = _HEURISTIC
    prefix = "sharded-grouped-" if segs > 1 else "grouped-"
    measured = _measured_costs({m: prefix + m for m in costs}, agg_cls,
                               rows, groups)
    if measured is not None:
        costs, source = measured
    if forced != "auto":
        if forced == "segment" and not segment_ok:
            raise ValueError(
                "method='segment' forced on a generic-merge aggregate "
                "(agg.segment_ops() is None); use 'masked'")
        if forced not in ("segment", "masked"):
            raise ValueError(f"unknown grouped method {forced!r}")
        return forced, costs, source
    return min(costs, key=lambda m: costs[m]), costs, source


def join_cost(strategy: str, fact_rows: int, dim_rows: int) -> float:
    """Rows-moved cost of resolving ``fact ⋈ dim`` on top of the grouped
    pass that consumes it: ``sort-share`` (the planned strategy) is one
    dimension sort plus one searchsorted producing a single gid column;
    ``gather-materialize`` (the naive alternative it is priced against)
    also writes a joined copy of the fact rows."""
    if strategy == "sort-share":
        return float(fact_rows + dim_rows)
    if strategy == "gather-materialize":
        return float(2 * fact_rows + dim_rows)
    raise ValueError(f"join_cost: unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Physical passes.
# ---------------------------------------------------------------------------

def _mask_key(mask) -> Any:
    """Fusion identity of a base mask: object identity, so equal-content
    masks planned apart stay apart."""
    return None if mask is None else id(mask)


def node_tables(node) -> tuple[Table, ...]:
    """Every base :class:`Table` a statement READS: a join reads two
    (fact first, the admission table); a prebuilt GroupedView resolves to
    its data table.  The structural check behind the result cache's
    single-table contract."""
    join = getattr(node, "join", None)
    if join is not None:
        return (join.fact, join.dim)
    t = getattr(node, "table", None)
    if isinstance(t, GroupedView):
        t = t.table
    return (t,) if isinstance(t, Table) else ()


def _projection_key(node):
    proj = _normalize_projection(getattr(node, "columns", None))
    return None if proj is None else tuple(sorted(proj.items()))


def _mesh_key(node) -> tuple:
    """A grouped statement's own ``mesh``/``row_axes`` in fusion and
    fingerprint keys (the mesh by identity)."""
    return (None if node.mesh is None else id(node.mesh),
            tuple(node.row_axes) if node.row_axes else None)


def statement_fingerprint(node) -> tuple:
    """Identity of a retained statement's physical shape, what a living
    view pins beside the table version: same aggregate INSTANCE,
    projection, grouping, partitioning and engine knobs.  The table is
    not part of it (the view pins the table object itself)."""
    proj_key = _projection_key(node)
    if isinstance(node, ScanAgg):
        return ("scan", id(node.agg), proj_key, _mask_key(node.mask),
                node.block_size, node.engine)
    if isinstance(node, GroupedScanAgg):
        return ("grouped", id(node.agg), proj_key, node.group_col,
                node.num_groups, _mask_key(node.mask), node.block_size,
                node.method) + _mesh_key(node)
    raise TypeError(f"statement_fingerprint: not a retainable scan "
                    f"statement: {node!r}")


def semantic_fingerprint(node) -> tuple | None:
    """Cross-submitter identity of a statement's RESULT, the analytics
    server's cache and dedup key beside ``(table id, table version)``.
    Keys on :meth:`Aggregate.cache_key`, so two sessions' freshly built
    aggregates with equal parameters share one fingerprint.

    ``None`` (never cache, always execute) for an aggregate without a
    ``cache_key``, a masked statement, a prebuilt :class:`GroupedView`, a
    fit, or a statement reading more than one table (checked through
    :func:`node_tables`; it records a ``kind="cache_reject"`` event): the
    server probes its cache against the base table's version only, so a
    join's answer could outlive a mutation of its dimension."""
    tables = node_tables(node)
    if len(tables) > 1:
        _record("cache_reject", reason="multi-table",
                node=type(node).__name__,
                tables=tuple(id(t) for t in tables))
        return None
    if not isinstance(node, (ScanAgg, GroupedScanAgg)):
        return None
    agg_key = node.agg.cache_key()
    if agg_key is None or node.mask is not None:
        return None
    proj_key = _projection_key(node)
    if isinstance(node, ScanAgg):
        return ("scan", agg_key, proj_key, node.block_size, node.engine)
    if isinstance(node.table, GroupedView):
        return None
    return ("grouped", agg_key, proj_key, node.group_col, node.num_groups,
            node.block_size, node.method) + _mesh_key(node)


@dataclasses.dataclass
class PhysicalPass:
    """One physical engine execution covering >= 1 statements."""

    kind: str            # "scan" | "grouped" | "join" | "fit" | "stream"
    engine: str
    members: list                   # [(statement index, node), ...]
    cost: float | None
    info: dict                      # rendering details (explain)
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

    idx = [i for i, _ in members]
    aggs = [_member_agg(n) for n in nodes]
    rows = base.table.n_rows
    eng, costs, source = select_scan_engine(
        rows, base.table.mesh, base.table.row_axes,
        mask=base.mask is not None,
        forced=base.engine if engine == "auto" else engine,
        agg_cls=_agg_cost_class(aggs))

    def run():
        out = run_many(aggs, base.table, block_size=base.block_size,
                       mask=base.mask, engine=eng)
        return dict(zip(idx, out))

    return PhysicalPass(
        kind="scan", engine=eng, members=list(members),
        cost=costs[eng],
        info={"table": base.table, "rows": rows, "mask": base.mask,
              "block_size": base.block_size, "costs": costs,
              "cost_source": source},
        run=run)


def _node_mesh(node, table) -> tuple:
    """A statement's mesh (its own, else its table's) and row axes."""
    mesh = node.mesh if node.mesh is not None else table.mesh
    if mesh is not None:
        _sh.check_mesh(mesh, type(node).__name__)
    return mesh, node.row_axes or table.row_axes or None


def _grouped_engine(method: str, mesh) -> str:
    """The grouped pass's engine string, as explain renders it."""
    return f"sharded-grouped[{method}]" if mesh is not None \
        else f"grouped-{method}"


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
    if len({(n.num_groups, n.block_size, n.method) + _mesh_key(n)
            for n in nodes}) > 1:
        raise ValueError("fused_grouped_pass: members disagree on "
                         "num_groups/block_size/method/mesh")

    base_tbl = base.table.table if isinstance(base.table, GroupedView) \
        else base.table
    mesh, row_axes = _node_mesh(base, base_tbl)
    segs = _sh.mesh_segments(mesh, row_axes)
    groups = _resolve_groups(base)
    rows = base.table.n_rows

    # the segment path needs EVERY member segment-reducible
    data_cols = dict(base_tbl.columns)
    data_cols.pop(base.group_col, None)
    member_aggs = [_member_agg(n) for n in nodes]
    segment_ok = all(probe_segment_ops(a, data_cols) is not None
                     for a in member_aggs)
    method, costs, source = select_grouped_method(
        rows, groups, segment_ok=segment_ok, block_size=base.block_size,
        segs=segs, mask=base.mask is not None, forced=base.method,
        agg_cls=_agg_cost_class(member_aggs))

    idx = [i for i, _ in members]
    projections = [_normalize_projection(n.columns) for n in nodes]

    def run():
        view = _grouped_view(base)
        if all(p is not None for p in projections):
            union = sorted({src for p in projections for src in p.values()})
            view = view.select(*union)
        out = run_grouped(FusedAggregate(member_aggs), view,
                          block_size=base.block_size, mask=base.mask,
                          method=method, mesh=mesh, row_axes=row_axes)
        return dict(zip(idx, out))

    return PhysicalPass(
        kind="grouped", engine=_grouped_engine(method, mesh),
        members=list(members),
        cost=costs[method],
        info={"table": base_tbl, "group_col": base.group_col,
              "groups": groups, "rows": rows, "mask": base.mask,
              "costs": costs, "cost_source": source,
              "view_key": (id(base_tbl), base.group_col)},
        run=run)


def fused_join_pass(members: Sequence[tuple[int, JoinedGroupedScanAgg]]
                    ) -> PhysicalPass:
    """ONE joined-grouped pass (shared sort-merge key resolution, one
    partitioned segment scan) for compatible joined statements, with
    :func:`fused_grouped_pass`'s loud rejections; compatible means the
    SAME join spec, tables compared by identity.  Members that have a
    segment kernel each run it over the shared layout."""
    nodes = [n for _, n in members]
    base = nodes[0]
    j = base.join
    if any(n.join.spec_key() != j.spec_key() for n in nodes):
        raise ValueError(
            "fused_join_pass: statements join different (fact, dim, key, "
            "attr) triples — cross-join fusion would mix unrelated "
            "group-id columns")
    if len({_mask_key(n.mask) for n in nodes}) > 1:
        raise ValueError(
            "fused_join_pass: mixed-mask fusion rejected — one base mask "
            "applies to every fused joined aggregate")
    if len({(n.num_groups, n.block_size, n.method) + _mesh_key(n)
            for n in nodes}) > 1:
        raise ValueError("fused_join_pass: members disagree on "
                         "num_groups/block_size/method/mesh")

    mesh, row_axes = _node_mesh(base, j.fact)
    segs = _sh.mesh_segments(mesh, row_axes)
    groups = int(base.num_groups) if base.num_groups is not None \
        else j.attr_groups()
    rows = j.fact.n_rows
    # segment reducibility is probed on the FACT's columns: the joined
    # table is exactly them plus the gid column group_by strips
    member_aggs = [_member_agg(n) for n in nodes]
    segment_ok = all(probe_segment_ops(a, dict(j.fact.columns)) is not None
                     for a in member_aggs)
    method, costs, source = select_grouped_method(
        rows, groups, segment_ok=segment_ok, block_size=base.block_size,
        segs=segs, mask=base.mask is not None, forced=base.method,
        agg_cls=_agg_cost_class(member_aggs))
    join_costs = {s: join_cost(s, rows, j.dim.n_rows)
                  for s in ("sort-share", "gather-materialize")}
    # candidate costs include the key-resolution term, so the pass cost
    # equals its chosen candidate and explain's rejected list stays honest
    costs = {m: c + join_costs["sort-share"] for m, c in costs.items()}
    idx = [i for i, _ in members]
    projections = [_normalize_projection(n.columns) for n in nodes]

    def run():
        res = j.resolve()
        view = res.table.group_by(res.gid_col, groups)
        if all(p is not None for p in projections):
            union = sorted({src for p in projections for src in p.values()})
            view = view.select(*union)
        out = run_grouped(FusedAggregate(member_aggs), view,
                          block_size=base.block_size, mask=base.mask,
                          method=method, mesh=mesh, row_axes=row_axes)
        return dict(zip(idx, out))

    return PhysicalPass(
        kind="join", engine=_grouped_engine(method, mesh),
        members=list(members),
        cost=costs[method],
        info={"table": j.fact, "group_col": j.attr_col, "groups": groups,
              "rows": rows, "mask": base.mask, "costs": costs,
              "cost_source": source,
              "join": {"dim": j.dim, "on": f"{j.fact_key}={j.dim_key}",
                       "on_missing": j.on_missing, "costs": join_costs},
              # one partitioning sort per star triple, shared by every
              # joined pass over the same spec
              "view_key": ("join",) + j.spec_key()},
        run=run)


def _fit_pass(index: int, node: IterativeFit) -> PhysicalPass:
    """The physical pass of ONE fit statement: its own driver loop.  A
    grouped fit's layout is decided here, at plan time, as in the
    reference (explain consults the task as a database consults its
    statistics); a failing probe stays "auto" and execution surfaces the
    real error.  A stream fit has no table, no rows and no cost."""
    run_layout = node.layout
    if node.blocks is not None:
        engine, info = "stream", {}
    elif node.table is None:
        raise ValueError("IterativeFit needs a table or blocks")
    elif node.group_col is not None:
        layout = node.layout
        if layout == "auto":
            cols = {k: v for k, v in node.table.columns.items()
                    if k != node.group_col}
            try:
                s0 = _as_state(node.task.init_state(cols), node.table.device)
                layout = "segment" if _segment_task_ok(node.task, [s0],
                                                       cols) else "masked"
                run_layout = layout
            except Exception:
                layout = "auto"
        engine = _grouped_engine(layout, _node_mesh(node, node.table)[0])
        info = {"table": node.table, "group_col": node.group_col,
                "groups": _resolve_groups(node),
                "view_key": (id(node.table), node.group_col)
                if layout == "segment" else None}
    else:
        engine = node.engine
        if engine == "auto":
            mesh = _node_mesh(node, node.table)[0]
            engine = "sharded" if mesh is not None else "local"
        info = {"table": node.table}
    rows = None if node.table is None else node.table.n_rows
    cost = None if rows is None else node.max_iters * float(rows)

    def run():
        if node.blocks is not None:
            res = fit_stream(node.task, node.blocks,
                             max_iters=node.max_iters, tol=node.tol,
                             warm_start=node.warm_start, device=node.device)
        elif node.group_col is not None:
            res = fit_grouped(node.task, node.table, node.group_col,
                              node.num_groups, max_iters=node.max_iters,
                              tol=node.tol, block_size=node.block_size,
                              mask=node.mask, warm_start=node.warm_start,
                              layout=run_layout, mesh=node.mesh,
                              row_axes=node.row_axes, jit=node.jit)
        else:
            res = fit(node.task, node.table, max_iters=node.max_iters,
                      tol=node.tol, engine=node.engine, mode=node.mode,
                      block_size=node.block_size, mask=node.mask,
                      warm_start=node.warm_start, mesh=node.mesh,
                      row_axes=node.row_axes, jit=node.jit)
        return {index: res}

    return PhysicalPass(
        kind="fit", engine=engine, members=[(index, node)], cost=cost,
        info=dict(info, rows=rows, max_iters=node.max_iters, tol=node.tol),
        run=run)


def fused_stream_pass(members: Sequence[tuple[int, StreamAgg]]
                      ) -> PhysicalPass:
    """ONE ``run_stream`` fold for the stream statements over one block
    source (called first when it is a factory); members over different
    sources are rejected."""
    nodes = [n for _, n in members]
    base = nodes[0]
    if any(n.blocks is not base.blocks for n in nodes):
        raise ValueError("fused_stream_pass: statements fold different "
                         "block streams")
    idx = [i for i, _ in members]

    def run():
        blocks = base.blocks() if callable(base.blocks) else base.blocks
        out = run_stream(FusedAggregate([_member_agg(n) for n in nodes]),
                         blocks, device=base.device)
        return dict(zip(idx, out))

    return PhysicalPass(kind="stream", engine="stream",
                        members=list(members), cost=None, info={}, run=run)


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

    # -- EXPLAIN ----------------------------------------------------------
    def explain(self) -> str:
        """The plan as the reference renders it: one line per pass, one
        per statement; tables ``t0, t1, ...`` in statement order, shared
        sorts ``v0, v1, ...``."""
        tables: dict[int, str] = {}

        def tname(tbl) -> str:
            if tbl is None:
                return "-"
            return tables.setdefault(id(tbl), f"t{len(tables)}")

        # label tables in statement order for stable goldens (a join pass
        # names its dimension right after its fact)
        for p in self.passes:
            tname(p.info.get("table"))
            join = p.info.get("join")
            if join is not None:
                tname(join["dim"])

        shared_sorts: dict[Any, list] = {}
        for p in self.passes:
            vk = p.info.get("view_key")
            if vk is not None:
                shared_sorts.setdefault(vk, []).append(p)
        n_sorts = len(shared_sorts)

        lines = [f"plan: {self.n_statements} statement"
                 f"{'s' if self.n_statements != 1 else ''} -> "
                 f"{len(self.passes)} pass"
                 f"{'es' if len(self.passes) != 1 else ''}"
                 + (f", {n_sorts} sort{'s' if n_sorts != 1 else ''}"
                    if n_sorts else "")]
        sort_ids = {vk: f"v{i}" for i, vk in enumerate(shared_sorts)}
        for k, p in enumerate(self.passes):
            info = p.info
            bits = [f"pass {k}: {_KIND_NAMES[p.kind]} [{p.engine}]"]
            if info.get("table") is not None:
                bits.append(tname(info["table"]))
            join = info.get("join")
            if join is not None:
                bits.append(f"JOIN {tname(join['dim'])} on {join['on']}"
                            + (f" on_missing={join['on_missing']}"
                               if join["on_missing"] != "error" else ""))
            if info.get("group_col"):
                bits.append(f"by {info['group_col']} "
                            f"groups={info['groups']}")
                vk = info.get("view_key")
                if vk is not None:
                    shared = len(shared_sorts[vk]) > 1
                    bits.append(f"sort={sort_ids[vk]}"
                                + ("(shared)" if shared else ""))
            if info.get("rows") is not None:
                bits.append(f"rows={info['rows']}")
            if p.kind == "fit":
                tol = info.get("tol")
                bits.append(f"max_iters={info['max_iters']} "
                            f"tol={'none' if tol is None else f'{tol:g}'}")
            if info.get("mask") is not None:
                bits.append("mask=yes")
            if info.get("block_size") is not None:
                bits.append(f"block={info['block_size']}")
            if p.cost is not None:
                src = info.get("cost_source") or _HEURISTIC
                measured = src.get("kind") == "measured"
                rejected = {e: c for e, c in info.get("costs", {}).items()
                            if c != p.cost}
                bits.append(f"cost={_fmt_cost(p.cost, measured)}")
                bits.append(f"[measured {src['backend']}@{src['timestamp']}]"
                            if measured else "[heuristic]")
                if rejected:
                    bits.append("(rejected: " + " ".join(
                        f"{e}={_fmt_cost(c, measured)}" for e, c in sorted(
                            rejected.items())) + ")")
                if join is not None:
                    jc = join["costs"]
                    bits.append(
                        "(join: sort-share="
                        f"{_fmt_cost(jc['sort-share'], False)} rejected "
                        "gather-materialize="
                        f"{_fmt_cost(jc['gather-materialize'], False)})")
            lines.append("  " + " ".join(bits))
            for i, n in p.members:
                label = n.label or f"s{i}"
                lines.append(f"    {label}: {type(n.agg).__name__}"
                             if hasattr(n, "agg") else
                             f"    {label}: {type(n.task).__name__}")
        return "\n".join(lines)


_KIND_NAMES = {"scan": "shared-scan", "grouped": "grouped-scan",
               "join": "join-grouped-scan", "fit": "fit",
               "stream": "stream-scan"}


def _fmt_cost(c: float, measured: bool) -> str:
    """Heuristic costs are dimensionless row counts (integers); measured
    costs are seconds and render with a unit."""
    if not measured:
        return str(int(c))
    return f"{c:.2f}s" if c >= 1.0 else f"{c * 1e3:.2f}ms"


def plan(statements: Sequence[Any]) -> PhysicalPlan:
    """Compile logical statements into a physical plan: fuse compatible
    scans, dedup sorts and key resolutions, select engines.  Pass order
    follows each pass's first statement."""
    statements = list(statements)
    with span("plan"):
        groups: dict[Any, list] = {}
        for i, node in enumerate(statements):
            if isinstance(node, ScanAgg):
                key = ("scan", id(node.table), _mask_key(node.mask),
                       node.block_size, node.engine)
            elif isinstance(node, GroupedScanAgg):
                key = ("grouped", id(node.table), node.group_col,
                       node.num_groups, _mask_key(node.mask),
                       node.block_size, node.method) + _mesh_key(node)
            elif isinstance(node, JoinedGroupedScanAgg):
                # keyed on the join SPEC (both tables by identity, keys,
                # attr, policy): joined statements built apart, even with
                # distinct Join instances, fuse into one shared-resolution
                # pass
                key = (("join",) + node.join.spec_key()
                       + (node.num_groups, _mask_key(node.mask),
                          node.block_size, node.method) + _mesh_key(node))
            elif isinstance(node, StreamAgg):
                key = ("stream", id(node.blocks))
            elif isinstance(node, IterativeFit):
                key = ("fit", i)  # fits never fuse
            else:
                raise TypeError(f"not a logical plan node: {node!r}")
            groups.setdefault(key, []).append((i, node))

        build = {"scan": fused_scan_pass, "grouped": fused_grouped_pass,
                 "join": fused_join_pass, "stream": fused_stream_pass}
        passes = [_fit_pass(*members[0]) if key[0] == "fit"
                  else build[key[0]](members)
                  for key, members in groups.items()]
    return PhysicalPlan(passes, len(statements))


def execute(node) -> Any:
    """Execute one logical statement through the planner: the
    single-statement path every method wrapper uses."""
    with span("statement"):
        return plan([node]).execute()[0]


def explain(statements) -> str:
    """``EXPLAIN`` for one statement or a batch: the physical plan the
    optimizer would run, without running it."""
    if not isinstance(statements, (list, tuple)):
        statements = [statements]
    return plan(statements).explain()
