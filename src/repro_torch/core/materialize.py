"""Incremental view maintenance: retained statements as living views.

The port's counterpart of the reference ``core/materialize.py``.  Every
aggregate ships a merge combinator so partial states of disjoint row
sets compose exactly (§4.1); retaining a statement's fold state over
rows ``[0:r]`` therefore brings it current after an append by folding
rows ``[r:n]`` alone and merging once, never by a rescan:

* :class:`MaterializedHandle` pins (table **version**, plan
  **fingerprint**, retained **fold state**) for one or several fused
  scan statements;
* :meth:`MaterializedHandle.refresh` consults :attr:`Table.version` and
  :attr:`Table.epoch`: unchanged version -> no work; append-only growth
  (same epoch) -> **delta fold** of the new rows merged in with the
  members' own combinators (``kind="delta"`` in the trace); anything
  else (``invalidate``) -> full rescan;
* exactness: where the state arithmetic is exact (integer sketches,
  dyadic f32 sums) the delta-merged state is **bit-identical** to a full
  rescan, on the card through the same kernels as the rescan.

Grouped statements keep stacked ``(G, ...)`` states and merge group-wise.
A view over a distributed table keeps its base's mesh: the build and
every rescan run on the sharded engines, the delta folds locally (as in
the reference), and the members' grouping key holds the mesh.
A delta that brings a NEW group id under ``num_groups=None`` falls back
to a rescan (the full run would have grown ``G``).  Statements with a
base ``mask`` are rejected: a row filter is aligned with one table
version and says nothing about appended rows.

Living views also serve as cache fillers for the analytics server
(:meth:`repro_torch.core.server.AnalyticsServer.register_view`).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import torch

from ..tree import tree_index, tree_stack
from .aggregates import (
    FusedAggregate, probe_segment_ops, run_grouped, run_local, run_many,
)
from .plan import GroupedScanAgg, ScanAgg, _member_agg, statement_fingerprint
from .table import GroupedView, Table

__all__ = ["MaterializedHandle", "materialize"]


class MaterializedHandle:
    """A living view over one or more fused scan statements.

    Built by :func:`materialize`; the constructor runs the initial full
    fold.  :meth:`result` returns the finalized result(s), refreshing
    first; :meth:`refresh` brings the retained state current without
    finalizing and says HOW (``"noop"`` / ``"delta"`` / ``"rescan"``);
    :meth:`stale` says whether the table moved since the last refresh.
    One statement gives a single value, several a list in statement
    order.  An internal lock serializes refresh, result and state reads,
    so two concurrent server drains cannot double-fold one append."""

    def __init__(self, nodes: Sequence, *, single: bool):
        self.nodes = list(nodes)
        self._single = single
        base = self.nodes[0]
        self.kind = "grouped" if isinstance(base, GroupedScanAgg) else "scan"
        self._validate(base)
        self.table: Table = base.table
        self.block_size = base.block_size
        self.fingerprint = tuple(statement_fingerprint(n)
                                 for n in self.nodes)
        self.members = [_member_agg(n) for n in self.nodes]
        self.fused = FusedAggregate(self.members)
        if self.kind == "scan":
            self.engine = base.engine
        else:
            self.group_col = base.group_col
            self.mesh = base.mesh
            self.row_axes = base.row_axes
            self._groups_fixed = base.num_groups is not None
            self._groups_spec = base.num_groups
            self._method = self._resolve_method(base.method)
        self._result_cache: Any = None
        # reentrant: result() refreshes under the same lock
        self._state_lock = threading.RLock()
        with self._state_lock:
            self._full_build()

    # -- validation --------------------------------------------------------
    def _validate(self, base) -> None:
        for n in self.nodes:
            if type(n) is not type(base):
                raise TypeError(
                    "materialize: cannot mix scan and grouped statements "
                    "in one handle")
            if not isinstance(n, (ScanAgg, GroupedScanAgg)):
                raise TypeError(
                    f"materialize: not a retainable scan statement: {n!r} "
                    "(fit and stream statements hold no mergeable state)")
            if n.mask is not None:
                raise ValueError(
                    "materialize: masked statements are not supported — a "
                    "base row filter is row-aligned with ONE table version "
                    "and says nothing about appended rows; filter into a "
                    "derived table and materialize that")
            if isinstance(n.table, GroupedView):
                raise TypeError(
                    "materialize: grouped statements must reference the "
                    "Table itself, not a prebuilt GroupedView — a view is "
                    "a snapshot and carries no version to track")
            if n.table is not base.table:
                raise ValueError(
                    "materialize: statements retain state over different "
                    "tables; build one handle per table")
            if n.block_size != base.block_size:
                raise ValueError("materialize: members disagree on "
                                 "block_size")
        if self.kind == "grouped":
            key = (base.group_col, base.num_groups, base.method,
                   id(base.mesh), base.row_axes)
            for n in self.nodes:
                if (n.group_col, n.num_groups, n.method, id(n.mesh),
                        n.row_axes) != key:
                    raise ValueError(
                        "materialize: grouped members disagree on "
                        "group_col/num_groups/method/mesh/row_axes")
        elif len({n.engine for n in self.nodes}) > 1:
            raise ValueError("materialize: members disagree on engine")

    def _resolve_method(self, method: str) -> str:
        """Pin segment vs masked once: build, rescans and delta folds
        must all take the same path."""
        if method != "auto":
            return method
        data = {k: v for k, v in self.table.columns.items()
                if k != self.group_col}
        ok = all(probe_segment_ops(m, data) is not None
                 for m in self.members)
        return "segment" if ok else "masked"

    # -- state building ----------------------------------------------------
    def _pin(self, state, n_rows: int, version: int, epoch: int) -> None:
        # pin the version OBSERVED WHEN THE FOLD WAS DECIDED, never the
        # table's current one: a mutation landing mid-fold leaves the
        # handle stale (the next refresh catches up), not wrong
        self._state = state
        self._version = version
        self._epoch = epoch
        self._n_rows = n_rows
        self._result_cache = None

    def _full_build(self) -> None:
        t = self.table
        version, epoch = t.version, t.epoch
        if self.kind == "scan":
            state = run_many(self.members, t, block_size=self.block_size,
                             engine=self.engine, finalize=False)
        else:
            G = self._groups_spec
            if G is None:
                G = int(t[self.group_col].to(torch.int32).max()) + 1
            self._G = G
            state = run_grouped(self.fused, t, self.group_col,
                                num_groups=G, block_size=self.block_size,
                                method=self._method, mesh=self.mesh,
                                row_axes=self.row_axes, finalize=False)
        self._pin(state, t.n_rows, version, epoch)

    def _merge(self, a, b):
        """Merge two fold states: leaf-wise on stacked grouped states
        (every segment-path member merges leaf by leaf), group by group
        where a masked-path member may merge otherwise."""
        if self.kind == "scan" or self._method == "segment":
            return self.fused.merge(a, b)
        return tree_stack([self.fused.merge(tree_index(a, g),
                                            tree_index(b, g))
                           for g in range(self._G)])

    def _delta_fold(self, version: int, epoch: int, n_rows: int) -> bool:
        """Fold ONLY rows ``[pinned:n_rows]`` and merge into the retained
        state; False when a delta cannot match a full rescan (a new group
        id under open group-count semantics).  ``version``/``epoch``/
        ``n_rows`` are the coordinates the caller observed."""
        t = self.table
        delta_cols = {k: v[self._n_rows:n_rows] for k, v in t.columns.items()}
        delta = Table(delta_cols)
        if self.kind == "scan":
            new = run_local(self.fused, delta, block_size=self.block_size,
                            finalize=False, trace_kind="delta")
        else:
            G = self._G
            if not self._groups_fixed:
                mx = int(delta_cols[self.group_col].to(torch.int32).max())
                if mx >= G:
                    return False  # a full run would have grown num_groups
            # the aligned layout pads every group's segment to whole
            # blocks; shrink the delta block toward ~1 block per group
            # (exact-state merges do not depend on the partitioning)
            per_g = -(-delta.n_rows // max(G, 1))
            bs = max(64, min(self.block_size or 4096,
                             1 << max(per_g - 1, 0).bit_length()))
            new = run_grouped(self.fused, delta, self.group_col,
                              num_groups=G, block_size=bs,
                              method=self._method, finalize=False,
                              trace_kind="delta")
        self._pin(self._merge(self._state, new), n_rows, version, epoch)
        return True

    # -- the living-view API -----------------------------------------------
    @property
    def version(self) -> int:
        """The table version the retained state is pinned at."""
        with self._state_lock:
            return self._version

    def stale(self) -> bool:
        """Has the table mutated since the retained state was pinned?"""
        with self._state_lock:
            return self.table.version != self._version

    def refresh(self) -> str:
        """Bring the retained state current and say how: ``"noop"``
        (already at the pinned version, or an empty append), ``"delta"``
        (pure append: fold only the new rows and merge), or ``"rescan"``
        (the table was invalidated, or a delta could not match a full
        run)."""
        with self._state_lock:
            t = self.table
            # one consistent observation of the table's coordinates
            version, epoch, n_rows = t.version, t.epoch, t.n_rows
            if version == self._version:
                return "noop"
            if epoch == self._epoch and n_rows >= self._n_rows:
                if n_rows == self._n_rows:  # empty append
                    self._version = version
                    return "noop"
                if self._delta_fold(version, epoch, n_rows):
                    return "delta"
            self._full_build()
            return "rescan"

    def result(self, *, refresh: bool = True) -> Any:
        """Finalized result(s) at the current table version (refreshing
        first unless ``refresh=False``), cached per pinned state."""
        with self._state_lock:
            if refresh:
                self.refresh()
            if self._result_cache is None:
                self._result_cache = (
                    self.fused.final(self._state) if self.kind == "scan"
                    else self.fused.final_grouped(self._state))
            outs = self._result_cache
        return outs[0] if self._single else list(outs)


def materialize(statements) -> MaterializedHandle:
    """Retain one statement (or a compatible batch sharing one scan) as a
    :class:`MaterializedHandle`; the initial fold runs immediately::

        h = materialize(ScanAgg(agg, tbl))
        tbl.append(new_rows)
        h.result()      # delta fold + merge, NOT a rescan
    """
    if isinstance(statements, (ScanAgg, GroupedScanAgg)):
        return MaterializedHandle([statements], single=True)
    nodes = list(statements)
    if not nodes:
        raise ValueError("materialize: empty statement batch")
    return MaterializedHandle(nodes, single=False)
