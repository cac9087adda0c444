"""Session: the declarative front end over the logical-plan layer.

The port's counterpart of the reference ``core/session.py``, local mode.
A :class:`Session` batches statements as logical plan nodes, and
:meth:`Session.run` plans and executes them together: independent
one-pass statistics over the same table fold into ONE data pass, and
grouped statements share ONE partitioning sort::

    sess = Session()
    stats = sess.profile(tbl)
    ols   = sess.linregr(tbl, use_kernel=True)
    freq  = sess.countmin_sketch(tbl, item_col="item")
    sess.run()                    # one shared scan, three statements
    ols.result().coef

Each statement returns a :class:`Handle`; ``handle.result()`` is there
after ``run()``.  ``run()`` consumes the batch, whether or not it
succeeds.

Iterative fits are statements too (``fit``, ``logregr``): each runs its
own driver loop and never fuses, and a grouped fit shares the
partitioning sort with grouped scans of the same table and key.
Out-of-core statements (``stream_scan``, and ``fit(..., blocks=...)``)
fold host-side block streams: every stream statement over one block
source folds in ONE ``run_stream`` pass.
Joined statements (``joined_grouped_scan``) over one star triple share
one key resolution and one pass; ``materialize`` keeps living views
that ``refresh`` brings current by delta folds; ``explain`` renders the
physical plan without running it.

**Server mode.**  ``Session(server=an_analytics_server)`` swaps the
private batch for the server's cross-session admission windows
(:mod:`repro_torch.core.server`): every statement submits at once and
returns a :class:`~repro_torch.core.server.ServerHandle`; the server
fuses, deduplicates and caches across ALL attached sessions, and
``run()``/``handle.result()`` drain on demand.  The statement-issuing
API is the same in both modes.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .materialize import materialize
from .plan import (
    GroupedScanAgg, IterativeFit, JoinedGroupedScanAgg, ScanAgg, StreamAgg,
    plan,
)
from .table import Table

_UNSET = object()


class Handle:
    """Deferred result of one session statement."""

    def __init__(self, label: str):
        self.label = label
        self._value: Any = _UNSET
        self._failed = False

    def done(self) -> bool:
        return self._value is not _UNSET

    def result(self) -> Any:
        if self._value is _UNSET:
            if self._failed:
                raise RuntimeError(
                    f"statement {self.label!r} was in a batch whose "
                    "Session.run() raised; the batch was discarded, "
                    "re-issue the statement")
            raise RuntimeError(
                f"statement {self.label!r} has not executed yet; call "
                "Session.run() first")
        return self._value


class _DerivedHandle:
    """Lazy combination of several server handles (the server-mode
    counterpart of a derived Handle): ``result()`` gathers every part,
    draining the shared admission window on demand, and combines once."""

    def __init__(self, label: str, parts: list, combine: Callable):
        self.label = label
        self._parts = parts
        self._combine = combine
        self._value: Any = _UNSET

    def done(self) -> bool:
        return (self._value is not _UNSET
                or all(p.done() for p in self._parts))

    def result(self, timeout: float | None = None) -> Any:
        """Gather and combine the parts; ``timeout`` bounds the WHOLE
        gather (one deadline shared by the parts)."""
        if self._value is _UNSET:
            if timeout is None:
                vals = [p.result() for p in self._parts]
            else:
                deadline = time.monotonic() + timeout
                vals = [p.result(timeout=max(
                    0.0, deadline - time.monotonic()))
                    for p in self._parts]
            self._value = self._combine(vals)
        return self._value


class Session:
    """Batches logical statements and runs them through the planner, or,
    with ``server=``, submits them to a shared
    :class:`~repro_torch.core.server.AnalyticsServer`."""

    def __init__(self, server=None):
        self.server = server
        self._nodes: list = []
        self._posts: list = []
        self._handles: list = []
        self._derived: list = []
        self._materialized: list = []
        self.last_plan = None

    # -- generic statements ----------------------------------------------
    def statement(self, node, *, post: Callable | None = None) -> Handle:
        """Enqueue a prebuilt logical plan node; ``post`` (optional)
        shapes the engine's result into the handle's value.  In server
        mode the node is submitted at once and the handle resolves when
        the server's window drains."""
        if node.label is None:
            node.label = f"s{len(self._handles)}"
        if self.server is not None:
            h = self.server.submit(node, post=post, label=node.label)
            self._handles.append(h)
            return h
        h = Handle(node.label)
        self._nodes.append(node)
        self._posts.append(post)
        self._handles.append(h)
        return h

    def scan(self, agg, table: Table, *, columns=None, mask=None,
             block_size=None, engine: str = "auto",
             label: str | None = None, post=None) -> Handle:
        return self.statement(
            ScanAgg(agg, table, columns=columns, mask=mask,
                    block_size=block_size, engine=engine, label=label),
            post=post)

    def grouped_scan(self, agg, table, group_col=None, num_groups=None, *,
                     columns=None, mask=None, block_size=None,
                     method: str = "auto", label=None, post=None) -> Handle:
        return self.statement(
            GroupedScanAgg(agg, table, group_col, num_groups,
                           columns=columns, mask=mask,
                           block_size=block_size, method=method,
                           label=label), post=post)

    def joined_grouped_scan(self, agg, join, num_groups=None, *,
                            columns=None, mask=None, block_size=None,
                            method: str = "auto", mesh=None, row_axes=None,
                            label=None, post=None) -> Handle:
        """``SELECT dim.attr, agg(...) FROM fact JOIN dim GROUP BY
        dim.attr`` as one statement; ``join`` is a
        :class:`~repro_torch.core.join.Join`.  Statements over the same
        star triple fuse into ONE pass sharing the key resolution."""
        return self.statement(
            JoinedGroupedScanAgg(agg, join, num_groups, columns=columns,
                                 mask=mask, block_size=block_size,
                                 method=method, mesh=mesh,
                                 row_axes=row_axes, label=label),
            post=post)

    def fit(self, task, table=None, *, label=None, post=None,
            **kwargs) -> Handle:
        """An iterative fit (:class:`IterativeFit`) as a statement;
        ``kwargs`` are the node's fields (``group_col``, ``max_iters``,
        ``tol``, ``blocks`` and ``device`` for a stream fit, ...)."""
        return self.statement(IterativeFit(task, table, label=label,
                                           **kwargs), post=post)

    def stream_scan(self, agg, blocks, *, columns=None, label=None,
                    post=None, device=None) -> Handle:
        """A one-pass aggregate over a host-side block stream
        (:class:`StreamAgg`); statements over the same ``blocks`` object
        fold in ONE pass, with the state on ``device`` (the card unless
        ``device="cpu"``)."""
        return self.statement(StreamAgg(agg, blocks, columns=columns,
                                        label=label, device=device),
                              post=post)

    # -- living views -------------------------------------------------------
    def materialize(self, *nodes):
        """Retain statement(s) as a living view: the initial fold runs
        NOW (not batched with :meth:`run`), and the returned
        :class:`~repro_torch.core.materialize.MaterializedHandle`
        delta-folds appended rows on every later read.  On a
        server-attached session the view also answers matching
        statements of every session (a cache filler)."""
        h = materialize(nodes[0] if len(nodes) == 1 else list(nodes))
        self._materialized.append(h)
        if self.server is not None:
            self.server.register_view(h)
        return h

    def refresh(self) -> list:
        """Bring every living view issued through :meth:`materialize`
        current with its table and return their results, in issue
        order."""
        return [h.result() for h in self._materialized]

    def _derive(self, parts: list, combine: Callable):
        if self.server is not None:
            h = _DerivedHandle(f"d{len(self._derived)}", parts, combine)
            self._derived.append(h)
            return h
        h = Handle(f"d{len(self._derived)}")
        self._derived.append((h, parts, combine))
        return h

    # -- method sugar (lazy imports: methods build on core) ----------------
    def profile(self, table: Table, *, distinct_counts: bool = False,
                block_size=None) -> Handle:
        """Every statistic of ``profile`` as a statement of its own; the
        planner fuses them into one scan."""
        from ..methods.profile import _shape_results, profile_aggregates
        aggs = profile_aggregates(table, distinct_counts=distinct_counts)
        parts = [self.scan(agg, table, block_size=block_size,
                           label=f"profile:{name.strip('_')}")
                 for name, agg in aggs.items()]
        names = list(aggs)
        return self._derive(
            parts, lambda vals: _shape_results(dict(zip(names, vals))))

    def linregr(self, table: Table, *, x_col: str = "x", y_col: str = "y",
                block_size=None, use_kernel: bool | str = False) -> Handle:
        from ..methods.linregr import LinregrAggregate
        return self.scan(LinregrAggregate(use_kernel), table,
                         columns={"x": x_col, "y": y_col},
                         block_size=block_size, label="linregr")

    def naive_bayes(self, table: Table, num_classes: int, *,
                    x_col: str = "x", y_col: str = "y",
                    block_size=None) -> Handle:
        from ..methods.naive_bayes import NaiveBayesAggregate
        return self.scan(NaiveBayesAggregate(num_classes), table,
                         columns={"x": x_col, "y": y_col},
                         block_size=block_size, label="naive_bayes")

    def countmin_sketch(self, table: Table, *, depth: int = 4,
                        width: int = 1024, item_col: str = "item",
                        block_size=None) -> Handle:
        from ..methods.sketches import CountMinAggregate
        return self.scan(
            CountMinAggregate(depth, width, item_col=item_col), table,
            columns=(item_col,), block_size=block_size, label="countmin")

    def fm_distinct_count(self, table: Table, *, num_hashes: int = 8,
                          bits: int = 32, item_col: str = "item",
                          block_size=None) -> Handle:
        from ..methods.sketches import FMAggregate
        return self.scan(FMAggregate(num_hashes, bits, item_col=item_col),
                         table, columns=(item_col,), block_size=block_size,
                         label="fm_distinct")

    def logregr(self, table: Table, *, x_col: str = "x", y_col: str = "y",
                max_iters: int = 30, tol: float = 1e-6, block_size=None
                ) -> Handle:
        from ..methods.logregr import IRLSTask, _result
        t = Table({"x": table[x_col], "y": table[y_col]})
        return self.fit(IRLSTask(), t, max_iters=max_iters, tol=tol,
                        block_size=block_size, label="logregr",
                        post=_result)

    # -- planning & execution ----------------------------------------------
    def explain(self) -> str:
        """Render the physical plan of the pending batch (no execution).
        In server mode: the server's whole admission window, the batch
        shared across every attached session."""
        if self.server is not None:
            return self.server.explain()
        if not self._nodes:
            return "(empty batch)"
        return plan(self._nodes).explain()

    def run(self) -> list:
        """Plan and execute the pending batch; resolves every handle and
        returns the per-statement results in statement order.  The batch
        is consumed whether or not execution succeeds: a failed batch is
        discarded (its handles say so), never re-planned with the next
        one.  An empty batch returns ``[]``.  In server mode this drains
        the shared admission window and gathers this session's
        handles."""
        if self.server is not None:
            handles, self._handles = self._handles, []
            derived, self._derived = self._derived, []
            if not handles:
                return []
            self.server.flush()
            out = [h.result() for h in handles]
            for d in derived:
                d.result()
            return out
        if not self._nodes:
            self._derived = []
            return []
        try:
            pl = plan(self._nodes)
            self.last_plan = pl
            results = pl.execute()
            for h, post, res in zip(self._handles, self._posts, results):
                h._value = post(res) if post is not None else res
            for h, parts, combine in self._derived:
                h._value = combine([p.result() for p in parts])
            return [h.result() for h in self._handles]
        finally:
            for h in self._handles + [d for d, _, _ in self._derived]:
                if not h.done():
                    h._failed = True
            self._nodes, self._posts, self._handles = [], [], []
            self._derived = []
