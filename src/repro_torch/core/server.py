"""Analytics server: cross-session scan sharing behind admission windows.

The port's counterpart of the reference ``core/server.py``.  N analysts
profiling one table should cost ONE fused scan: MADlib runs analytics
inside the engine so concurrent submitters share its data movement
(§2, §3.2), and declarative statements can be regrouped, fused,
deduplicated and cached across submitters without changing their
answers.  This module points the planner at a statement *queue*:

* :class:`AnalyticsServer` is the long-lived front end.  Sessions built
  with ``Session(server=...)`` submit logical plan nodes; each submit
  returns a :class:`ServerHandle` at once.
* Statements wait in short **per-table admission windows**, each drained
  on its own (count ``window_size``, age ``window_timeout``, explicit
  :meth:`flush`, or on demand when a handle's ``result()`` is read).  A
  drain plans across sessions with :func:`repro_torch.core.plan.plan`
  unchanged, so compatible scans fuse into ONE pass whoever submitted
  them.  A joined statement windows by its fact table.
* ``drain="thread"`` runs a background drainer: ``window_timeout`` fires
  with no traffic, and each due window drains on its own short-lived
  worker.  ``drain="demand"`` (the default) drains on the submitting,
  polling or reading thread.
* Execution runs OUTSIDE the admission lock; a per-table drain lock
  serializes two drains of one table, different tables overlap.
* Statements whose :func:`~repro_torch.core.plan.semantic_fingerprint`
  match within one window are **deduplicated**: one member, every
  submitter answered.
* A **byte-budgeted result cache** keyed ``(table id, table version,
  semantic fingerprint)`` answers a repeated statement against an
  unchanged table with ZERO scans.  Admission and eviction are GDSF
  (priority = aging clock + cost / bytes, bytes counted as ``numel *
  element_size`` over the result's tensors, cost from the planner's
  pass cost), bounded by ``cache_bytes`` and ``cache_entries``.  The
  cache is probed at drain time, never at admission; ``Table.append``
  and ``invalidate`` bump the version and fire mutation hooks that
  evict the table's entries; the fill re-checks the version after
  execution, so a statement admitted before an append and drained after
  it misses.
* Living views (:func:`repro_torch.core.materialize.materialize`)
  **register as cache fillers** (:meth:`register_view`); the refresh
  kind is stated on the ``cache_hit`` event, and a view that had to
  rescan is not counted as a scan saved.

**One difference from the reference's structure, none from its
answers.** The reference hands one immutable JAX array tree to every
deduplicated submitter and to the cache.  torch tensors are mutable, so
a caller editing ``handle.result().coef`` in place would corrupt the
cache and every other submitter's answer.  Here every handle and every
cache answer receives its own copy (each tensor leaf cloned), and the
cache keeps a copy of a view's result; the values are the same bits.

On the card the drains launch on the current stream of the thread that
runs them, which for a new thread is the default stream: drains
serialize on the card and a reader sees finished tensors after its own
synchronize.  Kernels build once under their own lock.

Observability: every drain records a ``kind="admission"`` trace event
for its table (window size, statements planned after dedup and cache,
passes, ``scans_saved``, ``opened_at``/``drained_at``/``latency``), every
cache answer a ``kind="cache_hit"`` event with its refresh kind.

Thread safety: submits, flushes and reads may come from any thread.  The
admission lock guards window, cache and registry state only.  Hooked
tables are held by ``weakref`` with a finalizer (which may run on any
thread, takes only the admission lock and makes no CUDA call) that
purges a collected table's entries, so a long-lived server pins no
transient table and a recycled ``id`` can never match a live key.
Mutating a table while a drain scans it is the caller's race, as with
direct engine calls; the server only never *caches* across it.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map
from .plan import (
    GroupedScanAgg, JoinedGroupedScanAgg, ScanAgg, plan,
    semantic_fingerprint, node_tables as _node_tables,
)
from .table import Table
from .trace import record as _record

__all__ = ["AnalyticsServer", "ServerHandle"]

_UNSET = object()
_MISS = object()


class ServerHandle:
    """Async-style result of one submitted statement.

    Returned immediately by :meth:`AnalyticsServer.submit`;
    :meth:`result` drains the admission window holding the statement on
    demand, while :meth:`wait` blocks passively (no drain — the way to
    observe a background drainer doing its job).  Handles are resolved
    exactly once; repeated reads return the same value.
    """

    def __init__(self, label: str, server: "AnalyticsServer"):
        self.label = label
        self._server = server
        self._event = threading.Event()
        self._value: Any = _UNSET
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the statement resolves WITHOUT triggering a drain
        (unlike :meth:`result`); returns whether it did.  Only useful
        when something else drains — a background drain thread, another
        session's flush."""
        return self._event.wait(timeout)

    def _resolve(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float | None = None) -> Any:
        """The statement's value, draining its window on demand.

        An already-resolved handle returns immediately — no drain is
        triggered for other statements' benefit.  ``timeout`` bounds the
        WHOLE call: the demand drain (including waiting out another
        thread's in-flight drain of the same table) and the final wait
        share one deadline, so ``result(timeout=t)`` returns or raises
        :class:`TimeoutError` within ~``t`` seconds even when the server
        is busy executing.
        """
        if not self._event.is_set():
            if timeout is None:
                self._server.flush()
                self._event.wait()
            else:
                deadline = time.monotonic() + timeout
                self._server.flush(timeout=timeout)
                remaining = deadline - time.monotonic()
                if not self._event.wait(max(0.0, remaining)):
                    raise TimeoutError(
                        f"statement {self.label!r} still pending after "
                        f"{timeout}s")
        if self._error is not None:
            raise RuntimeError(
                f"statement {self.label!r} failed in its admission "
                f"window") from self._error
        return self._value


@dataclass
class _Pending:
    """One admitted statement awaiting its window drain."""

    node: Any                       # a logical plan node
    post: Callable | None
    handle: ServerHandle
    fp: tuple | None                # semantic fingerprint (None = opaque)
    table: Table | None             # base (admission) table


def _node_table(node) -> Table | None:
    """The statement's ADMISSION table — what its window keys on.  A
    joined statement windows by its FACT table (the scan side; the small
    dimension only shapes the group-id column), so fact appends drain it
    like any single-table statement.  Dimension-mutation staleness is
    handled one layer down: ``semantic_fingerprint`` refuses to cache
    any multi-table statement, so a join can never be answered from the
    result cache after only the dimension moved."""
    tables = _node_tables(node)
    return tables[0] if tables else None


class _Window:
    """One table's admission window: its queued statements, the time the
    oldest was admitted, and the drain lock that serializes this table's
    drains (snapshot + off-lock execution) against each other."""

    __slots__ = ("items", "opened", "drain_lock")

    def __init__(self):
        self.items: list[_Pending] = []
        self.opened: float | None = None
        self.drain_lock = threading.Lock()


@dataclass
class _CacheEntry:
    """One cached result with its GDSF accounting."""

    value: Any
    nbytes: int
    cost: float                     # planner cost hint (pass cost / members)
    prio: float                     # GDSF priority: clock + cost / nbytes


def _tree_nbytes(value) -> int:
    """Device-memory footprint of a cached result: ``numel *
    element_size`` summed over the tree's tensor leaves (other leaves
    count a word), as the reference sums ``nbytes``."""
    total = 0
    for leaf in tree_leaves(value):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += 8
    return max(total, 1)


def _copy(value) -> Any:
    """A result tree with every tensor leaf cloned: torch tensors are
    mutable, so no two handles (nor a handle and the cache) may share
    one."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, value)


class AnalyticsServer:
    """Long-lived cross-session statement service (see module docstring).

    ``window_size`` — per-table pending-statement count that auto-drains
    a window; ``window_timeout`` — seconds after which an open window
    drains (``None`` = count/demand only); ``drain`` — ``"demand"``
    (default: drains run on the submitting/polling/reading thread) or ``"thread"`` (a background drainer fires timeouts
    without traffic and dispatches each due window to its own worker);
    ``cache_bytes`` / ``cache_entries`` — result-cache budget in bytes
    of the results' tensors and in entries.

    ``stats`` tallies lifetime counters (submitted / windows / planned /
    deduped / cache_hits / view_hits / scans_saved / evicted /
    cache_evicted / cache_rejected / drain_errors) for serving
    dashboards; per-execution assertions should use the trace events
    instead.
    """

    def __init__(self, *, window_size: int = 32,
                 window_timeout: float | None = None,
                 drain: str = "demand",
                 cache_entries: int = 1024,
                 cache_bytes: int = 256 << 20):
        if window_size < 1:
            raise ValueError("window_size must be >= 1")
        if drain not in ("demand", "thread"):
            raise ValueError(f"drain must be 'demand' or 'thread', "
                             f"got {drain!r}")
        self.window_size = int(window_size)
        self.window_timeout = window_timeout
        self.drain = drain
        self.cache_entries = int(cache_entries)
        self.cache_bytes = int(cache_bytes)
        self._lock = threading.RLock()
        # per-table admission windows: id(table) (or None for tableless
        # statements) -> _Window
        self._windows: dict[Any, _Window] = {}
        self._seq = 0
        # (table id, table version, fingerprint) -> _CacheEntry
        self._cache: dict[tuple, _CacheEntry] = {}
        self._cache_used = 0            # bytes resident
        self._clock = 0.0               # GDSF aging clock
        # (table id, fingerprint) -> (MaterializedHandle, statement index)
        self._views: dict[tuple, tuple] = {}
        # weak refs to hooked tables: a long-lived server must not pin
        # transient tables; the finalizer purges a dead table's cache /
        # view / window entries (and the weakref bookkeeping) so its id
        # can never be recycled into a live cache key
        self._hooked: dict[int, weakref.ref] = {}
        self._finalizers: dict[int, weakref.finalize] = {}
        self.stats = {"submitted": 0, "windows": 0, "planned": 0,
                      "deduped": 0, "cache_hits": 0, "view_hits": 0,
                      "scans_saved": 0, "evicted": 0, "cache_evicted": 0,
                      "cache_rejected": 0, "drain_errors": 0}
        self._closing = False
        self._wake = threading.Event()
        self._workers: list[threading.Thread] = []
        self._drainer: threading.Thread | None = None
        if drain == "thread":
            self._drainer = threading.Thread(
                target=self._drain_loop, daemon=True,
                name="analytics-drainer")
            self._drainer.start()

    # -- admission ---------------------------------------------------------
    def submit(self, node, *, post: Callable | None = None,
               label: str | None = None) -> ServerHandle:
        """Admit one logical plan node; returns its handle immediately.
        The statement executes when ITS TABLE's window drains (count
        threshold, timeout, explicit :meth:`flush`, a demanded
        ``result()``, or the background drainer).  The admission itself
        never blocks on an in-flight drain — at most it performs a
        demand-mode drain of a window that just became due."""
        table = _node_table(node)
        key = id(table) if table is not None else None
        fp = semantic_fingerprint(node)
        with self._lock:
            name = label or getattr(node, "label", None) or f"q{self._seq}"
            self._seq += 1
            handle = ServerHandle(name, self)
            if fp is not None and table is not None:
                self._hook_table(table)
            win = self._windows.setdefault(key, _Window())
            now = time.monotonic()
            opened_now = not win.items
            if opened_now:
                win.opened = now
            win.items.append(_Pending(node, post, handle, fp, table))
            self.stats["submitted"] += 1
            due = (len(win.items) >= self.window_size
                   or (self.window_timeout is not None
                       and now - win.opened >= self.window_timeout))
        threaded = self._drainer is not None and self._drainer.is_alive()
        if due:
            if threaded:
                self._wake.set()
            else:
                # nowait: if this table's drain is in-flight on another
                # thread, ITS refill loop picks these statements up — a
                # submit never blocks behind an executing drain
                self._drain_key(key, nowait=True)
        elif threaded and opened_now and self.window_timeout is not None:
            self._wake.set()        # new window: recompute the deadline
        if not threaded and self.window_timeout is not None:
            self.poll()             # other tables' overdue windows
        return handle

    def poll(self) -> int:
        """Drain every window whose timeout has expired (demand-mode
        serving loops call this between accepts; with ``drain="thread"``
        the background drainer makes it redundant); returns statements
        drained."""
        if self.window_timeout is None:
            return 0
        with self._lock:
            now = time.monotonic()
            due = [k for k, w in self._windows.items()
                   if w.items and w.opened is not None
                   and now - w.opened >= self.window_timeout]
        return sum(self._drain_key(k, nowait=True) for k in due)

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(w.items) for w in self._windows.values())

    # -- the drain ---------------------------------------------------------
    def flush(self, timeout: float | None = None) -> int:
        """Drain EVERY admission window: answer what the cache (or a
        registered view) can, dedup same-fingerprint statements, plan
        each window as ONE cross-session batch, execute, route results
        to their handles, and fill the cache.  Waits out in-flight
        drains (their statements are resolved when this returns), so a
        plain ``flush()`` still means "everything admitted before this
        call has settled".  ``timeout`` bounds the whole call — windows
        whose drain lock cannot be acquired before the deadline are
        skipped.  Returns the number of statements drained by THIS
        call."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            keys = [k for k, w in self._windows.items()
                    if w.items or w.drain_lock.locked()]
        return sum(self._drain_key(k, deadline=deadline) for k in keys)

    def _drain_key(self, key, deadline: float | None = None,
                   nowait: bool = False) -> int:
        """Drain one table's window (and any count-due refill that
        accumulated while its execution ran off-lock).  Serializes with
        other drains of the SAME table via the window's drain lock;
        different tables' drains overlap freely.  ``nowait`` skips
        instead of waiting for an in-flight drain — safe for submit/poll
        triggers because the in-flight drain's refill loop re-checks the
        window AFTER releasing the lock, so it picks these items up."""
        win = self._windows.get(key)
        drained = 0
        while win is not None:
            if nowait:
                if not win.drain_lock.acquire(blocking=False):
                    return drained
            elif deadline is None:
                win.drain_lock.acquire()
            elif not win.drain_lock.acquire(
                    timeout=max(0.0, deadline - time.monotonic())):
                return drained
            try:
                with self._lock:
                    batch = win.items
                    win.items = []
                    opened = win.opened
                    win.opened = None
                if not batch:
                    return drained
                drained += self._run_window(key, batch, opened)
            finally:
                win.drain_lock.release()
            # A window may have refilled PAST a drain trigger while we
            # executed (submits stay non-blocking during a drain); loop
            # so count/timeout-due statements never strand.
            with self._lock:
                now = time.monotonic()
                refilled = bool(win.items) and (
                    len(win.items) >= self.window_size
                    or (self.window_timeout is not None
                        and win.opened is not None
                        and now - win.opened >= self.window_timeout))
            if not refilled:
                return drained
        return drained

    def _run_window(self, key, batch: list[_Pending],
                    opened: float | None) -> int:
        """Execute one snapshotted window OFF the admission lock (the
        caller holds only the window's drain lock)."""
        t_drain = time.monotonic()
        with self._lock:
            self.stats["windows"] += 1

        to_plan: list[_Pending] = []
        rep_of: dict[tuple, int] = {}    # dedup key -> to_plan index
        routes: list[tuple[_Pending, int]] = []
        hits = deduped = view_rescans = 0
        for p in batch:
            if p.fp is not None and p.table is not None:
                tid = id(p.table)
                # version re-check happens HERE, at execute time: the
                # key carries the table's *current* version, so an
                # entry probed against a table mutated mid-window can
                # only miss — the statement replans below.
                val, rescans = self._answer(tid, p.table, p.fp)
                if val is not _MISS:
                    hits += 1
                    view_rescans += rescans
                    self._resolve(p, val)
                    continue
                dkey = (tid, p.fp)
                if dkey in rep_of:
                    deduped += 1
                    with self._lock:
                        self.stats["deduped"] += 1
                    routes.append((p, rep_of[dkey]))
                    continue
                rep_of[dkey] = len(to_plan)
            routes.append((p, len(to_plan)))
            to_plan.append(p)

        # versions at plan time, for the post-execution cache fill
        fill = [(j, p, id(p.table), p.table.version)
                for j, p in enumerate(to_plan)
                if p.fp is not None and p.table is not None]
        n_scan_stmts = sum(
            isinstance(p.node,
                       (ScanAgg, GroupedScanAgg, JoinedGroupedScanAgg))
            for p in batch)
        try:
            pl = plan([p.node for p in to_plan])
            scan_passes = sum(1 for ps in pl.passes
                              if ps.kind in ("scan", "grouped", "join"))
            # a view answer that had to RESCAN is not a scan saved —
            # the data movement happened, just inside the hit path
            scans_saved = max(
                0, n_scan_stmts - scan_passes - view_rescans)
            _record("admission", None, table=key, window=len(batch),
                    planned=len(to_plan), deduped=deduped,
                    cache_hits=hits, passes=len(pl.passes),
                    scans_saved=scans_saved, view_rescans=view_rescans,
                    opened_at=opened, drained_at=t_drain,
                    latency=0.0 if opened is None else t_drain - opened)
            with self._lock:
                self.stats["planned"] += len(to_plan)
                self.stats["scans_saved"] += scans_saved
            # planner cost hints, amortized per member — the cache
            # admission policy's "how expensive is this to recompute"
            cost_of: dict[int, float] = {}
            for ps in pl.passes:
                if ps.cost is None:
                    continue
                share = float(ps.cost) / max(len(ps.members), 1)
                for i, _ in ps.members:
                    cost_of[i] = share
            results = pl.execute()
        except BaseException as e:
            # an execution/planning error belongs to the WHOLE batch:
            # every handle fails with it (and a synchronous flush caller
            # sees it re-raised; the background drainer counts it)
            for p, _ in routes:
                p.handle._fail(e)
            raise
        with self._lock:
            for j, p, tid, version in fill:
                # fill only if the table did not move during execution —
                # a mid-flight mutation makes the scanned rows ambiguous
                if p.table.version == version:
                    self._cache_put((tid, version, p.fp), results[j],
                                    cost=cost_of.get(j, 1.0))
        for p, j in routes:
            self._resolve(p, results[j])
        return len(batch)

    def _resolve(self, p: _Pending, raw: Any) -> None:
        """Apply the submitter's post and settle the handle.  A failing
        post fails ONLY its own handle — it is the submitter's callback,
        so its exception surfaces on the submitter's ``result()``, never
        on whoever happened to trigger the drain, and never on the other
        handles in the window."""
        try:
            raw = _copy(raw)
            value = p.post(raw) if p.post is not None else raw
        except Exception as e:
            p.handle._fail(e)
            return
        p.handle._resolve(value)

    # -- the background drainer --------------------------------------------
    def _drain_loop(self) -> None:
        """Dedicated drain thread: sleeps until the earliest open
        window's deadline (or a wake signal: new window, count-due
        submit, close), then dispatches each due window to its own
        worker so one table's slow drain never delays another's."""
        while not self._closing:
            timeout = None
            if self.window_timeout is not None:
                with self._lock:
                    opens = [w.opened for w in self._windows.values()
                             if w.items and w.opened is not None]
                if opens:
                    timeout = max(
                        0.0,
                        min(opens) + self.window_timeout - time.monotonic())
            self._wake.wait(timeout)
            self._wake.clear()
            if self._closing:
                return
            with self._lock:
                now = time.monotonic()
                due = [k for k, w in self._windows.items()
                       if w.items and not w.drain_lock.locked()
                       and (len(w.items) >= self.window_size
                            or (self.window_timeout is not None
                                and w.opened is not None
                                and now - w.opened >= self.window_timeout))]
            for k in due:
                self._spawn_drain(k)

    def _spawn_drain(self, key) -> None:
        def work():
            try:
                self._drain_key(key)
            except Exception:
                # already routed to every handle in the failed window;
                # the drainer itself must survive a poisoned statement
                with self._lock:
                    self.stats["drain_errors"] += 1

        th = threading.Thread(target=work, daemon=True,
                              name=f"analytics-drain-{key}")
        with self._lock:
            self._workers = [w for w in self._workers if w.is_alive()]
            self._workers.append(th)
        th.start()

    # -- the result cache --------------------------------------------------
    def _answer(self, tid: int, table: Table, fp: tuple):
        """Cache-or-view answer for (table @ current version, fp) as
        ``(value, rescans)``, or ``(_MISS, 0)``.  View refreshes run OFF
        the admission lock (they may delta-fold or rescan); ``rescans``
        is 1 when the view had to fully rescan — the honest input to the
        ``scans_saved`` accounting.  Records the ``cache_hit`` trace
        event (with its refresh kind) on a hit."""
        with self._lock:
            ent = self._cache.get((tid, table.version, fp))
            if ent is not None:
                ent.prio = self._clock + ent.cost / ent.nbytes
                self.stats["cache_hits"] += 1
                _record("cache_hit", None, source="cache", refresh="none",
                        table_version=table.version)
                return ent.value, 0
            view = self._views.get((tid, fp))
        if view is None:
            return _MISS, 0
        handle, idx = view
        # refresh + finalize OFF the lock: appends delta-fold
        # (kind="delta" in the trace — still zero scans); an invalidated
        # table forces a FULL RESCAN inside the handle.  Either way the
        # answer is current and gets cached at the version the handle
        # pins — and the refresh kind is surfaced, not laundered.
        kind = handle.refresh()
        vals = handle.result(refresh=False)
        vals = vals if isinstance(vals, list) else [vals]
        val = _copy(vals[idx])   # the view's owner holds the original
        with self._lock:
            self._cache_put((tid, handle.version, fp), val,
                            cost=float(handle.table.n_rows))
            self.stats["cache_hits"] += 1
            self.stats["view_hits"] += 1
        _record("cache_hit", None, source="view", refresh=kind,
                table_version=handle.version)
        return val, (1 if kind == "rescan" else 0)

    def _cache_put(self, key: tuple, value: Any, *,
                   cost: float = 1.0) -> None:
        """Size/cost-aware admission (GDSF): an entry's priority is the
        aging clock plus ``cost / bytes``, evictions pop the minimum
        priority and advance the clock to it.  A cheap-to-recompute
        giant therefore evicts FIRST (often immediately — effectively
        refused admission) instead of flushing many small expensive
        results; anything larger than the whole budget is rejected
        outright.  Caller holds the admission lock."""
        nbytes = _tree_nbytes(value)
        if nbytes > self.cache_bytes:
            self.stats["cache_rejected"] += 1
            return
        old = self._cache.pop(key, None)
        if old is not None:
            self._cache_used -= old.nbytes
        self._cache[key] = _CacheEntry(
            value, nbytes, float(cost), self._clock + float(cost) / nbytes)
        self._cache_used += nbytes
        while (self._cache_used > self.cache_bytes
               or len(self._cache) > self.cache_entries):
            victim = min(self._cache, key=lambda k: self._cache[k].prio)
            ent = self._cache.pop(victim)
            self._cache_used -= ent.nbytes
            self._clock = ent.prio
            self.stats["cache_evicted"] += 1

    def _hook_table(self, table: Table) -> None:
        tid = id(table)
        if tid not in self._hooked:
            table.on_mutation(self._evict)
            self._hooked[tid] = weakref.ref(table)
            self._finalizers[tid] = weakref.finalize(
                table, AnalyticsServer._table_died, weakref.ref(self), tid)

    @staticmethod
    def _table_died(server_ref, tid: int) -> None:
        """Finalizer for a hooked table: purge every server entry keyed
        by its (about to be recycled) id.  Static + weak so the
        finalizer pins neither the table nor the server."""
        srv = server_ref()
        if srv is None:
            return
        with srv._lock:
            srv._hooked.pop(tid, None)
            srv._finalizers.pop(tid, None)
            srv._drop_table_entries(tid)
            win = srv._windows.get(tid)
            if win is not None and not win.items \
                    and not win.drain_lock.locked():
                del srv._windows[tid]

    def _drop_table_entries(self, tid: int) -> None:
        """Drop cache entries and view registrations for a table id.
        Caller holds the admission lock."""
        for k in [k for k in self._cache if k[0] == tid]:
            self._cache_used -= self._cache.pop(k).nbytes
        for vk in [vk for vk in self._views if vk[0] == tid]:
            del self._views[vk]

    def _evict(self, table: Table) -> None:
        """Mutation hook: drop every cache entry for the mutated table.
        (All of them are dead — the version just bumped, so no remaining
        key can match a future probe.)"""
        with self._lock:
            tid = id(table)
            dead = [k for k in self._cache if k[0] == tid]
            for k in dead:
                self._cache_used -= self._cache.pop(k).nbytes
            self.stats["evicted"] += len(dead)

    def register_view(self, handle) -> None:
        """Register a :class:`~repro_torch.core.materialize.MaterializedHandle`
        as a cache filler: statements whose semantic fingerprint matches
        one of the view's retained statements are answered from its fold
        state (delta-refreshed across appends) instead of scanning.
        ``Session.materialize`` on a server-attached session registers
        automatically."""
        with self._lock:
            self._hook_table(handle.table)
            for i, node in enumerate(handle.nodes):
                fp = semantic_fingerprint(node)
                if fp is not None:
                    self._views[(id(handle.table), fp)] = (handle, i)

    def clear_cache(self) -> None:
        """Drop every cached result (registered views stay)."""
        with self._lock:
            self._cache.clear()
            self._cache_used = 0

    # -- introspection & lifecycle -----------------------------------------
    def explain(self) -> str:
        """Render what draining the current windows WOULD do — cache
        answers, dedup, and the cross-session physical plan — without
        executing (the serving analogue of ``Session.explain``).  All
        per-table windows render as one combined batch; cross-table
        statements never fuse, so the passes shown are exactly the
        per-window drains' union."""
        with self._lock:
            pending = [p for w in self._windows.values() for p in w.items]
            if not pending:
                return "(empty batch)"
            hits = deduped = 0
            seen: set = set()
            uniq = []
            for p in pending:
                if p.fp is not None and p.table is not None:
                    tid = id(p.table)
                    if ((tid, p.table.version, p.fp) in self._cache
                            or (tid, p.fp) in self._views):
                        hits += 1
                        continue
                    dkey = (tid, p.fp)
                    if dkey in seen:
                        deduped += 1
                        continue
                    seen.add(dkey)
                uniq.append(p.node)
            head = (f"admission window: {len(pending)} submitted, "
                    f"{hits} cache-answerable, {deduped} deduped -> "
                    f"{len(uniq)} planned")
            if not uniq:
                return head
            return head + "\n" + plan(uniq).explain()

    def close(self) -> None:
        """Stop the background drainer (if any), drain every window,
        deregister every table eviction hook and drop the cache/view
        registries.  The server object stays usable for demand-mode
        drains afterwards (tables re-hook on the next submit), but the
        background drainer does NOT restart — ``close()`` is the polite
        end of a serving run."""
        self._closing = True
        self._wake.set()
        if self._drainer is not None:
            self._drainer.join(timeout=10.0)
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            w.join(timeout=10.0)
        self.flush()
        with self._lock:
            for tid, ref in list(self._hooked.items()):
                t = ref()
                if t is not None:
                    t.remove_mutation_hook(self._evict)
                fin = self._finalizers.pop(tid, None)
                if fin is not None:
                    fin.detach()
            self._hooked.clear()
            self._cache.clear()
            self._cache_used = 0
            self._views.clear()

    def __enter__(self) -> "AnalyticsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
