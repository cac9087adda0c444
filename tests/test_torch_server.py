"""The port's analytics server against the JAX package's.

The same numpy tables (dyadic draws, ``tests/strategies.py``) and the
same submit scripts go through ``repro.core.server`` and
``repro_torch.core.server`` on the CPU, in ``drain="demand"`` mode, where
a script's windows drain at the same points in both.  Per window the
``admission`` details (window, planned, deduped, cache hits, passes,
``scans_saved``, view rescans), the ``cache_hit`` sources and refresh
kinds, the lifetime stats and the GDSF cache's resident set after each
fill must be equal; results allclose (rtol 1e-5) to the reference's,
and bitwise equal to a fresh local ``Session`` run in the port.

The port's own contracts follow the reference's ``tests/test_serve.py``:
threaded submitters, mutation races, living views as cache fillers,
lifecycle, the background drainer, per-table windows, weak table hooks;
and one of its own: every handle gets its own copy of a result.  Every
wait is bounded (``result(timeout=...)``, ``wait(timeout)`` with an
assert, daemon threads) and every server is closed in ``finally``.
"""

import gc
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.plan import semantic_fingerprint as jsemantic_fingerprint
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro_torch.core import (
    AnalyticsServer, GroupedScanAgg, ScanAgg, Session, Table, execute,
    trace_execution,
)
from repro_torch.core.aggregates import MERGE_SUM, Aggregate
from repro_torch.core.plan import semantic_fingerprint
from repro_torch.core.templates import ProfileAggregate
from repro_torch.methods.linregr import LinregrAggregate
from repro_torch.methods.sketches import CountMinAggregate, FMAggregate
from strategies import Draw, cases, group_layout

J = SimpleNamespace(
    table=jcore.Table.from_columns, col=jnp.asarray,
    Server=jcore.AnalyticsServer, Session=jcore.Session,
    ScanAgg=jcore.ScanAgg, GroupedScanAgg=jcore.GroupedScanAgg,
    trace=jcore.trace_execution, fp=jsemantic_fingerprint,
    LR=JLinregrAggregate, CM=JCountMinAggregate)
T = SimpleNamespace(
    table=lambda c: Table.from_columns(c, device="cpu"),
    col=torch.from_numpy, Server=AnalyticsServer, Session=Session,
    ScanAgg=ScanAgg, GroupedScanAgg=GroupedScanAgg,
    trace=trace_execution, fp=semantic_fingerprint,
    LR=LinregrAggregate, CM=CountMinAggregate)

ADMISSION_KEYS = ("window", "planned", "deduped", "cache_hits", "passes",
                  "scans_saved", "view_rescans")


def _cols(draw: Draw, n: int, d: int = 3, groups: int = 4):
    gids, _ = group_layout(draw, n, groups, "uniform")
    return {"x": draw.dyadic((n, d)), "y": draw.dyadic((n,)),
            "item": draw.ints((n,), 0, 40), "g": gids}


def _delta(draw: Draw, m: int, d: int = 3, groups: int = 4):
    return {"x": draw.dyadic((m, d)), "y": draw.dyadic((m,)),
            "item": draw.ints((m,), 0, 40),
            "g": draw.ints((m,), 0, groups - 1)}


def _table(draw, n=512):
    return Table.from_columns(_cols(draw, n), device="cpu")


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _flat(t)]
    if hasattr(tree, "__dataclass_fields__"):
        return [v for f in tree.__dataclass_fields__
                for v in _flat(getattr(tree, f))]
    return [np.asarray(tree)]


def _bitwise(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(fa, fb))


def _close(a, b, what="") -> None:
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb), what
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=what)


class _GatedAggregate(Aggregate):
    """A deterministically slow aggregate: its transition blocks on an
    Event (one call per scan with ``block_size=None``)."""

    merge_ops = MERGE_SUM

    def __init__(self, started=None, release=None):
        self.started = started
        self.release = release

    def init(self, block):
        return torch.zeros((), dtype=torch.float32, device=block["y"].device)

    def transition(self, state, block, mask):
        if self.started is not None:
            self.started.set()
        if self.release is not None and not self.release.wait(60):
            raise RuntimeError("gated transition never released")
        return state + torch.where(mask, block["y"], 0.0).sum()


def _gated_node(table, started=None, release=None):
    return ScanAgg(_GatedAggregate(started, release), table, columns=("y",))


# ---------------------------------------------------------------------------
# The same scripts through both packages
# ---------------------------------------------------------------------------

def _script(P, cols, steps):
    """Run a submit script on a demand-mode server; returns per-flush
    admission details and cache-hit kinds, the lifetime stats and the
    results by step."""
    t = P.table(cols)
    srv = P.Server(window_size=1024)
    out = {"admissions": [], "hits": [], "results": []}
    try:
        sessions = [P.Session(server=srv) for _ in range(4)]
        for step in steps:
            kind = step[0]
            if kind == "append":
                t.append(step[1])
                continue
            if kind == "invalidate":
                t.columns["item"] = P.col(step[1].copy())
                t.invalidate()
                continue
            if kind == "view":
                owner = P.Session(server=srv)
                owner.materialize(P.ScanAgg(P.CM(4, 1024), t,
                                            columns=("item",)))
                continue
            handles = []
            for i, stmt in enumerate(step[1]):
                s = sessions[i % len(sessions)]
                if stmt == "linregr":
                    handles.append(s.linregr(t))
                elif stmt == "countmin":
                    handles.append(s.countmin_sketch(t))
                elif stmt == "fm":
                    handles.append(s.fm_distinct_count(t))
                elif stmt == "profile":
                    handles.append(s.profile(t))
                elif stmt == "grouped":
                    handles.append(s.statement(P.GroupedScanAgg(
                        P.LR(), t, "g", 4, columns=("x", "y"))))
                elif stmt == "masked":
                    handles.append(s.statement(P.ScanAgg(
                        P.LR(), t, columns=("x", "y"),
                        mask=P.col(np.arange(t.n_rows) % 3 == 0))))
            with P.trace() as tr:
                srv.flush()
            out["admissions"].append([tuple(e.detail[k]
                                            for k in ADMISSION_KEYS)
                                      for e in tr.admissions])
            out["hits"].append([(e.detail["source"], e.detail["refresh"])
                                for e in tr.cache_hits])
            out["results"].append([h.result(timeout=60) for h in handles])
        out["stats"] = dict(srv.stats)
    finally:
        srv.close()
    return out, t


SCRIPTS = {
    "fuse-dedup-cache": [
        ("round", ["linregr", "countmin", "fm", "profile"] * 3),
        ("round", ["linregr", "countmin", "fm", "profile"] * 2),
    ],
    "append-replans": [
        ("round", ["linregr", "countmin", "grouped"]),
        ("append", None),
        ("round", ["linregr", "countmin", "grouped", "grouped"]),
        ("round", ["countmin", "linregr"]),
    ],
    "masked-bypasses": [
        ("round", ["masked", "masked", "linregr"]),
        ("round", ["masked", "linregr"]),
    ],
    "view-fills": [
        ("view",),
        ("round", ["countmin", "countmin", "fm"]),
        ("append", None),
        ("round", ["countmin", "fm"]),
        ("invalidate", None),
        ("round", ["countmin"]),
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_telemetry_equals_the_reference(name):
    draw = Draw(101)
    cols = _cols(draw, 384)
    steps = []
    for step in SCRIPTS[name]:
        if step[0] == "append":
            steps.append(("append", _delta(draw, 40)))
        elif step[0] == "invalidate":
            steps.append(("invalidate", draw.ints((424,), 0, 40)))
        else:
            steps.append(step)
    got, t = _script(T, cols, steps)
    want, _ = _script(J, cols, steps)
    assert got["admissions"] == want["admissions"]
    assert got["hits"] == want["hits"]
    assert got["stats"] == want["stats"]
    for r, (gs, ws) in enumerate(zip(got["results"], want["results"])):
        for g, w in zip(gs, ws):
            _close(g, w, f"{name} round {r}")
    # the last round's answers (cached or scanned) against a fresh local
    # Session over the same table, bitwise
    last = [s for s in steps if s[0] == "round"][-1][1]
    sess = Session()
    fresh = []
    for stmt in last:
        if stmt == "grouped":
            fresh.append(sess.statement(GroupedScanAgg(
                LinregrAggregate(), t, "g", 4, columns=("x", "y"))))
        elif stmt != "masked":
            fresh.append({"linregr": sess.linregr,
                          "countmin": sess.countmin_sketch,
                          "fm": sess.fm_distinct_count,
                          "profile": sess.profile}[stmt](t))
        else:
            fresh.append(None)
    sess.run()
    for h, g in zip(fresh, got["results"][-1]):
        if h is not None:
            assert _bitwise(g, h.result()), name


def _gdsf_run(P, cols, budget):
    """Fill a byte-budgeted cache statement by statement; the resident
    set (statement names) after each fill."""
    t = P.table(cols)
    srv = P.Server(window_size=1, cache_bytes=budget)
    names = {}
    resident = []
    try:
        s = P.Session(server=srv)
        for name, node in (
                ("linregr", P.ScanAgg(P.LR(), t, columns=("x", "y"))),
                ("countmin", P.ScanAgg(P.CM(4, 1024), t,
                                       columns=("item",))),
                ("grouped", P.GroupedScanAgg(P.LR(), t, "g", 4,
                                             columns=("x", "y"))),
                ("cm-small", P.ScanAgg(P.CM(2, 64), t,
                                       columns=("item",))),
                ("linregr-x", P.ScanAgg(P.LR(), t,
                                        columns={"x": "x", "y": "item"}))):
            names[P.fp(node)] = name
            s.statement(node).result(timeout=60)
            resident.append(sorted(names[k[2]] for k in srv._cache))
        stats = dict(srv.stats)
    finally:
        srv.close()
    return resident, stats


@pytest.mark.parametrize("budget", [300, 900, 17_000])
def test_gdsf_eviction_order_equals_the_reference(budget):
    cols = _cols(Draw(103), 256)
    cols["item"] = cols["item"].astype(np.float32)
    got = _gdsf_run(T, cols, budget)
    want = _gdsf_run(J, cols, budget)
    assert got == want


def test_server_explain_equals_the_reference():
    cols = _cols(Draw(105), 256)
    texts = []
    for P in (T, J):
        t = P.table(cols)
        srv = P.Server(window_size=1024)
        try:
            s1, s2 = P.Session(server=srv), P.Session(server=srv)
            s1.linregr(t)
            s2.linregr(t)
            s2.countmin_sketch(t)
            s1.statement(P.GroupedScanAgg(P.LR(), t, "g", 4,
                                          columns=("x", "y")))
            texts.append(s1.explain())
        finally:
            srv.close()
    assert texts[0] == texts[1]
    assert "4 submitted, 0 cache-answerable, 1 deduped" in texts[0]


# ---------------------------------------------------------------------------
# The port's own contracts (after the reference's tests/test_serve.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def table():
    return _table(Draw(7))


def _solo_linregr(table):
    return execute(ScanAgg(LinregrAggregate(), table, columns=("x", "y")))


class TestWindowSharing:
    def test_cross_session_statements_fuse_into_one_scan(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            hs = []
            with trace_execution() as t:
                for s in [Session(server=srv) for _ in range(4)]:
                    hs.append(s.linregr(table))
                    hs.append(s.countmin_sketch(table))
                srv.flush()
            assert len(t.scans) == 1 and len(t.admissions) == 1
            ev = t.admissions[0].detail
            assert ev["window"] == 8 and ev["passes"] == 1
            assert ev["scans_saved"] == 7
            solo = _solo_linregr(table)
            for h in hs[::2]:
                assert _bitwise(h.result(timeout=10).coef, solo.coef)
        finally:
            srv.close()

    def test_count_threshold_auto_drains(self, table):
        srv = AnalyticsServer(window_size=2)
        try:
            h1 = Session(server=srv).linregr(table)
            assert not h1.done() and srv.pending == 1
            h2 = Session(server=srv).countmin_sketch(table)
            assert h1.done() and h2.done() and srv.pending == 0
        finally:
            srv.close()

    def test_timeout_drains_at_next_submit(self, table):
        srv = AnalyticsServer(window_size=1024, window_timeout=0.0)
        try:
            s = Session(server=srv)
            h1 = s.linregr(table)
            h2 = s.fm_distinct_count(table)
            assert h1.done()
            assert srv.poll() >= 0
            h2.result(timeout=10)
        finally:
            srv.close()

    def test_session_run_gathers_own_handles(self, table):
        srv = AnalyticsServer(window_size=1024)
        try:
            s1, s2 = Session(server=srv), Session(server=srv)
            s1.linregr(table)
            other = s2.fm_distinct_count(table)
            assert len(s1.run()) == 1
            assert other.done()
        finally:
            srv.close()

    def test_profile_derived_handle(self, table):
        srv = AnalyticsServer(window_size=1024)
        try:
            h = Session(server=srv).profile(table, distinct_counts=True)
            stats = h.result(timeout=30)
            solo = execute(ScanAgg(ProfileAggregate(), table))
            assert _bitwise(stats["x"]["sum"], solo["x"]["sum"])
        finally:
            srv.close()

    def test_threaded_submitters_share_windows(self, table):
        srv = AnalyticsServer(window_size=1024)
        results = [None] * 8
        try:
            def worker(i):
                results[i] = Session(server=srv).linregr(table).result(
                    timeout=60)

            threads = [threading.Thread(target=worker, args=(i,),
                                        daemon=True) for i in range(8)]
            with trace_execution() as t:
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(60)
                    assert not th.is_alive()
            solo = _solo_linregr(table)
            for r in results:
                assert _bitwise(r.coef, solo.coef)
            assert len(t.scans) <= len(t.admissions)
        finally:
            srv.close()


class TestCopies:
    def test_in_place_edit_of_one_answer_leaves_the_rest(self, table):
        """torch tensors are mutable: each submitter and each cache hit
        gets its own copy, so an in-place edit reaches no other answer."""
        srv = AnalyticsServer(window_size=64)
        try:
            hs = [Session(server=srv).linregr(table) for _ in range(3)]
            cms = [Session(server=srv).countmin_sketch(table)
                   for _ in range(2)]
            srv.flush()
            solo = _solo_linregr(table)
            hs[0].result().coef.add_(1.0)
            cms[0].result().zero_()
            assert _bitwise(hs[1].result().coef, solo.coef)
            assert bool(cms[1].result().any())
            with trace_execution() as t:
                again = Session(server=srv).linregr(table)
                cm_again = Session(server=srv).countmin_sketch(table)
                srv.flush()
            assert len(t.cache_hits) == 2 and len(t.scans) == 0
            assert _bitwise(again.result().coef, solo.coef)
            assert torch.equal(cm_again.result(), cms[1].result())
            again.result().coef.zero_()
            third = Session(server=srv).linregr(table)
            assert _bitwise(third.result(timeout=10).coef, solo.coef)
        finally:
            srv.close()

    def test_view_answers_are_copies(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            view = Session(server=srv).materialize(ScanAgg(
                CountMinAggregate(4, 1024), table, columns=("item",)))
            h = Session(server=srv).countmin_sketch(table)
            got = h.result(timeout=10)
            got.zero_()
            assert bool(view.result().any())
            assert bool(Session(server=srv).countmin_sketch(table)
                        .result(timeout=10).any())
        finally:
            srv.close()


class TestResultCache:
    def test_grouped_statement_caches_with_zero_sorts(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            s = Session(server=srv)
            h1 = s.statement(GroupedScanAgg(LinregrAggregate(), table, "g",
                                            4, columns=("x", "y")))
            srv.flush()
            with trace_execution() as t:
                h2 = s.statement(GroupedScanAgg(LinregrAggregate(), table,
                                                "g", 4, columns=("x", "y")))
                srv.flush()
            assert len(t.scans) == 0 and len(t.sorts) == 0
            assert len(t.cache_hits) == 1
            assert _bitwise(h1.result().coef, h2.result().coef)
        finally:
            srv.close()

    def test_masked_statement_has_no_fingerprint(self, table):
        node = ScanAgg(LinregrAggregate(), table, columns=("x", "y"),
                       mask=torch.ones(table.n_rows, dtype=torch.bool))
        assert semantic_fingerprint(node) is None

    def test_fingerprints_equal_across_instances(self, table):
        a = ScanAgg(CountMinAggregate(4, 1024), table, columns=("item",))
        b = ScanAgg(CountMinAggregate(4, 1024), table, columns=("item",))
        c = ScanAgg(CountMinAggregate(4, 512), table, columns=("item",))
        assert semantic_fingerprint(a) == semantic_fingerprint(b)
        assert semantic_fingerprint(a) != semantic_fingerprint(c)
        view = GroupedScanAgg(LinregrAggregate(), table.group_by("g", 4))
        assert semantic_fingerprint(view) is None

    def test_clear_cache_forces_rescan(self, table):
        srv = AnalyticsServer(window_size=1)
        try:
            s = Session(server=srv)
            s.linregr(table)
            srv.clear_cache()
            with trace_execution() as t:
                s.linregr(table)
            assert len(t.scans) == 1 and len(t.cache_hits) == 0
        finally:
            srv.close()

    def test_entry_and_byte_bounds(self, table):
        srv = AnalyticsServer(window_size=1, cache_entries=2)
        try:
            s = Session(server=srv)
            s.linregr(table)
            s.countmin_sketch(table)
            s.fm_distinct_count(table)
            assert len(srv._cache) <= 2
        finally:
            srv.close()
        srv = AnalyticsServer(cache_bytes=64)
        try:
            with srv._lock:
                srv._cache_put((0, 0, ("big",)), torch.zeros(100))
            assert len(srv._cache) == 0
            assert srv.stats["cache_rejected"] == 1
        finally:
            srv.close()


class TestMutationRaces:
    def test_append_lands_between_admission_and_drain(self):
        for draw in cases(3, base_seed=21):
            tbl = _table(draw, 256)
            srv = AnalyticsServer(window_size=1024)
            try:
                s = Session(server=srv)
                s.linregr(tbl)
                srv.flush()
                h = s.linregr(tbl)
                tbl.append(_delta(draw, draw.integers(8, 64)))
                with trace_execution() as t:
                    srv.flush()
                assert len(t.cache_hits) == 0 and len(t.scans) == 1
                assert _bitwise(h.result().coef, _solo_linregr(tbl).coef)
            finally:
                srv.close()

    def test_invalidate_lands_between_admission_and_drain(self):
        draw = Draw(22)
        tbl = _table(draw, 256)
        srv = AnalyticsServer(window_size=1024)
        try:
            s = Session(server=srv)
            s.countmin_sketch(tbl)
            srv.flush()
            h = s.countmin_sketch(tbl)
            tbl.columns["item"] = torch.from_numpy(draw.ints((256,), 0, 40))
            tbl.invalidate()
            with trace_execution() as t:
                srv.flush()
            assert len(t.cache_hits) == 0 and len(t.scans) == 1
            fresh = execute(ScanAgg(CountMinAggregate(4, 1024), tbl,
                                    columns=("item",)))
            assert torch.equal(h.result(), fresh)
        finally:
            srv.close()

    def test_fill_skipped_when_table_moves_during_execution(self, table,
                                                            monkeypatch):
        import importlib
        server_mod = importlib.import_module("repro_torch.core.server")
        srv = AnalyticsServer(window_size=1024)
        try:
            s = Session(server=srv)
            s.linregr(table)
            real_plan = server_mod.plan

            def racing_plan(nodes):
                pl = real_plan(nodes)
                real_execute = pl.execute

                def execute_and_mutate():
                    out = real_execute()
                    table.append(_delta(Draw(3), 16))
                    return out
                pl.execute = execute_and_mutate
                return pl

            monkeypatch.setattr(server_mod, "plan", racing_plan)
            srv.flush()
            monkeypatch.setattr(server_mod, "plan", real_plan)
            assert len(srv._cache) == 0
            with trace_execution() as t:
                h = s.linregr(table)
                srv.flush()
            assert len(t.cache_hits) == 0 and len(t.scans) == 1
            assert _bitwise(h.result().coef, _solo_linregr(table).coef)
        finally:
            srv.close()


class TestViewFillers:
    def test_view_delta_refreshes_across_append(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            Session(server=srv).materialize(ScanAgg(
                CountMinAggregate(4, 1024), table, columns=("item",)))
            table.append(_delta(Draw(5), 64))
            with trace_execution() as t:
                h = Session(server=srv).countmin_sketch(table)
                srv.flush()
            assert len(t.scans) == 0 and len(t.deltas) == 1
            assert t.cache_hits[0].detail["refresh"] == "delta"
            assert t.admissions[0].detail["scans_saved"] == 1
            fresh = execute(ScanAgg(CountMinAggregate(4, 1024), table,
                                    columns=("item",)))
            assert torch.equal(h.result(), fresh)
        finally:
            srv.close()

    def test_grouped_view_answers_grouped_statements(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            view = Session(server=srv).materialize(GroupedScanAgg(
                LinregrAggregate(use_kernel=True), table, "g", 4,
                columns={"x": "x", "y": "y"}))
            table.append(_delta(Draw(6), 100))
            with trace_execution() as t:
                h = Session(server=srv).statement(GroupedScanAgg(
                    LinregrAggregate(use_kernel=True), table, "g", 4,
                    columns={"x": "x", "y": "y"}))
                srv.flush()
            assert t.cache_hits[0].detail == {
                "source": "view", "refresh": "delta",
                "table_version": table.version}
            assert len(t.scans) == 0 and len(t.deltas) == 1
            rescan = execute(GroupedScanAgg(
                LinregrAggregate(use_kernel=True), table, "g", 4,
                columns={"x": "x", "y": "y"}))
            assert _bitwise(h.result().num_rows, rescan.num_rows)
            assert view.version == table.version
        finally:
            srv.close()


class TestLifecycle:
    def test_error_propagates_to_every_handle(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            s = Session(server=srv)
            good = s.linregr(table)
            bad = s.statement(ScanAgg(LinregrAggregate(), table,
                                      columns={"x": "missing", "y": "y"}))
            with pytest.raises(Exception):
                srv.flush()
            with pytest.raises(RuntimeError):
                bad.result(timeout=1)
            with pytest.raises(RuntimeError):
                good.result(timeout=1)
        finally:
            srv.close()

    def test_failing_post_fails_only_its_handle(self, table):
        srv = AnalyticsServer(window_size=64)
        try:
            good = Session(server=srv).linregr(table)

            def boom(raw):
                raise ValueError("bad post")
            bad = Session(server=srv).statement(
                ScanAgg(FMAggregate(item_col="item"), table,
                        columns=("item",)), post=boom)
            srv.flush()
            good.result(timeout=1)
            with pytest.raises(RuntimeError) as err:
                bad.result(timeout=1)
            assert isinstance(err.value.__cause__, ValueError)
        finally:
            srv.close()

    def test_result_timeout_bounded_by_inflight_drain(self):
        ta = _table(Draw(33), 128)
        started, release = threading.Event(), threading.Event()
        srv = AnalyticsServer(window_size=1024)
        try:
            srv.submit(_gated_node(ta, started, release))
            flusher = threading.Thread(target=srv.flush, daemon=True)
            flusher.start()
            assert started.wait(30)
            hb = Session(server=srv).linregr(ta)
            t0 = time.monotonic()
            with pytest.raises(TimeoutError):
                hb.result(timeout=0.3)
            assert time.monotonic() - t0 < 10.0
            release.set()
            flusher.join(30)
            assert not flusher.is_alive()
            hb.result(timeout=30)
        finally:
            release.set()
            srv.close()

    def test_close_deregisters_hooks(self, table):
        srv = AnalyticsServer(window_size=1)
        Session(server=srv).linregr(table)
        srv.close()
        evicted = srv.stats["evicted"]
        table.append(_delta(Draw(6), 8))
        assert srv.stats["evicted"] == evicted
        assert not table._mutation_hooks

    def test_empty_batches(self):
        srv = AnalyticsServer()
        try:
            assert Session(server=srv).run() == []
            assert Session(server=srv).explain() == "(empty batch)"
            assert srv.flush() == 0
        finally:
            srv.close()
        assert Session().explain() == "(empty batch)"


class TestDrainThread:
    def test_timeout_fires_without_traffic(self, table):
        srv = AnalyticsServer(window_size=1024, window_timeout=0.05,
                              drain="thread")
        try:
            h = Session(server=srv).linregr(table)
            assert h.wait(30)
            assert _bitwise(h.result(timeout=1).coef,
                            _solo_linregr(table).coef)
        finally:
            srv.close()

    def test_slow_table_does_not_delay_other_table(self):
        d = Draw(31)
        ta, tb = _table(d, 256), _table(d, 256)
        started, release = threading.Event(), threading.Event()
        srv = AnalyticsServer(window_size=1, drain="thread")
        try:
            with trace_execution() as t:
                ha = srv.submit(_gated_node(ta, started, release))
                assert started.wait(30)
                hb = Session(server=srv).linregr(tb)
                assert hb.wait(30)
                assert not ha.done()
                t_b_done = time.monotonic()
                release.set()
                assert ha.wait(30)
            by_table = {e.detail["table"]: e.detail for e in t.admissions}
            assert set(by_table) == {id(ta), id(tb)}
            assert by_table[id(tb)]["drained_at"] < t_b_done
            assert t.summary()["by_table"][id(tb)]["windows"] == 1
        finally:
            release.set()
            srv.close()

    def test_poisoned_statement_does_not_kill_drainer(self, table):
        srv = AnalyticsServer(window_size=1, drain="thread")
        try:
            bad = srv.submit(ScanAgg(LinregrAggregate(), table,
                                     columns={"x": "missing", "y": "y"}))
            assert bad.wait(30)
            with pytest.raises(RuntimeError):
                bad.result(timeout=1)
            good = Session(server=srv).linregr(table)
            assert good.wait(30)
            assert srv.stats["drain_errors"] >= 1
        finally:
            srv.close()

    def test_close_stops_drainer(self, table):
        srv = AnalyticsServer(window_size=1024, window_timeout=0.05,
                              drain="thread")
        h = Session(server=srv).linregr(table)
        srv.close()
        assert h.done()
        assert not srv._drainer.is_alive()


class TestPerTableWindows:
    def test_windows_partition_by_table(self):
        d = Draw(35)
        ta, tb = _table(d, 128), _table(d, 128)
        srv = AnalyticsServer(window_size=3)
        try:
            s = Session(server=srv)
            s.linregr(ta)
            s.countmin_sketch(ta)
            hb = s.linregr(tb)
            ha = s.fm_distinct_count(ta)
            assert ha.done() and not hb.done()
            assert srv.pending == 1
            srv.flush()
            assert hb.done()
        finally:
            srv.close()


class TestWeakHooks:
    def test_dead_table_auto_purges(self):
        srv = AnalyticsServer(window_size=1)
        try:
            tbl = _table(Draw(13), 128)
            tid = id(tbl)
            Session(server=srv).linregr(tbl)
            assert tid in srv._hooked
            assert any(k[0] == tid for k in srv._cache)
            del tbl
            gc.collect()
            assert tid not in srv._hooked
            assert not any(k[0] == tid for k in srv._cache)
            assert tid not in srv._windows
        finally:
            srv.close()


def test_threaded_stress_keeps_every_count():
    """16 submitter threads (more than cores) over two tables on the
    background drainer, with a short switch interval: every handle
    resolves to the solo answer, and the lifetime counts add up (a lost
    update of the admission state would break one of them)."""
    import sys
    d = Draw(37)
    tables = [_table(d, 256), _table(d, 256)]
    solo = [_solo_linregr(t) for t in tables]
    cm = [execute(ScanAgg(CountMinAggregate(4, 1024), t, columns=("item",)))
          for t in tables]
    srv = AnalyticsServer(window_size=8, window_timeout=0.005,
                          drain="thread")
    old = sys.getswitchinterval()
    errors = []
    try:
        sys.setswitchinterval(1e-6)

        def worker(i):
            try:
                s = Session(server=srv)
                for r in range(4):
                    k = (i + r) % 2
                    h1, h2 = s.linregr(tables[k]), s.countmin_sketch(
                        tables[k])
                    if not (_bitwise(h1.result(timeout=60).coef,
                                     solo[k].coef)
                            and torch.equal(h2.result(timeout=60), cm[k])):
                        errors.append((i, r))
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
        srv.close()
    assert not errors
    st = srv.stats
    assert st["submitted"] == 16 * 4 * 2
    assert st["planned"] + st["deduped"] + st["cache_hits"] == st["submitted"]
    assert st["drain_errors"] == 0
