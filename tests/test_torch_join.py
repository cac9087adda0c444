"""The port's star-schema join against the JAX package's.

The same numpy star layouts (``tests/strategies.py``: clean, skewed
fan-out, duplicate attributes, dangling keys, empty dimension, duplicate
keys) go through ``repro.core.join`` and ``repro_torch.core.join`` on the
CPU.  Resolved gid columns, dangling counts and group counts must be
equal; ``linregr_joined`` fold states bitwise equal on dyadic data (and
to gathering the attribute by hand, in the port), allclose (rtol 1e-5)
on Gaussian data.  Trace counts (one key resolution and one fact-side
sort per batch) must be the reference's.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from repro.core import Join as JJoin
from repro.core import JoinedGroupedScanAgg as JJoinedGroupedScanAgg
from repro.core import Session as JSession
from repro.core import Table as JTable
from repro.core import execute as jexecute
from repro.core import trace_execution as jtrace
from repro.core.join import JOIN_GID_COL as JGID
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.linregr import linregr_joined as jlinregr_joined
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro_torch.core import (
    AnalyticsServer, Join, JoinedGroupedScanAgg, Session, Table, execute,
    explain, run_grouped, trace_execution,
)
from repro_torch.core import join as join_mod
from repro_torch.core.join import JOIN_GID_COL
from repro_torch.core.plan import node_tables, semantic_fingerprint
from repro_torch.methods.linregr import LinregrAggregate, linregr_joined
from repro_torch.methods.sketches import CountMinAggregate
from strategies import Draw, cases, join_layout

N_FACT, N_DIM, G = 192, 12, 4


def _star(draw: Draw, pattern: str, gauss: bool = False):
    """(port fact, port dim, JAX fact, JAX dim, fk, keys, attr)."""
    fk, keys, attr, _ = join_layout(draw, N_FACT, N_DIM, G, pattern)
    x = draw.normal((N_FACT, 3)) if gauss else draw.dyadic((N_FACT, 3))
    y = draw.normal((N_FACT,)) if gauss else draw.dyadic((N_FACT,))
    fcols = {"x": x, "y": y, "fk": fk}
    dcols = {"key": keys, "region": attr}
    return (Table.from_columns(fcols, device="cpu"),
            Table.from_columns(dcols, device="cpu"),
            JTable.from_columns(fcols), JTable.from_columns(dcols),
            fk, keys, attr)


def _oracle_gids(fk, keys, attr):
    m = {int(k): int(a) for k, a in zip(keys, attr)}
    return np.array([m.get(int(f), -1) for f in fk], np.int32)


def _node(mod_agg, mod_join, node_cls, fact, dim, on_missing="error"):
    return node_cls(mod_agg(), mod_join(fact, dim, "fk", "key", "region",
                                       on_missing=on_missing),
                    columns={"x": "x", "y": "y"})


def _leaves(res) -> list:
    return [np.asarray(getattr(res, f)) for f in
            ("coef", "r2", "std_err", "t_stats", "p_values",
             "condition_no", "num_rows")]


def _assert_same(got, want, exact: bool, what: str) -> None:
    for g, w in zip(_leaves(got), _leaves(want)):
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=what)


@pytest.mark.parametrize("pattern", ("clean", "skewed", "dup_attr",
                                     "dangling"))
def test_resolution_equals_the_reference(pattern):
    for draw in cases(3, base_seed=11):
        fact, dim, jfact, jdim, fk, keys, attr = _star(draw, pattern)
        res = Join(fact, dim, "fk", "key", "region",
                   on_missing="drop").resolve()
        want = JJoin(jfact, jdim, "fk", "key", "region",
                     on_missing="drop").resolve()
        got_gids = res.table[JOIN_GID_COL].numpy()
        assert res.table[JOIN_GID_COL].dtype == torch.int32
        np.testing.assert_array_equal(got_gids, np.asarray(want.table[JGID]),
                                      err_msg=f"{pattern} {draw}")
        np.testing.assert_array_equal(got_gids, _oracle_gids(fk, keys, attr))
        assert (res.dangling, res.num_groups) == (want.dangling,
                                                  want.num_groups)
        # never materialized: exactly one new column, no dim payloads
        assert set(res.table.columns) == set(fact.columns) | {JOIN_GID_COL}


def _joined_state(run_grouped_fn, agg, join):
    """Fold states of the joined GROUP BY: the resolution's table grouped
    by its gid column, folded without finalizing."""
    res = join.resolve()
    return run_grouped_fn(agg, res.table.group_by(res.gid_col,
                                                  res.num_groups),
                          finalize=False)


def _assert_states(got: dict, want: dict, exact: bool, what: str) -> None:
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("pattern,gauss", [
    ("clean", False), ("skewed", False), ("dup_attr", False),
    ("dangling", False), ("clean", True)])
def test_linregr_joined_equals_the_reference(pattern, gauss):
    """Fold states bitwise on dyadic data (allclose on Gaussian), the
    finalized results allclose: the two packages' eigh solves round
    differently."""
    from repro.core import run_grouped as jrun_grouped
    on_missing = "drop" if pattern == "dangling" else "error"
    for draw in cases(2, base_seed=23):
        fact, dim, jfact, jdim, fk, keys, attr = _star(draw, pattern, gauss)
        kw = dict(fact_key="fk", dim_key="key", attr_col="region",
                  on_missing=on_missing)
        got = linregr_joined(fact, dim, **kw)
        want = jlinregr_joined(jfact, jdim, **kw)
        _assert_same(got, want, False, f"{pattern} {draw}")
        state = _joined_state(run_grouped, LinregrAggregate(), Join(
            fact, dim, "fk", "key", "region", on_missing=on_missing))
        _assert_states(state, _joined_state(jrun_grouped, JLinregrAggregate(),
                                            JJoin(jfact, jdim, "fk", "key",
                                                  "region",
                                                  on_missing=on_missing)),
                       not gauss, f"{pattern} {draw}")
        # against gathering the attribute by hand, in the port: the same
        # gid sequence gives the same partitioning and the same bits
        manual = Table({"x": fact["x"], "y": fact["y"],
                        "g": torch.from_numpy(_oracle_gids(fk, keys, attr))})
        G_ = int(attr.max()) + 1
        _assert_states(state, run_grouped(LinregrAggregate(), manual, "g",
                                          G_, finalize=False),
                       True, f"{pattern} {draw} vs manual")
        _assert_same(got, run_grouped(LinregrAggregate(), manual, "g", G_),
                     True, f"{pattern} {draw} vs manual")


def test_dangling_error_names_the_count():
    fact, dim, jfact, jdim, fk, keys, attr = _star(Draw(41), "dangling")
    n_bad = int((_oracle_gids(fk, keys, attr) == -1).sum())
    with pytest.raises(ValueError, match=f"{n_bad} of {N_FACT}"):
        execute(_node(LinregrAggregate, Join, JoinedGroupedScanAgg,
                      fact, dim))
    with pytest.raises(ValueError, match=f"{n_bad} of {N_FACT}"):
        jexecute(_node(JLinregrAggregate, JJoin, JJoinedGroupedScanAgg,
                       jfact, jdim))


@pytest.mark.parametrize("pattern,match", [("dup_keys", "duplicate keys"),
                                           ("empty_dim", "empty dimension")])
def test_loud_edges_match_the_reference(pattern, match):
    fact, dim, jfact, jdim, *_ = _star(Draw(47), pattern)
    with pytest.raises(ValueError, match=match):
        Join(fact, dim, "fk", "key", "region").resolve()
    with pytest.raises(ValueError, match=match):
        JJoin(jfact, jdim, "fk", "key", "region").resolve()
    if pattern == "empty_dim":
        res = Join(fact, dim, "fk", "key", "region",
                   on_missing="drop").resolve()
        assert res.num_groups == 0 and res.dangling == N_FACT
        assert bool((res.table[JOIN_GID_COL] == -1).all())


def test_bad_spec_rejected_eagerly():
    fact, dim, *_ = _star(Draw(59), "clean")
    with pytest.raises(ValueError, match="on_missing"):
        Join(fact, dim, "fk", "key", "region", on_missing="ignore")
    with pytest.raises(KeyError):
        Join(fact, dim, "nope", "key", "region")
    with pytest.raises(KeyError):
        Join(fact, dim, "fk", "key", "nope")


def test_mesh_is_not_ported():
    fact, dim, *_ = _star(Draw(60), "clean")
    node = _node(LinregrAggregate, Join, JoinedGroupedScanAgg, fact, dim)
    node.mesh = object()
    with pytest.raises(TypeError, match="Mesh"):
        execute(node)


def _batch_counts(mods, fact, dim):
    """Two joined statements in one batch: their trace counts, explain
    text and results."""
    session, agg, cm, join, trace = mods
    sess = session()
    h_lr = sess.joined_grouped_scan(
        agg(), join(fact, dim, "fk", "key", "region"),
        columns={"x": "x", "y": "y"})
    h_cm = sess.joined_grouped_scan(
        cm(4, 64, item_col="fk"), join(fact, dim, "fk", "key", "region"),
        columns=("fk",))
    text = sess.explain()
    with trace() as t:
        sess.run()
    return ((len(t.scans), len(t.joins), len(t.sorts)), text,
            h_lr.result(), np.asarray(h_cm.result()))


def test_joined_batch_shares_one_resolution_and_one_sort():
    fact, dim, jfact, jdim, fk, keys, attr = _star(Draw(61), "clean")
    got = _batch_counts((Session, LinregrAggregate, CountMinAggregate, Join,
                         trace_execution), fact, dim)
    want = _batch_counts((JSession, JLinregrAggregate, JCountMinAggregate,
                          JJoin, jtrace), jfact, jdim)
    # one scan, one key resolution, two sorts (the dim key, the joined
    # table's partitioning), as in the reference
    assert got[0] == want[0] == (1, 1, 2)
    assert got[1] == want[1]
    assert "1 pass, 1 sort" in got[1] and "JOIN t1 on fk=key" in got[1]
    _assert_same(got[2], want[2], False, "fused linregr")
    np.testing.assert_array_equal(got[3], want[3])

    # re-run: the resolution memo and the group_by memo both hit
    with trace_execution() as t:
        execute(_node(LinregrAggregate, Join, JoinedGroupedScanAgg,
                      fact, dim))
    assert len(t.sorts) == 0 and len(t.joins) == 0


def test_joined_batch_members_keep_their_segment_kernels():
    """A fused joined pass runs each member's segment kernel over the
    shared layout; the answers equal each statement run alone, and the
    reference's fused pass (which folds block by block)."""
    fact, dim, jfact, jdim, fk, keys, attr = _star(Draw(63), "clean")

    def batch(session, agg, cm, join):
        sess = session()
        hs = [sess.joined_grouped_scan(
                  agg(use_kernel=True), join(fact_, dim_, "fk", "key",
                                             "region"),
                  columns={"x": "x", "y": "y"}),
              sess.joined_grouped_scan(
                  cm(4, 64, item_col="fk", use_kernel=True),
                  join(fact_, dim_, "fk", "key", "region"),
                  columns=("fk",))]
        sess.run()
        return [h.result() for h in hs]

    fact_, dim_ = fact, dim
    with trace_execution() as t:
        got = batch(Session, LinregrAggregate, CountMinAggregate, Join)
    assert len(t.scans) == 1
    assert sorted((e.detail["name"], e.engine) for e in t.kernels) == [
        ("segment_countmin", "ref"), ("segment_linregr", "ref")]
    alone = [execute(JoinedGroupedScanAgg(
                 LinregrAggregate(use_kernel=True),
                 Join(fact, dim, "fk", "key", "region"),
                 columns={"x": "x", "y": "y"})),
             execute(JoinedGroupedScanAgg(
                 CountMinAggregate(4, 64, item_col="fk", use_kernel=True),
                 Join(fact, dim, "fk", "key", "region"), columns=("fk",)))]
    _assert_same(got[0], alone[0], True, "fused vs alone")
    assert torch.equal(got[1], alone[1])
    fact_, dim_ = jfact, jdim
    want = batch(JSession, JLinregrAggregate, JCountMinAggregate, JJoin)
    _assert_same(got[0], want[0], False, "fused vs the reference")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_memo_lets_a_dropped_table_go():
    """The memo holds its tables weakly: while the fact lives its joined
    columns stay memoized; once it is collected the entry is gone."""
    fact, dim = _star(Draw(71), "clean")[:2]
    fid = id(fact)
    joined = weakref.ref(Join(fact, dim, "fk", "key", "region")
                         .resolve().table)
    gc.collect()
    assert joined() is not None
    del fact
    gc.collect()
    assert joined() is None
    assert not any(k[0] == fid for k in join_mod._RESOLUTIONS)
    assert fid not in join_mod._WATCHED


def test_resolutions_of_two_facts_overlap(monkeypatch):
    """The fact-side match runs outside the memo's lock: a second fact's
    resolution against the same dimension finishes while the first is
    held inside its match."""
    draw = Draw(73)
    _, dim, _, _, _, keys, attr = _star(draw, "clean")
    facts = [Table.from_columns(
        {"fk": keys[draw.rng.integers(0, N_DIM, n)].astype(np.int32)},
        device="cpu") for n in (N_FACT, N_FACT + 1)]
    inside, release = threading.Event(), threading.Event()
    real = torch.searchsorted

    def held(sorted_keys, fk, **kw):
        if fk.shape[0] == N_FACT:
            inside.set()
            assert release.wait(30)
        return real(sorted_keys, fk, **kw)

    monkeypatch.setattr(torch, "searchsorted", held)
    out = {}

    def resolve(i):
        out[i] = Join(facts[i], dim, "fk", "key", "region").resolve()

    first = threading.Thread(target=resolve, args=(0,), daemon=True)
    second = threading.Thread(target=resolve, args=(1,), daemon=True)
    first.start()
    try:
        assert inside.wait(30)
        second.start()
        second.join(30)
        overlapped = not second.is_alive()
    finally:
        release.set()
        first.join(30)
        second.join(30)
    assert overlapped and not first.is_alive() and set(out) == {0, 1}
    for i, fact in enumerate(facts):
        np.testing.assert_array_equal(
            out[i].table[out[i].gid_col].numpy(),
            _oracle_gids(fact["fk"].numpy(), keys, attr))


def test_mutation_forces_reresolution():
    draw = Draw(67)
    fact, dim, jfact, jdim, fk, keys, attr = _star(draw, "clean")
    execute(_node(LinregrAggregate, Join, JoinedGroupedScanAgg, fact, dim))
    dim.invalidate()
    with trace_execution() as t:
        execute(_node(LinregrAggregate, Join, JoinedGroupedScanAgg,
                      fact, dim))
    assert len(t.joins) == 1 and len(t.sorts) == 2
    assert t.summary()["sorts_by_table"].get(id(dim)) == 1
    extra = Draw(68)
    add = {"x": extra.dyadic((64, 3)), "y": extra.dyadic((64,)),
           "fk": keys[extra.rng.integers(0, N_DIM, 64)].astype(np.int32)}
    fact.append(add)
    jfact.append(add)
    with trace_execution() as t:
        got = execute(_node(LinregrAggregate, Join, JoinedGroupedScanAgg,
                            fact, dim))
    assert len(t.joins) == 1
    want = jexecute(_node(JLinregrAggregate, JJoin, JJoinedGroupedScanAgg,
                          jfact, jdim))
    _assert_same(got, want, False, "after append")


def test_fingerprint_rejects_multi_table():
    fact, dim, *_ = _star(Draw(73), "clean")
    node = _node(LinregrAggregate, Join, JoinedGroupedScanAgg, fact, dim)
    assert node_tables(node) == (fact, dim)
    with trace_execution() as t:
        assert semantic_fingerprint(node) is None
    (ev,) = t.cache_rejects
    assert ev.detail["reason"] == "multi-table"
    assert ev.detail["tables"] == (id(fact), id(dim))


def test_solo_explain_equals_the_reference():
    fact, dim, jfact, jdim, *_ = _star(Draw(71), "dangling")
    got = explain(_node(LinregrAggregate, Join, JoinedGroupedScanAgg,
                        fact, dim, on_missing="drop"))
    from repro.core import explain as jexplain
    want = jexplain(_node(JLinregrAggregate, JJoin, JJoinedGroupedScanAgg,
                          jfact, jdim, on_missing="drop"))
    assert got == want
    assert "on_missing=drop" in got and "(join: sort-share=" in got


def test_server_never_serves_stale_join_after_dim_mutation():
    fact, dim, jfact, jdim, fk, keys, attr = _star(Draw(79), "clean")
    srv = AnalyticsServer(window_size=1)
    try:
        sess = Session(server=srv)
        sess.joined_grouped_scan(
            LinregrAggregate(), Join(fact, dim, "fk", "key", "region"),
            columns={"x": "x", "y": "y"}).result(timeout=60)
        new_attr = ((attr + 1) % G).astype(np.int32)
        dim.columns["region"] = torch.from_numpy(new_attr)
        dim.invalidate()
        with trace_execution() as t:
            got = sess.joined_grouped_scan(
                LinregrAggregate(), Join(fact, dim, "fk", "key", "region"),
                columns={"x": "x", "y": "y"}).result(timeout=60)
        assert len(t.cache_hits) == 0 and len(t.scans) == 1
        assert srv.stats["cache_hits"] == 0
        manual = Table({"x": fact["x"], "y": fact["y"], "g": torch.from_numpy(
            _oracle_gids(fk, keys, new_attr))})
        want = run_grouped(LinregrAggregate(), manual, "g",
                           int(attr.max()) + 1)
        _assert_same(got, want, True, "after dim mutation")
    finally:
        srv.close()


def test_thread_drains_of_two_facts_share_one_dimension():
    """Two fact tables over ONE dimension on ``drain="thread"``: their
    windows drain on separate workers and both resolve against the same
    dimension; the dimension is sorted once and both answers equal the
    manual gather."""
    draw = Draw(83)
    _, dim, _, _, _, keys, attr = _star(draw, "clean")
    facts = []
    for _ in range(2):
        rows = draw.rng.integers(0, N_DIM, N_FACT)
        facts.append(Table.from_columns(
            {"x": draw.dyadic((N_FACT, 3)), "y": draw.dyadic((N_FACT,)),
             "fk": keys[rows].astype(np.int32)}, device="cpu"))
    srv = AnalyticsServer(window_size=1024, window_timeout=0.02,
                          drain="thread")
    try:
        with trace_execution() as t:
            handles = []
            start = threading.Barrier(2, timeout=30)

            def submit(fact):
                start.wait()
                for _ in range(3):
                    handles.append((fact, Session(server=srv)
                                    .joined_grouped_scan(
                                        LinregrAggregate(),
                                        Join(fact, dim, "fk", "key",
                                             "region"),
                                        columns={"x": "x", "y": "y"})))

            threads = [threading.Thread(target=submit, args=(f,),
                                        daemon=True) for f in facts]
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
            assert len(handles) == 6
            for _, h in handles:
                assert h.wait(60), "background drainer never fired"
        assert t.summary()["sorts_by_table"].get(id(dim)) == 1
        assert len(t.joins) == 2
        for fact, h in handles:
            manual = Table({"x": fact["x"], "y": fact["y"],
                            "g": torch.from_numpy(_oracle_gids(
                                fact["fk"].numpy(), keys, attr))})
            want = run_grouped(LinregrAggregate(), manual, "g",
                               int(attr.max()) + 1)
            _assert_same(h.result(timeout=10), want, True, "thread drain")
    finally:
        srv.close()

