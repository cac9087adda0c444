"""The reference's keyword arguments, accepted by the port.

Every entry point below takes the keywords the reference's signature
has, with the reference's defaults: ``mesh=None`` / ``row_axes=None``
are no-ops (the local engine is the reference's answer without a mesh),
and ``jit=True`` and ``jit=False`` both run the port's eager code, which
is the reference's un-jitted answer.  Each call with them returns
exactly (bitwise) what the call without them returns.  A mesh, non-empty
``row_axes`` or ``engine="sharded"`` raises ``NotImplementedError``
naming ROADMAP Queue 1 item 13 (the sharded engine).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    GroupedScanAgg, JoinedGroupedScanAgg, Join, PassRunner, ScanAgg,
    Session, execute, fit, fit_grouped, parallel_sgd, run_grouped, run_local,
    run_many,
)
from repro_torch.core.table import Table
from repro_torch.methods import kmeans as km
from repro_torch.methods import linregr as lin
from repro_torch.methods import naive_bayes as nb
from repro_torch.methods import profile as prof
from repro_torch.methods import quantiles as qt
from repro_torch.methods import sgd_models as sm
from repro_torch.methods import sketches as sk
from repro_torch.tree import tree_leaves
from strategies import Draw

N, G = 300, 4


def _table() -> Table:
    draw = Draw(1)
    return Table.from_columns({
        "x": draw.normal((N, 3)), "y": draw.normal((N,)),
        "v": draw.normal((N,)), "item": draw.ints((N,), 0, 50),
        "label": draw.ints((N,), 0, 1), "g": draw.ints((N,), 0, G - 1),
        "fk": draw.ints((N,), 0, 7)}, device="cpu")


def _join(t: Table) -> Join:
    dim = Table.from_columns({"key": np.arange(8, dtype=np.int32),
                              "attr": np.arange(8, dtype=np.int32) % 3},
                             device="cpu")
    return Join(t, dim, "fk", "key", "attr")


def _session(method: str, kw: dict):
    def call(t):
        s = Session()
        agg = lin.LinregrAggregate()
        cols = {"x": "x", "y": "y"}
        h = {"scan": lambda: s.scan(agg, t, columns=cols, **kw),
             "grouped_scan": lambda: s.grouped_scan(
                 agg, t, "g", G, columns=cols, **kw),
             "joined_grouped_scan": lambda: s.joined_grouped_scan(
                 agg, _join(t), columns=cols, **kw),
             "profile": lambda: s.profile(t, **kw)}[method]()
        s.run()
        return h.result()
    return call


def _nb_table(t: Table) -> Table:
    return Table({"x": t["x"], "y": t["label"], "g": t["g"]})


def _kmeans(t: Table) -> km.KMeansTask:
    return km.KMeansTask(t["x"][:3].clone())


# name -> (call taking the table and the keywords, the keywords to try)
JIT = ({"jit": True}, {"jit": False})
MESH = ({"mesh": None}, {"mesh": None, "row_axes": None},
        {"mesh": None, "row_axes": None, "jit": True},
        {"mesh": None, "row_axes": None, "jit": False})
CALLS = {
    "Table": (lambda t, kw: run_local(
        lin.LinregrAggregate(), Table(dict(t.columns), **kw)),
        ({"mesh": None}, {"mesh": None, "row_axes": None},
         {"row_axes": ()})),
    "run_local": (lambda t, kw: run_local(lin.LinregrAggregate(), t, **kw),
                  JIT),
    "run_many": (lambda t, kw: run_many(
        {"a": lin.LinregrAggregate(), "b": sk.CountMinAggregate()}, t, **kw),
        JIT),
    "profile": (lambda t, kw: prof.profile(t, distinct_counts=True, **kw),
                JIT),
    "run_grouped": (lambda t, kw: run_grouped(
        lin.LinregrAggregate(), t.select("x", "y", "g"), "g", G, **kw),
        MESH),
    "ScanAgg": (lambda t, kw: execute(ScanAgg(
        lin.LinregrAggregate(), t, columns=("x", "y"), **kw)), JIT),
    "GroupedScanAgg": (lambda t, kw: execute(GroupedScanAgg(
        lin.LinregrAggregate(), t, "g", G, columns=("x", "y"), **kw)),
        MESH),
    "JoinedGroupedScanAgg": (lambda t, kw: execute(JoinedGroupedScanAgg(
        lin.LinregrAggregate(), _join(t), columns=("x", "y"), **kw)),
        ({"mesh": None, "row_axes": None},) + JIT),
    "PassRunner": (lambda t, kw: PassRunner(dict(t.columns), **kw)(
        lin.LinregrAggregate()), ({"row_axes": ()},)),
    "linregr_grouped": (lambda t, kw: lin.linregr_grouped(t, "g", G, **kw),
                        ({"mesh": None},)),
    "quantiles_grouped": (lambda t, kw: qt.quantiles_grouped(
        t, "g", [0.25, 0.5], num_groups=G, **kw), ({"mesh": None},)),
    "naive_bayes_grouped": (lambda t, kw: nb.naive_bayes_grouped(
        _nb_table(t), "g", 2, G, **kw), ({"mesh": None},)),
    "countmin_sketch_grouped": (lambda t, kw: sk.countmin_sketch_grouped(
        t, "g", G, **kw), ({"mesh": None},)),
    "fm_distinct_count_grouped": (lambda t, kw: sk.fm_distinct_count_grouped(
        t, "g", G, **kw), ({"mesh": None},)),
    "fit": (lambda t, kw: fit(_kmeans(t), t.select("x"), max_iters=5,
                              tol=1e-4, **kw).state, MESH),
    "fit_grouped": (lambda t, kw: fit_grouped(
        _kmeans(t), t.select("x", "g"), "g", G, max_iters=5, tol=1e-4,
        **kw).state, MESH),
    "Session.scan": (lambda t, kw: _session("scan", kw)(t), JIT),
    "Session.grouped_scan": (lambda t, kw: _session("grouped_scan", kw)(t),
                             MESH),
    "Session.joined_grouped_scan": (
        lambda t, kw: _session("joined_grouped_scan", kw)(t),
        ({"mesh": None, "row_axes": None},) + JIT),
    "Session.profile": (lambda t, kw: _session("profile", kw)(t), JIT),
}


def _assert_same(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", sorted(CALLS))
def test_reference_keywords_with_their_defaults(name):
    call, kws = CALLS[name]
    t = _table()
    want = call(t, {})
    for kw in kws:
        _assert_same(call(t, kw), want)


# every entry point that takes a mesh, given one
MESH_CALLS = {
    "Table": lambda t: Table(dict(t.columns), mesh=object()),
    "Table(row_axes)": lambda t: Table(dict(t.columns), row_axes=("data",)),
    "run_grouped": lambda t: run_grouped(lin.LinregrAggregate(), t, "g", G,
                                         mesh=object()),
    "GroupedScanAgg": lambda t: execute(GroupedScanAgg(
        lin.LinregrAggregate(), t, "g", G, columns=("x", "y"),
        row_axes=("data",))),
    "JoinedGroupedScanAgg": lambda t: execute(JoinedGroupedScanAgg(
        lin.LinregrAggregate(), _join(t), columns=("x", "y"),
        mesh=object())),
    "PassRunner": lambda t: PassRunner(dict(t.columns), row_axes=("data",)),
    "linregr_grouped": lambda t: lin.linregr_grouped(t, "g", G,
                                                     mesh=object()),
    "quantiles_grouped": lambda t: qt.quantiles_grouped(
        t, "g", [0.5], num_groups=G, mesh=object()),
    "naive_bayes_grouped": lambda t: nb.naive_bayes_grouped(
        _nb_table(t), "g", 2, G, mesh=object()),
    "countmin_sketch_grouped": lambda t: sk.countmin_sketch_grouped(
        t, "g", G, mesh=object()),
    "fm_distinct_count_grouped": lambda t: sk.fm_distinct_count_grouped(
        t, "g", G, mesh=object()),
    "fit": lambda t: fit(_kmeans(t), t.select("x"), mesh=object()),
    "fit(engine)": lambda t: fit(_kmeans(t), t.select("x"),
                                 engine="sharded"),
    "fit_grouped": lambda t: fit_grouped(_kmeans(t), t.select("x", "g"),
                                         "g", G, row_axes=("data",)),
    "Session.grouped_scan": lambda t: _session(
        "grouped_scan", {"mesh": object()})(t),
    "parallel_sgd": lambda t: parallel_sgd(
        sm.least_squares_program(), t, torch.zeros(3), mesh=object()),
}


@pytest.mark.parametrize("name", sorted(MESH_CALLS))
def test_a_mesh_raises_naming_item_13(name):
    t = _table()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 13"):
        MESH_CALLS[name](t)


@pytest.mark.parametrize("mode", ["compiled", "host"])
def test_fit_without_jit_is_the_jitted_answer(mode):
    t = _table()
    kw = {"max_iters": 8, "tol": 1e-4, "mode": mode}
    a = fit(_kmeans(t), t.select("x"), **kw)
    b = fit(_kmeans(t), t.select("x"), jit=False, **kw)
    assert a.n_iters == b.n_iters and a.converged == b.converged
    _assert_same(b.state, a.state)
    _assert_same(b.trace, a.trace)
