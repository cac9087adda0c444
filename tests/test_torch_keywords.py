"""The reference's keyword arguments, accepted by the port.

Every entry point below takes the keywords the reference's signature
has, with the reference's defaults: ``mesh=None`` / ``row_axes=None``
are no-ops (the local engine is the reference's answer without a mesh),
and ``jit=True`` and ``jit=False`` both run the port's eager code, which
is the reference's un-jitted answer.  Each call with them returns
exactly (bitwise) what the call without them returns.  Every entry point
that takes a mesh runs the sharded engine on a real 2-segment CPU mesh
and, on dyadic data, answers bit for bit what it answers without one; a
``mesh`` that is not a ``repro_torch`` Mesh raises ``TypeError``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    GroupedScanAgg, JoinedGroupedScanAgg, Join, PassRunner, ScanAgg,
    Session, execute, fit, fit_grouped, make_mesh, parallel_sgd, run_grouped,
    run_local, run_many, sgd,
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


# every entry point that takes a mesh: ``call(t, mesh)``, where ``mesh``
# is None (the local answer), a real 2-segment CPU Mesh, or object()
def _dyadic_table() -> Table:
    """_table with dyadic floats: every sum a fold makes is exact, so the
    sharded answer must equal the local one bit for bit."""
    draw = Draw(2)
    return Table.from_columns({
        "x": draw.dyadic((N, 3)), "y": draw.dyadic((N,)),
        "v": draw.dyadic((N,)), "item": draw.ints((N,), 0, 50),
        "label": draw.ints((N,), 0, 1), "g": draw.ints((N,), 0, G - 1),
        "fk": draw.ints((N,), 0, 7)}, device="cpu")


def _on(mesh, **kw):
    return {} if mesh is None else dict(kw, mesh=mesh)


def _sgd_by_hand(t, mesh):
    """parallel_sgd's model average built by hand: plain SGD on each
    segment's rows in segment order from one generator, then the mean."""
    gen = torch.Generator().manual_seed(0)
    half = N // 2
    ws = [sgd(sm.least_squares_program(), Table(
        {k: v[s * half:(s + 1) * half] for k, v in t.columns.items()}),
        torch.zeros(3), seed=gen, anneal=False) for s in range(2)]
    return (ws[0] + ws[1]) / 2


MESH_CALLS = {
    "Table": lambda t, m: run_many(
        {"a": lin.LinregrAggregate(), "b": sk.CountMinAggregate()},
        Table(dict(t.columns), **_on(m))),
    "Table(row_axes)": lambda t, m: run_local(
        lin.LinregrAggregate(), t) if m is None else run_many(
        [lin.LinregrAggregate()], Table(dict(t.columns), mesh=m,
                                        row_axes=("data",)))[0],
    "run_grouped": lambda t, m: run_grouped(lin.LinregrAggregate(), t, "g",
                                            G, **_on(m)),
    "GroupedScanAgg": lambda t, m: execute(GroupedScanAgg(
        lin.LinregrAggregate(), t, "g", G, columns=("x", "y"),
        **_on(m, row_axes=("data",)))),
    "JoinedGroupedScanAgg": lambda t, m: execute(JoinedGroupedScanAgg(
        lin.LinregrAggregate(), _join(t), columns=("x", "y"), **_on(m))),
    "PassRunner": lambda t, m: PassRunner(
        dict(t.columns), **_on(m, row_axes=("data",)))(
        lin.LinregrAggregate()),
    "linregr_grouped": lambda t, m: lin.linregr_grouped(t, "g", G,
                                                        **_on(m)),
    "quantiles_grouped": lambda t, m: qt.quantiles_grouped(
        t, "g", [0.5], num_groups=G, **_on(m)),
    "naive_bayes_grouped": lambda t, m: nb.naive_bayes_grouped(
        _nb_table(t), "g", 2, G, **_on(m)),
    "countmin_sketch_grouped": lambda t, m: sk.countmin_sketch_grouped(
        t, "g", G, **_on(m)),
    "fm_distinct_count_grouped": lambda t, m: sk.fm_distinct_count_grouped(
        t, "g", G, **_on(m)),
    "fit": lambda t, m: fit(_kmeans(t), t.select("x"), **_on(m)).state,
    "fit(engine)": lambda t, m: fit(_kmeans(t), t.select("x"),
                                    **_on(m, engine="sharded")).state,
    "fit_grouped": lambda t, m: fit_grouped(
        _kmeans(t), t.select("x", "g"), "g", G,
        **_on(m, row_axes=("data",))).state,
    "Session.grouped_scan": lambda t, m: _session(
        "grouped_scan", _on(m))(t),
    "parallel_sgd": lambda t, m: _sgd_by_hand(t, m) if m is None
    else parallel_sgd(sm.least_squares_program(), t, torch.zeros(3),
                      mesh=m),
}


@pytest.mark.parametrize("name", sorted(MESH_CALLS))
def test_a_mesh_raises_naming_item_13(name):
    """Each entry point on a real 2-segment CPU mesh answers bit for bit
    what it answers without one (parallel_sgd: what its per-segment SGD
    averaged by hand gives), and a mesh that is not a Mesh raises
    TypeError."""
    t = _dyadic_table()
    call = MESH_CALLS[name]
    _assert_same(call(t, make_mesh((2,), ("data",), devices=["cpu"] * 2)),
                 call(t, None))
    with pytest.raises(TypeError, match="Mesh"):
        call(t, object())


@pytest.mark.parametrize("mode", ["compiled", "host"])
def test_fit_without_jit_is_the_jitted_answer(mode):
    t = _table()
    kw = {"max_iters": 8, "tol": 1e-4, "mode": mode}
    a = fit(_kmeans(t), t.select("x"), **kw)
    b = fit(_kmeans(t), t.select("x"), jit=False, **kw)
    assert a.n_iters == b.n_iters and a.converged == b.converged
    _assert_same(b.state, a.state)
    _assert_same(b.trace, a.trace)
