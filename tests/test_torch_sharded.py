"""The port's sharded engines against its local engine and the JAX
package's.

The reference runs its sharded engines in-process at one device only
(its 8-device runs are subprocesses), so every result on the port's CPU
meshes of 1, 2 and 8 segments is held to two answers: the port's own
local engine on the same table, and JAX's local engine (or its
one-device sharded engine).  Held bitwise on dyadic data and on counts:
``run_sharded`` of linregr, profile, Count-Min, FM, a generic-merge
aggregate (a histogram whose ``merge_ops`` is None) and a
``FusedAggregate`` through ``run_many``; ``run_grouped`` at
``method="segment"`` and ``"masked"``, with and without a base mask; a
living view, a star join and k-means++ seeding on a distributed table.
Held allclose on Gaussian data (rtol 1e-5 of the largest entry): the
same folds.  Held equal to JAX (``n_iters``, ``converged``, ``stats``)
with states allclose (rtol 1e-5, IRLS 1e-4): ``fit`` and
``fit_grouped`` for k-means and IRLS.  ``parallel_sgd`` is held bitwise
to the same per-segment SGD averaged by hand.  Trace events (never
timings) show the sharded engines and one kernel dispatch per segment.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import aggregates as jagg
from repro.core import iterative as jit_
from repro.core.compat import make_mesh as jmake_mesh
from repro.core.templates import ProfileAggregate as JProfileAggregate
from repro.methods import kmeans as jkm
from repro.methods import logregr as jlr
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.quantiles import HistogramAggregate as JHistogram
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro.methods.sketches import FMAggregate as JFMAggregate
from repro_torch.core import (
    GroupedScanAgg, Join, ProfileAggregate, ScanAgg, Session, Table,
    execute, fit, fit_grouped, make_mesh, materialize, parallel_sgd,
    run_grouped, run_local, run_many, run_sharded, sgd, trace_execution,
)
from repro_torch.core.plan import plan
from repro_torch.methods import kmeans as km
from repro_torch.methods import logregr as lr
from repro_torch.methods import sgd_models as sm
from repro_torch.methods.linregr import (
    LinregrAggregate, linregr_grouped, linregr_joined,
)
from repro_torch.methods.quantiles import HistogramAggregate
from repro_torch.methods.sketches import CountMinAggregate, FMAggregate
from strategies import Draw, group_layout, join_layout

SEGS = (1, 2, 8)
N, G = 480, 6


def _mesh(p: int):
    return make_mesh((p,), ("data",), devices=["cpu"] * p)


def _flat(tree) -> list:
    """Leaves of a port or JAX state as numpy arrays, dict keys sorted
    (JAX's leaf order)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for v in tree for a in _flat(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [a for f in dataclasses.fields(tree)
                for a in _flat(getattr(tree, f.name))]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def _same(got, want) -> None:
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _close(got, want, rtol=1e-5) -> None:
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        scale = max(float(np.abs(y).max()) if y.size else 0.0, 1.0)
        np.testing.assert_allclose(x, y, rtol=0, atol=rtol * scale)


def _cols(seed: int, kind: str, n: int = N) -> dict:
    draw = Draw(seed)
    val = draw.dyadic if kind == "dyadic" else draw.normal
    gids, _ = group_layout(draw, n, G, "skewed")
    return {"x": val((n, 3)), "y": val((n,)), "v": val((n,)),
            "item": draw.ints((n,), -50, 50), "g": gids,
            "mask": draw.bools((n,), p=0.8)}


def _tables(cols):
    return (Table.from_columns(cols, device="cpu"),
            jcore.Table.from_columns(cols))


class _GenericHist(HistogramAggregate):
    """The quantiles histogram state, merged by its own ``merge``."""
    merge_ops = None

    def merge(self, a, b):
        return a + b


class _JGenericHist(JHistogram):
    merge_ops = None

    def merge(self, a, b):
        return a + b


# name -> (port factory, JAX factory): the aggregates of one-pass scans
AGGS = {
    "linregr": (lambda: LinregrAggregate(use_kernel=True),
                lambda: JLinregrAggregate()),
    "profile": (ProfileAggregate, JProfileAggregate),
    "countmin": (lambda: CountMinAggregate(4, 64, use_kernel=True),
                 lambda: JCountMinAggregate(4, 64)),
    "fm": (lambda: FMAggregate(4, 16), lambda: JFMAggregate(4, 16)),
    "generic": (lambda: _GenericHist(-4.0, 4.0, 64),
                lambda: _JGenericHist(-4.0, 4.0, 64)),
}
SCAN_COLS = {"linregr": ("x", "y"), "profile": ("x", "v"),
             "countmin": ("item",), "fm": ("item",), "generic": ("v",)}


def _sel(t, name):
    return t.select(*SCAN_COLS[name])


# ---------------------------------------------------------------------------
# run_sharded and run_many.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(AGGS))
@pytest.mark.parametrize("p", SEGS)
def test_run_sharded_is_bitwise_local_and_jax_on_dyadic_data(p, name,
                                                            masked):
    make, jmake = AGGS[name]
    cols = _cols(1, "dyadic")
    t, jt = _tables(cols)
    mask = torch.from_numpy(cols["mask"]) if masked else None
    jmask = jnp.asarray(cols["mask"]) if masked else None
    d = _sel(t, name).distribute(_mesh(p))
    got = run_sharded(make(), d, mask=mask, block_size=32, finalize=False)
    _same(got, run_local(make(), _sel(t, name), mask=mask, block_size=32,
                         finalize=False))
    _same(got, jagg.run_local(jmake(), _sel(jt, name), mask=jmask,
                              block_size=32, finalize=False))
    if p == 1:
        jd = _sel(jt, name).distribute(jmake_mesh((1,), ("data",)))
        _same(got, jagg.run_sharded(jmake(), jd, mask=jmask, block_size=32,
                                    finalize=False))


@pytest.mark.parametrize("name", ["linregr", "profile"])
@pytest.mark.parametrize("p", SEGS)
def test_run_sharded_is_close_on_gaussian_data(p, name):
    make, jmake = AGGS[name]
    t, jt = _tables(_cols(2, "gauss"))
    got = run_sharded(make(), _sel(t, name).distribute(_mesh(p)),
                      finalize=False)
    _close(got, run_local(make(), _sel(t, name), finalize=False))
    _close(got, jagg.run_local(jmake(), _sel(jt, name), finalize=False))


@pytest.mark.parametrize("p", SEGS)
def test_run_many_fuses_every_member_on_the_segments(p):
    t, jt = _tables(_cols(3, "dyadic"))
    names = ("linregr", "countmin", "fm", "generic")
    d = t.distribute(_mesh(p))
    with trace_execution() as tr:
        got = run_many({n: AGGS[n][0]() for n in names}, d, finalize=False)
    assert [(e.engine, e.detail["segs"]) for e in tr.scans] == [
        ("sharded", p)]
    assert sum(e.detail["name"] == "xtx" for e in tr.kernels) == p
    assert sum(e.detail["name"] == "countmin" for e in tr.kernels) == p
    _same(got, run_many({n: AGGS[n][0]() for n in names}, t,
                        finalize=False))
    _same(got, jagg.run_many({n: AGGS[n][1]() for n in names}, jt,
                             finalize=False))
    # finalized: each member's result as the local engine gives it
    _same(run_many({n: AGGS[n][0]() for n in names}, d),
          run_many({n: AGGS[n][0]() for n in names}, t))


def test_run_sharded_without_a_mesh_is_run_local():
    t, _ = _tables(_cols(4, "dyadic"))
    with trace_execution() as tr:
        got = run_sharded(LinregrAggregate(), t.select("x", "y"))
    assert [e.engine for e in tr.scans] == ["local"]
    _same(got, run_local(LinregrAggregate(), t.select("x", "y")))
    with pytest.raises(ValueError, match="pad first"):
        run_sharded(LinregrAggregate(), Table(
            {"x": t["x"][:7], "y": t["y"][:7]}), mesh=_mesh(2))


# ---------------------------------------------------------------------------
# The sharded GROUP BY.
# ---------------------------------------------------------------------------

GROUPED = {
    "linregr": ("segment", ("x", "y")), "countmin": ("segment", ("item",)),
    "fm": ("segment", ("item",)), "generic": ("masked", ("v",)),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["segment", "masked"])
@pytest.mark.parametrize("p", SEGS)
def test_run_grouped_is_bitwise_local_and_jax_on_dyadic_data(p, method,
                                                             masked):
    cols = _cols(5, "dyadic")
    t, jt = _tables(cols)
    mask = torch.from_numpy(cols["mask"]) if masked else None
    jmask = jnp.asarray(cols["mask"]) if masked else None
    d = t.distribute(_mesh(p))
    for name, (ok, use) in GROUPED.items():
        if method == "segment" and ok != "segment":
            continue
        make, jmake = AGGS[name]
        sel = use + ("g",)
        kw = {"method": method, "block_size": 32, "finalize": False}
        with trace_execution() as tr:
            got = run_grouped(make(), d.select(*sel), "g", G, mask=mask,
                              **kw)
        assert [(e.engine, e.detail["sharded"]) for e in tr.scans] == [
            (f"grouped-{method}", True)]
        _same(got, run_grouped(make(), t.select(*sel), "g", G, mask=mask,
                               **kw))
        _same(got, jagg.run_grouped(jmake(), jt.select(*sel), "g", G,
                                    mask=jmask, **kw))


@pytest.mark.parametrize("p", SEGS)
def test_each_segment_launches_its_segment_kernel(p):
    t, _ = _tables(_cols(6, "dyadic"))
    d = t.distribute(_mesh(p))
    with trace_execution() as tr:
        got = linregr_grouped(d, "g", G, use_kernel=True, block_size=32)
    assert [e.detail["name"] for e in tr.kernels] == ["segment_linregr"] * p
    _same(got, linregr_grouped(t, "g", G, use_kernel=True, block_size=32))
    p_ = plan([GroupedScanAgg(LinregrAggregate(), d, "g", G,
                              columns={"x": "x", "y": "y"})])
    assert p_.passes[0].engine == "sharded-grouped[segment]"


@pytest.mark.parametrize("p", [2, 8])
def test_run_grouped_is_close_on_gaussian_data(p):
    t, jt = _tables(_cols(7, "gauss"))
    sel = ("x", "y", "g")
    for method in ("segment", "masked"):
        got = run_grouped(LinregrAggregate(), t.select(*sel).distribute(
            _mesh(p)), "g", G, method=method, finalize=False)
        _close(got, jagg.run_grouped(JLinregrAggregate(), jt.select(*sel),
                                     "g", G, method=method, finalize=False))


# ---------------------------------------------------------------------------
# The planner and the Session.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", SEGS)
def test_a_session_batch_is_one_planned_scan(p):
    t, _ = _tables(_cols(8, "dyadic"))
    d = t.distribute(_mesh(p))

    def batch(tbl):
        s = Session()
        hs = [s.profile(tbl),
              s.linregr(tbl, use_kernel=True), s.countmin_sketch(tbl),
              s.fm_distinct_count(tbl)]
        s.run()
        return s, [h.result() for h in hs]

    with trace_execution() as tr:
        s, got = batch(d)
    want = "sharded" if p > 1 else "local"   # scan_cost's tie at 1 segment
    assert [e.engine for e in tr.scans] == [want]
    assert s.last_plan.passes[0].engine == want
    assert sum(e.detail["name"] == "xtx" for e in tr.kernels) == p \
        or want == "local"
    _same(got, batch(t)[1])
    # forced, the one-segment table folds through the sharded engine too
    with trace_execution() as tr:
        res = execute(ScanAgg(LinregrAggregate(), d, columns=("x", "y"),
                              engine="sharded"))
    assert [e.engine for e in tr.scans] == ["sharded"]
    _same(res, execute(ScanAgg(LinregrAggregate(), t, columns=("x", "y"))))


def test_a_living_view_keeps_the_mesh_and_refreshes_by_delta():
    cols = _cols(9, "dyadic")
    t = Table.from_columns(cols, device="cpu").distribute(_mesh(8))
    node = GroupedScanAgg(LinregrAggregate(), t, "g", G,
                          columns={"x": "x", "y": "y"})
    h = materialize(node)
    assert h.table.mesh is t.mesh
    extra = _cols(10, "dyadic", n=16)
    t.append({k: extra[k] for k in t.columns})
    assert h.refresh() == "delta"
    fresh = materialize(GroupedScanAgg(LinregrAggregate(), t, "g", G,
                                       columns={"x": "x", "y": "y"}))
    _same(h._state, fresh._state)
    with pytest.raises(ValueError, match="mesh"):
        materialize([node, GroupedScanAgg(LinregrAggregate(), t, "g", G,
                                          columns={"x": "x", "y": "y"},
                                          mesh=_mesh(2))])


@pytest.mark.parametrize("p", [2, 8])
def test_a_star_join_on_a_distributed_fact_is_the_local_join(p):
    draw = Draw(11 + p)
    fk, keys, attr, _ = join_layout(draw, N, 40, G, "dangling")
    fact = Table.from_columns({"x": draw.dyadic((N, 3)),
                               "y": draw.dyadic((N,)), "fk": fk},
                              device="cpu")
    dim = Table.from_columns({"key": keys, "region": attr}, device="cpu")
    kw = {"fact_key": "fk", "dim_key": "key", "attr_col": "region",
          "on_missing": "drop", "num_groups": G, "use_kernel": True}
    with trace_execution() as tr:
        got = linregr_joined(fact.distribute(_mesh(p)), dim, **kw)
    assert sum(e.detail["name"] == "segment_linregr"
               for e in tr.kernels) == p
    _same(got, linregr_joined(fact, dim, **kw))
    res = Join(fact.distribute(_mesh(p)), dim, "fk", "key", "region",
               on_missing="drop").resolve()
    assert res.table.mesh is not None
    np.testing.assert_array_equal(
        res.table[res.gid_col].numpy(),
        Join(fact, dim, "fk", "key", "region", on_missing="drop").resolve()
        .table[res.gid_col].numpy())


def test_kmeans_pp_seeding_on_segments_is_the_local_seeding():
    t, _ = _tables(_cols(12, "gauss"))
    d = t.select("x").distribute(_mesh(8))
    with trace_execution() as tr:
        got = km.kmeans_pp_seed(d, 5, seed=3)
    assert {e.engine for e in tr.scans} == {"sharded"}
    assert torch.equal(got, km.kmeans_pp_seed(t.select("x"), 5, seed=3))


# ---------------------------------------------------------------------------
# Iterative fits.
# ---------------------------------------------------------------------------

CENTERS = np.array([[0., 0., 0.], [6., 0., 0.], [0., 6., 0.], [0., 0., 6.]],
                   np.float32)


def _blobs(seed: int, n: int = N):
    draw = Draw(seed)
    lab = draw.ints((n,), 0, 3)
    x = (CENTERS[lab] + 0.5 * draw.normal((n, 3))).astype(np.float32)
    init = (CENTERS + np.array([1.0, -0.5, 0.75], np.float32))
    gids, _ = group_layout(draw, n, G, "skewed")
    return {"x": x, "g": gids}, init.astype(np.float32)


def _logistic(seed: int, n: int = N):
    draw = Draw(seed)
    x = draw.normal((n, 3))
    p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ [1.0, -2.0, 0.5])))
    gids, _ = group_layout(draw, n, 3, "uniform")
    return {"x": x, "y": (draw.uniform((n,)) < p).astype(np.float32),
            "g": gids}


def _stats_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["compiled", "host"])
@pytest.mark.parametrize("p", SEGS)
def test_fit_on_segments_matches_jax(p, mode):
    cols, init = _blobs(13)
    t, jt = _tables({"x": cols["x"]})
    kw = {"max_iters": 30, "tol": 0.5 / N, "mode": mode}
    with trace_execution() as tr:
        got = fit(km.KMeansTask(init), t.distribute(_mesh(p)), **kw)
    assert [e.engine for e in tr.fits] == ["sharded"]
    want = jit_.fit(jkm.KMeansTask(jnp.asarray(init)), jt.distribute(
        jmake_mesh((1,), ("data",))), **kw)
    assert got.n_iters == want.n_iters and got.converged == want.converged
    _close(got.state, want.state)
    local = fit(km.KMeansTask(init), t, **kw)
    assert got.n_iters == local.n_iters
    _close(got.state, local.state)
    # IRLS: the Hessian and gradient merge over the segments each round
    lcols = _logistic(14)
    lt, ljt = _tables({"x": lcols["x"], "y": lcols["y"]})
    got = fit(lr.IRLSTask(), lt, mesh=_mesh(p), max_iters=30, tol=1e-6,
              mode=mode)
    want = jit_.fit(jlr.IRLSTask(), ljt, max_iters=30, tol=1e-6, mode=mode)
    assert got.n_iters == want.n_iters and got.converged == want.converged
    _close(got.state, want.state, rtol=1e-4)


@pytest.mark.parametrize("p", SEGS)
def test_fit_grouped_on_segments_matches_jax(p):
    cols, init = _blobs(15)
    t, jt = _tables(cols)
    jmesh = jmake_mesh((1,), ("data",))
    for layout in ("segment", "masked"):
        kw = {"max_iters": 30, "tol": 0.5 / N, "layout": layout,
              "block_size": 32}
        got = fit_grouped(km.KMeansTask(init), t.distribute(_mesh(p)), "g",
                          G, **kw)
        want = jit_.fit_grouped(jkm.KMeansTask(jnp.asarray(init)), jt,
                                "g", G, mesh=jmesh, **kw)
        np.testing.assert_array_equal(got.n_iters, want.n_iters)
        np.testing.assert_array_equal(got.converged, want.converged)
        if layout == "segment":
            _stats_equal(got.stats, want.stats)
            assert got.stats["sharded"]
        _close(got.state["cents"], want.state["cents"])
    lcols = _logistic(16)
    lt, ljt = _tables(lcols)
    kw = {"max_iters": 30, "tol": 1e-6, "block_size": 32}
    got = fit_grouped(lr.IRLSTask(), lt, "g", 3, mesh=_mesh(p), **kw)
    want = jit_.fit_grouped(jlr.IRLSTask(), ljt, "g", 3, mesh=jmesh, **kw)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_array_equal(got.converged, want.converged)
    _stats_equal(got.stats, want.stats)
    _close(got.state["beta"], want.state["beta"], rtol=1e-4)


@pytest.mark.parametrize("p", [1, 2, 8])
def test_fit_grouped_first_round_is_bitwise_on_dyadic_data(p):
    draw = Draw(17)
    lab = draw.ints((N,), 0, 3)
    x = (CENTERS[lab] + draw.dyadic((N, 3), scale=0.5)).astype(np.float32)
    gids, _ = group_layout(draw, N, G, "singleton")
    _, init = _blobs(17)
    t, jt = _tables({"x": x, "g": gids})
    kw = {"max_iters": 1, "tol": None, "block_size": 32}
    got = fit_grouped(km.KMeansTask(init), t.distribute(_mesh(p)), "g", G,
                      **kw)
    want = jit_.fit_grouped(jkm.KMeansTask(jnp.asarray(init)), jt, "g", G,
                            **kw)
    _same(got.state["cents"], want.state["cents"])
    _same(got.trace, want.trace)


@pytest.mark.parametrize("p", [2, 8])
def test_parallel_sgd_is_the_per_segment_sgd_averaged_by_hand(p):
    cols = _logistic(18)
    t = Table.from_columns({"x": cols["x"], "y": cols["y"]}, device="cpu")
    prog = lr.logistic_program()
    kw = {"stepsize": 0.5, "epochs": 3, "batch": 16}
    got = parallel_sgd(prog, t, torch.zeros(3), mesh=_mesh(p), seed=5, **kw)
    gen = torch.Generator().manual_seed(5)
    rows = N // p
    models = [sgd(prog, Table({k: v[s * rows:(s + 1) * rows]
                               for k, v in t.columns.items()}),
                  torch.zeros(3), seed=gen, anneal=False, **kw)
              for s in range(p)]
    want = models[0]
    for m in models[1:]:
        want = want + m
    assert torch.equal(got, want / p)
    # the SGD methods branch on a distributed table, as the reference's do
    d = t.distribute(_mesh(p))
    assert torch.equal(lr.logregr_sgd(d, seed=5, **kw), parallel_sgd(
        prog, d, torch.zeros(3), seed=5, **kw))
    assert torch.equal(
        sm.fit_sgd_model("logistic", d, torch.zeros(3), seed=5, **kw),
        parallel_sgd(prog, d, torch.zeros(3), seed=5, **kw))


def test_calibration_measures_the_sharded_cells_on_a_mesh():
    """The harness adds the reference's ``sharded`` and
    ``sharded-grouped-*`` cells on a mesh of more than one segment, and
    skips them on one segment (as the reference does on one device)."""
    from repro_torch.launch.calibrate import measure

    def engines(p):
        out = measure([4096], [8], 1, [64], device="cpu", mesh=_mesh(p),
                      log=lambda *a: None)
        return set(out["engines"])

    local = {"local", "grouped-segment", "grouped-masked"}
    assert engines(1) == local
    assert engines(2) == local | {"sharded", "sharded-grouped-segment",
                                  "sharded-grouped-masked"}
