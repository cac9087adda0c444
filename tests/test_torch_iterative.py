"""The port's iterative executor against the JAX package's.

The same numpy draws go through ``repro.core.iterative`` and
``repro_torch.core.iterative``.  Held equal: ``n_iters``, ``converged``
and the grouped ``stats`` dict (layout, block size, rounds, blocks
scanned, per-round active rows).  Held bitwise on dyadic data: the
first round's fold results (centroids = sums / counts and the SSE),
where every partial sum is exact in f32.  Held allclose: later states
(rtol 1e-5, atol 1e-5), because the two libraries' matmuls round in
different orders once the centroids stop being dyadic.

The k-means task on well-separated blobs is the workhorse: its rounds
are decided by whole reassignments, never by a near tie, on every
``GROUP_PATTERNS`` layout (empty and singleton groups included).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import iterative as jit_
from repro.core import driver as jdrv
from repro.core.table import Table as JTable
from repro.methods import kmeans as jkm
from repro_torch.core import (
    FitResult, IterativeFit, Session, counted_driver, device_driver,
    execute, fit, fit_grouped, host_driver, relative_change, trace_execution,
)
from repro_torch.core.table import Table
from repro_torch.methods import kmeans as km
from strategies import GROUP_PATTERNS, Draw, group_layout

CENTERS = np.array([[0., 0., 0.], [6., 0., 0.], [0., 6., 0.], [0., 0., 6.]],
                   np.float32)


def _blobs(seed: int, n: int, dyadic: bool = False):
    """Rows around four well-separated centers, and a seeding near them
    (shifted, so the first rounds move)."""
    draw = Draw(seed)
    lab = draw.ints((n,), 0, 3)
    noise = draw.dyadic((n, 3), scale=0.5) if dyadic \
        else 0.5 * draw.normal((n, 3))
    x = (CENTERS[lab] + noise).astype(np.float32)
    init = (CENTERS + np.array([1.0, -0.5, 0.75], np.float32)).astype(
        np.float32)
    return draw, x, init


def _tables(cols):
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


def _assert_stats_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# fit: host and "compiled" mode, tol=None.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host", "compiled"])
@pytest.mark.parametrize("tol", [None, "default"])
def test_fit_matches_jax(mode, tol):
    _, x, init = _blobs(3, 600)
    t, jt = _tables({"x": x})
    n = x.shape[0]
    kw = {"max_iters": 6 if tol is None else 30,
          "tol": None if tol is None else 0.5 / n, "mode": mode}
    got = fit(km.KMeansTask(init), t, **kw)
    want = jit_.fit(jkm.KMeansTask(jnp.asarray(init)), jt, **kw)
    assert isinstance(got, FitResult)
    assert got.n_iters == want.n_iters
    assert got.converged == want.converged
    if tol is None:
        assert got.n_iters == 6 and not got.converged
    np.testing.assert_allclose(_np(got.state["cents"]),
                               np.asarray(want.state["cents"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got.trace), np.asarray(want.trace),
                               rtol=1e-5)


def test_fit_first_round_is_bitwise_on_dyadic_data():
    _, x, init = _blobs(5, 512, dyadic=True)
    t, jt = _tables({"x": x})
    for block_size in (None, 100):
        got = fit(km.KMeansTask(init), t, max_iters=1, tol=None,
                  block_size=block_size)
        want = jit_.fit(jkm.KMeansTask(jnp.asarray(init)), jt, max_iters=1,
                        tol=None, block_size=block_size)
        np.testing.assert_array_equal(_np(got.state["cents"]),
                                      np.asarray(want.state["cents"]))
        np.testing.assert_array_equal(_np(got.trace), np.asarray(want.trace))


def test_fit_masked_rows_and_warm_start():
    draw, x, init = _blobs(7, 700)
    mask = draw.bools((700,), p=0.7)
    t, jt = _tables({"x": x})
    got = fit(km.KMeansTask(init), t, max_iters=30, tol=0.5 / 700,
              mask=torch.from_numpy(mask))
    want = jit_.fit(jkm.KMeansTask(jnp.asarray(init)), jt, max_iters=30,
                    tol=0.5 / 700, mask=jnp.asarray(mask))
    assert (got.n_iters, got.converged) == (want.n_iters, want.converged)
    np.testing.assert_allclose(_np(got.state["cents"]),
                               np.asarray(want.state["cents"]), rtol=1e-5,
                               atol=1e-5)
    # a warm start from the converged state stops at the second round
    warm = fit(km.KMeansTask(init), t, max_iters=30, tol=0.5 / 700,
               mask=torch.from_numpy(mask), warm_start=got.state)
    assert warm.converged and warm.n_iters <= 2


def test_fit_records_one_event_and_host_mode_scans():
    _, x, init = _blobs(9, 300)
    t, _ = _tables({"x": x})
    with trace_execution() as tr:
        host = fit(km.KMeansTask(init), t, max_iters=30, tol=0.5 / 300,
                   mode="host")
    assert [(e.engine, e.detail["mode"]) for e in tr.fits] == [
        ("local", "host")]
    assert len(tr.scans) == host.n_iters  # one recorded pass per round
    with trace_execution() as tr:
        fit(km.KMeansTask(init), t, max_iters=30, tol=0.5 / 300)
    assert len(tr.scans) == 0 and len(tr.fits) == 1


def test_unported_engines_raise_naming_their_item():
    """The sharded engine is ported: a mesh that is not a Mesh raises
    TypeError; ``row_axes`` or ``engine="sharded"`` without a mesh run
    the local engine, as in the reference."""
    _, x, init = _blobs(11, 64)
    t, _ = _tables({"x": x})
    with pytest.raises(TypeError, match="Mesh"):
        fit(km.KMeansTask(init), t, mesh=object())
    want = fit(km.KMeansTask(init), t)
    for kw in ({"row_axes": ("data",)}, {"engine": "sharded"}):
        got = fit(km.KMeansTask(init), t, **kw)
        assert got.n_iters == want.n_iters
        assert torch.equal(got.state["cents"], want.state["cents"])
    # jit=False is the reference's un-jitted run: the same eager loop
    eager = fit(km.KMeansTask(init), t, jit=False)
    assert eager.n_iters == want.n_iters
    assert torch.equal(eager.state["cents"], want.state["cents"])
    with pytest.raises(TypeError, match="Mesh"):
        fit_grouped(km.KMeansTask(init), t.with_column(
            "g", torch.zeros(64, dtype=torch.int32)), "g", mesh=object())
    with pytest.raises(ValueError, match="unknown mode"):
        fit(km.KMeansTask(init), t, mode="scan")


def test_relative_change_matches_jax():
    draw = Draw(13)
    a = {"w": draw.normal((4, 3)), "b": draw.normal((3,))}
    b = {"w": draw.normal((4, 3)), "b": draw.normal((3,))}
    got = relative_change({k: torch.from_numpy(v) for k, v in a.items()},
                          {k: torch.from_numpy(v) for k, v in b.items()})
    want = jit_.relative_change(a, b)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# fit_grouped: segment and masked layouts on every GROUP_PATTERNS layout.
# ---------------------------------------------------------------------------

G = 5


def _grouped_case(pattern: str, dyadic: bool = False, n: int = 900):
    draw, x, init = _blobs(sum(map(ord, pattern)), n, dyadic)
    gids, _ = group_layout(draw, n, G, pattern)
    return _tables({"x": x, "g": gids}), init


@pytest.mark.parametrize("layout", ["segment", "masked"])
@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
def test_fit_grouped_matches_jax(pattern, layout):
    (t, jt), init = _grouped_case(pattern)
    kw = {"max_iters": 30, "tol": 0.5 / t.n_rows, "layout": layout,
          "block_size": 64}
    got = fit_grouped(km.KMeansTask(init), t, "g", G, **kw)
    want = jit_.fit_grouped(jkm.KMeansTask(jnp.asarray(init)), jt, "g", G,
                            **kw)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_array_equal(got.converged, want.converged)
    _assert_stats_equal(got.stats, want.stats)
    np.testing.assert_allclose(_np(got.state["cents"]),
                               np.asarray(want.state["cents"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got.trace), np.asarray(want.trace),
                               rtol=1e-5, atol=1e-3)
    assert got.state["cents"].shape == (G, 4, 3)


@pytest.mark.parametrize("pattern", ["skewed", "empty", "singleton"])
def test_fit_grouped_first_round_is_bitwise_on_dyadic_data(pattern):
    (t, jt), init = _grouped_case(pattern, dyadic=True)
    for layout in ("segment", "masked"):
        got = fit_grouped(km.KMeansTask(init), t, "g", G, max_iters=1,
                          tol=None, layout=layout, block_size=64)
        want = jit_.fit_grouped(jkm.KMeansTask(jnp.asarray(init)), jt, "g",
                                G, max_iters=1, tol=None, layout=layout,
                                block_size=64)
        np.testing.assert_array_equal(_np(got.state["cents"]),
                                      np.asarray(want.state["cents"]))
        np.testing.assert_array_equal(_np(got.trace), np.asarray(want.trace))
        np.testing.assert_array_equal(got.n_iters, want.n_iters)
        assert not got.converged.any()


def test_fit_grouped_counted_mode_and_masks_match_jax():
    (t, jt), init = _grouped_case("uniform")
    mask = Draw(17).bools((t.n_rows,), p=0.8)
    for layout in ("segment", "masked"):
        got = fit_grouped(km.KMeansTask(init), t, "g", G, max_iters=4,
                          tol=None, layout=layout,
                          mask=torch.from_numpy(mask))
        want = jit_.fit_grouped(jkm.KMeansTask(jnp.asarray(init)), jt, "g",
                                G, max_iters=4, tol=None, layout=layout,
                                mask=jnp.asarray(mask))
        np.testing.assert_array_equal(got.n_iters, [4] * G)
        np.testing.assert_array_equal(got.n_iters, want.n_iters)
        _assert_stats_equal(got.stats, want.stats)
        np.testing.assert_allclose(_np(got.state["cents"]),
                                   np.asarray(want.state["cents"]),
                                   rtol=1e-5, atol=1e-5)


def test_fit_grouped_auto_picks_the_layout_like_jax():
    (t, jt), init = _grouped_case("skewed")
    with trace_execution() as tr:
        fused = fit_grouped(km.KMeansTask(init), t, "g", G, max_iters=30)
        two = fit_grouped(km.KMeansTwoPassTask(init),
                          t.with_column("__row__", torch.arange(
                              t.n_rows, dtype=torch.int32)), "g", G,
                          max_iters=3, tol=None)
    assert fused.stats["layout"] == "segment"
    assert two.stats == {"layout": "masked"}
    assert [e.engine for e in tr.fits] == ["grouped-segment",
                                           "grouped-masked"]
    with pytest.raises(ValueError, match="single-scan"):
        fit_grouped(km.KMeansTwoPassTask(init), t, "g", G, layout="segment")


def test_grouped_fit_shares_the_sort_with_grouped_scans():
    """A Session batch of a grouped scan and a grouped fit over the same
    (table, key): two passes, one partitioning sort."""
    from repro_torch.methods.linregr import LinregrAggregate
    (t, _), init = _grouped_case("uniform")
    t = t.with_column("y", t["x"][:, 0].clone())
    sess = Session()
    scan = sess.grouped_scan(LinregrAggregate(), t, "g", G,
                             columns={"x": "x", "y": "y"})
    fitted = sess.fit(km.KMeansTask(init), t.select("x", "g", "y"),
                      group_col="g", num_groups=G, max_iters=30)
    with trace_execution() as tr:
        sess.run()
    assert len(tr.sorts) == 2  # two tables: the fit's is its own
    t = Table(dict(t.columns))   # fresh memos
    sess = Session()
    scan = sess.grouped_scan(LinregrAggregate(), t, "g", G,
                             columns={"x": "x", "y": "y"})
    fitted = sess.fit(km.KMeansTask(init), t, group_col="g", num_groups=G,
                      max_iters=30, tol=0.5 / t.n_rows)
    with trace_execution() as tr:
        sess.run()
    assert len(tr.sorts) == 1
    assert [p.kind for p in sess.last_plan.passes] == ["grouped", "fit"]
    assert scan.result().coef.shape == (G, 3)
    assert fitted.result().n_iters.shape == (G,)


# ---------------------------------------------------------------------------
# driver.py: host, device and counted drivers against JAX's.
# ---------------------------------------------------------------------------

def _newton_sqrt(s):
    """One Newton step towards sqrt(2) of every entry."""
    return 0.5 * (s + 2.0 / s)


def _metric(prev, new):
    return abs(new - prev).max()


def test_drivers_match_jax():
    x0 = np.array([1.0, 3.0, 10.0], np.float32)
    for name in ("host_driver", "device_driver"):
        got = {"host_driver": host_driver,
               "device_driver": device_driver}[name](
            _newton_sqrt, torch.from_numpy(x0), metric=_metric, tol=1e-6,
            max_iters=20)
        want = getattr(jdrv, name)(_newton_sqrt, jnp.asarray(x0),
                                   metric=_metric, tol=1e-6, max_iters=20)
        assert (got.n_iters, got.converged) == (want.n_iters,
                                                want.converged), name
        np.testing.assert_allclose(_np(got.state), np.asarray(want.state),
                                   rtol=1e-6)
        np.testing.assert_allclose(got.metric_trace,
                                   np.asarray(want.metric_trace), rtol=1e-5)
    x = torch.from_numpy(x0)
    got = counted_driver(_newton_sqrt, x, 3)
    want = jdrv.counted_driver(_newton_sqrt, jnp.asarray(x0), 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    assert torch.equal(x, torch.from_numpy(x0))  # the caller's copy stays
