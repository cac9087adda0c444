"""The port's logistic regression (IRLS) against the JAX package's.

The same numpy draws go through both packages: x standard normal,
y ~ Bernoulli(sigmoid(x b)).  Held equal: ``n_iters``, ``converged`` and
the grouped ``stats`` dict.  Held bitwise on dyadic data: the first
IRLS pass's ``X^T D X``, ``X^T D z`` and row count (at beta = 0 every
weight is 1/4 and every working response 4y - 2, all exact).  Held
allclose: coefficients, log-likelihoods and Wald statistics, rtol 1e-4
and atol 1e-5 (f32 Newton steps; the two libraries' solves and matmuls
round differently).

The relative change of beta near convergence carries f32 noise of about
1e-7, so a round whose true step lies within that of ``tol`` = 1e-6 is
a near tie that either package may call either way (a draw of
``_data(40)`` steps 8.4e-7 in the port and 1.15e-6 in JAX at round 4).
The draws compared here step past ``tol`` by a factor of 3 or more on
either side (checked against the reference's metric traces), as the
k-means tests use well-separated blobs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import iterative as jit_
from repro.core.aggregates import run_local as jrun_local
from repro.core.table import Table as JTable
from repro.methods import logregr as jlr
from repro_torch.core import (
    Session, fit, fit_grouped, run_local, synthetic_classification_table,
    trace_execution,
)
from repro_torch.core.table import Table
from repro_torch.interop import state_to_numpy
from repro_torch.methods import logregr as lr
from strategies import Draw, group_layout

FIELDS = (("coef", "coef"), ("log_likelihood", "log_likelihood"),
          ("std_err", "std_err"), ("z_stats", "z_stats"),
          ("p_values", "p_values"))


def _data(seed: int, n: int = 3000, d: int = 4, dyadic: bool = False):
    draw = Draw(seed)
    x = draw.dyadic((n, d)) if dyadic else draw.normal((n, d))
    b = draw.normal((d,)) / np.sqrt(d)
    p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ b)))
    y = (draw.uniform((n,)) < p).astype(np.float32)
    return draw, {"x": x, "y": y}


def _tables(cols):
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


def _assert_result_close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_array_equal(np.asarray(got.n_iters),
                                  np.asarray(want.n_iters))
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(want.converged))
    for a, b in FIELDS:
        np.testing.assert_allclose(getattr(got, a).numpy(),
                                   np.asarray(getattr(want, b)), rtol=rtol,
                                   atol=atol, err_msg=a)


@pytest.mark.parametrize("mode", ["host", "compiled"])
@pytest.mark.parametrize("block_size", [None, 700])
def test_logregr_matches_jax(mode, block_size):
    _, cols = _data(1)
    t, jt = _tables(cols)
    got = lr.logregr(t, mode=mode, block_size=block_size)
    want = jlr.logregr(jt, mode=mode, block_size=block_size)
    _assert_result_close(got, want)
    assert got.converged and got.n_iters > 2


def test_irls_first_pass_is_bitwise_on_dyadic_data():
    draw, cols = _data(2, dyadic=True)
    mask = draw.bools((3000,), p=0.85)
    t, jt = _tables(cols)
    for block_size in (None, 512):
        got = state_to_numpy(run_local(
            lr.IRLSAggregate(torch.zeros(4)), t, block_size=block_size,
            mask=torch.from_numpy(mask), finalize=False))
        want = jrun_local(jlr.IRLSAggregate(jnp.zeros(4)), jt,
                          block_size=block_size, mask=jnp.asarray(mask),
                          finalize=False)
        for name in ("xdx", "xdz", "n"):
            np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                          err_msg=name)
        np.testing.assert_allclose(got["ll"], np.asarray(want["ll"]),
                                   rtol=1e-6)


def test_host_mode_runs_one_pass_per_iteration():
    """The §3.1.2 contract: each driver round = exactly ONE data pass."""
    _, cols = _data(3)
    t, _ = _tables(cols)
    passes = [0]

    class Counting(lr.IRLSAggregate):
        def transition(self, state, block, mask):
            passes[0] += 1
            return super().transition(state, block, mask)

    class Task(lr.IRLSTask):
        def make_aggregate(self, state):
            return Counting(state["beta"])

    res = fit(Task(), t, max_iters=30, tol=1e-6, mode="host")
    assert passes[0] == res.n_iters


def test_warm_start_skips_iterations():
    _, cols = _data(4)
    t, _ = _tables(cols)
    cold = lr.logregr(t, max_iters=30)
    warm = lr.logregr(t, max_iters=30, warm_start=cold.coef.numpy())
    assert warm.converged and warm.n_iters <= 2
    np.testing.assert_allclose(warm.coef.numpy(), cold.coef.numpy(),
                               rtol=1e-4, atol=1e-5)


def _grouped(seed: int, sizes, d: int = 4):
    """Per-group logistic data with DIFFERENT true coefficients, in one
    table with a group column."""
    xs, ys, gs = [], [], []
    for g, n in enumerate(sizes):
        _, cols = _data(seed + g, n, d)
        xs.append(cols["x"])
        ys.append(cols["y"])
        gs.append(np.full((n,), g, np.int32))
    return {"x": np.concatenate(xs), "y": np.concatenate(ys),
            "g": np.concatenate(gs)}


@pytest.mark.parametrize("layout", ["segment", "masked"])
def test_logregr_grouped_matches_jax(layout):
    cols = _grouped(10, [1024, 2048, 512])
    perm = Draw(5).permutation(len(cols["g"]))   # interleave the groups
    cols = {k: v[perm] for k, v in cols.items()}
    t, jt = _tables(cols)
    kw = {"max_iters": 30, "tol": 1e-6, "layout": layout, "block_size": 256}
    got = fit_grouped(lr.IRLSTask(), t, "g", 3, **kw)
    want = jit_.fit_grouped(jlr.IRLSTask(), jt, "g", 3, **kw)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_array_equal(got.converged, want.converged)
    assert set(got.stats) == set(want.stats)
    for name in want.stats:
        np.testing.assert_array_equal(np.asarray(got.stats[name]),
                                      np.asarray(want.stats[name]))
    np.testing.assert_allclose(got.state["beta"].numpy(),
                               np.asarray(want.state["beta"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.result["se"].numpy(),
                               np.asarray(want.result["se"]), rtol=1e-4)
    res = lr.logregr_grouped(t, "g", 3)
    _assert_result_close(res, jlr.logregr_grouped(jt, "g", 3))


def test_grouped_logregr_matches_solo():
    cols = _grouped(35, [1024, 2048, 512])
    t, _ = _tables(cols)
    grouped = lr.logregr_grouped(t, "g")
    assert grouped.coef.shape == (3, 4)
    for g in range(3):
        sel = cols["g"] == g
        solo = lr.logregr(Table.from_columns(
            {"x": cols["x"][sel], "y": cols["y"][sel]}, device="cpu"))
        np.testing.assert_allclose(grouped.coef[g].numpy(),
                                   solo.coef.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(grouped.log_likelihood[g]),
                                   float(solo.log_likelihood), rtol=1e-4)
        assert int(grouped.n_iters[g]) == solo.n_iters
        assert bool(grouped.converged[g]) == solo.converged


def test_grouped_empty_group_is_finite():
    """A group id with zero rows produces a finite degenerate model (zero
    coefficients), converges at once and does not poison the others."""
    _, cols = _data(30, 2048)
    g = np.where(np.arange(2048) % 2 == 0, 0, 2).astype(np.int32)
    t, jt = _tables(dict(cols, g=g))
    grouped = lr.logregr_grouped(t, "g", num_groups=3)
    want = jlr.logregr_grouped(jt, "g", num_groups=3)
    assert np.all(np.isfinite(grouped.coef.numpy()))
    np.testing.assert_allclose(grouped.coef[1].numpy(), 0.0)
    assert bool(grouped.converged[1]) and int(grouped.n_iters[1]) == 1
    np.testing.assert_array_equal(grouped.n_iters, want.n_iters)
    sel = g == 0
    solo = lr.logregr(Table.from_columns(
        {"x": cols["x"][sel], "y": cols["y"][sel]}, device="cpu"))
    np.testing.assert_allclose(grouped.coef[0].numpy(), solo.coef.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_session_logregr_and_fit_are_statements():
    _, cols = _data(1)
    cols["g"] = (np.arange(3000) % 2).astype(np.int32)
    t, jt = _tables(cols)
    sess = Session()
    solo = sess.logregr(t)
    grouped = sess.fit(lr.IRLSTask(), t.select("x", "y", "g"),
                       group_col="g", max_iters=30)
    with trace_execution() as tr:
        sess.run()
    assert [p.kind for p in sess.last_plan.passes] == ["fit", "fit"]
    assert [e.engine for e in tr.fits] == ["local", "grouped-segment"]
    _assert_result_close(solo.result(), jlr.logregr(jt))
    assert grouped.result().state["beta"].shape == (2, 4)


def test_synthetic_classification_table():
    t, b = synthetic_classification_table(7, 500, 3, device="cpu")
    again, b2 = synthetic_classification_table(
        torch.Generator().manual_seed(7), 500, 3, device="cpu")
    assert t["x"].shape == (500, 3) and b.shape == (3,)
    assert torch.equal(t["x"], again["x"]) and torch.equal(b, b2)
    assert set(torch.unique(t["y"]).tolist()) <= {0.0, 1.0}
    res = lr.logregr(t)
    assert res.converged
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            synthetic_classification_table(7, 10, 2)
