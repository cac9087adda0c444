"""The port's §5.1 convex layer against the JAX package's.

The same numpy draws go through ``repro.core.convex`` (and the methods on
it) and ``repro_torch.core.convex``.  Tolerances:

* ``GradientAggregate`` / ``HessianAggregate`` states: rtol 1e-5,
  atol 1e-5 (the same f32 sums in other orders);
* ``gradient_descent``, ``newton`` and ``conjugate_gradient``: params
  rtol 1e-4, atol 1e-5 (f32 steps compounding those differences); the
  trace length, ``converged`` and CG's iteration count equal;
* ``svm_fit(solver="gd")``: rtol 1e-4 (atol 1e-5);
* ``fit_grouped(LinregrTask())``: the coefficients and statistics rtol
  1e-4, atol 1e-5; row counts, ``n_iters`` and the grouped ``stats``
  dict equal.

The convergence settings are chosen so that no round's metric lies
within f32 noise of ``tol`` (a near tie either package may call either
way, see ``tests/test_torch_logregr.py``).

SGD shuffles with the library's own random stream, which torch cannot
reproduce.  With ``batch == n_rows`` the one minibatch is the whole
table, so the shuffle only reorders a sum: then ``sgd`` matches JAX at
rtol 1e-4 (atol 1e-5) over 3 epochs, with and without annealing.  With
smaller batches the reference's own property tests hold instead
(``tests/test_methods.py``): SGD logistic regression within cosine 0.98
of IRLS, SVM accuracy above 0.97, low-rank RMSE under half the ratings'
standard deviation, and the registry's six models.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convex as jcvx
from repro.core import iterative as jit_
from repro.core.aggregates import run_local as jrun_local
from repro.core.table import Table as JTable
from repro.methods import linregr as jlin
from repro.methods import logregr as jlr
from repro.methods import sgd_models as jsm
from repro.methods import svm as jsvm
from repro_torch.core import (
    ConvexProgram, GradientAggregate, HessianAggregate, conjugate_gradient,
    fit_grouped, gradient_descent, newton, parallel_sgd, run_local, sgd,
)
from repro_torch.core.table import Table
from repro_torch.methods import linregr as lin
from repro_torch.methods import logregr as lr
from repro_torch.methods import sgd_models as sm
from repro_torch.methods import svd
from repro_torch.methods import svm
from strategies import GROUP_PATTERNS, Draw, group_layout

RTOL, ATOL = 1e-4, 1e-5


def _tables(cols):
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


def _regression(seed: int, n: int = 600, d: int = 5):
    draw = Draw(seed)
    x = draw.normal((n, d))
    b = draw.normal((d,))
    y = (x @ b + 0.1 * draw.normal((n,))).astype(np.float32)
    return {"x": x, "y": y}


def _classification(seed: int, n: int = 600, d: int = 5):
    draw = Draw(seed)
    x = draw.normal((n, d))
    b = draw.normal((d,)) / np.sqrt(d) * 2.0
    p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ b)))
    y = (draw.uniform((n,)) < p).astype(np.float32)
    return {"x": x, "y": y}


def _two_class(seed: int, n: int = 2000, d: int = 4):
    """tests/test_methods.py's ``two_class``: two unit Gaussians at ±1.5."""
    draw = Draw(seed)
    x = np.concatenate([draw.normal((n, d)) + 1.5, draw.normal((n, d)) - 1.5])
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.float32)
    return {"x": x.astype(np.float32), "y": y}


def _programs():
    """name -> (port program, reference program, data maker)."""
    return {
        "least_squares": (sm.least_squares_program(0.01),
                          jsm.least_squares_program(0.01), _regression),
        "lasso": (sm.lasso_program(0.1), jsm.lasso_program(0.1),
                  _regression),
        "logistic": (lr.logistic_program(0.01), jlr.logistic_program(0.01),
                     _classification),
        "svm": (svm.svm_program(1e-3), jsvm.svm_program(1e-3),
                _classification),
    }


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# The aggregates.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["least_squares", "lasso", "logistic",
                                  "svm"])
@pytest.mark.parametrize("block_size", [None, 128])
def test_gradient_aggregate_matches_jax(name, block_size):
    prog, jprog, data = _programs()[name]
    cols = data(1)
    draw = Draw(2)
    w = draw.normal((cols["x"].shape[1],))
    mask = draw.bools((cols["x"].shape[0],), p=0.8)
    t, jt = _tables(cols)
    got = run_local(GradientAggregate(prog, torch.from_numpy(w)), t,
                    block_size=block_size, mask=torch.from_numpy(mask))
    want = jrun_local(jcvx.GradientAggregate(jprog, jnp.asarray(w)), jt,
                      block_size=block_size, mask=jnp.asarray(mask))
    for k in ("grad", "loss"):
        _close(got[k], want[k], 1e-5, 1e-5, k)
    assert int(got["n"]) == int(want["n"]) == int(mask.sum())
    assert got["n"].dtype == torch.int32


@pytest.mark.parametrize("name", ["least_squares", "logistic"])
@pytest.mark.parametrize("block_size", [None, 128])
def test_hessian_aggregate_matches_jax(name, block_size):
    prog, jprog, data = _programs()[name]
    cols = data(3)
    w = Draw(4).normal((cols["x"].shape[1],))
    t, jt = _tables(cols)
    got = run_local(HessianAggregate(prog, torch.from_numpy(w)), t,
                    block_size=block_size)
    want = jrun_local(jcvx.HessianAggregate(jprog, jnp.asarray(w)), jt,
                      block_size=block_size)
    for k in ("grad", "hess", "loss"):
        _close(got[k], want[k], 1e-5, 1e-5, k)
    assert int(got["n"]) == int(want["n"])


def test_hessian_aggregate_wants_a_flat_vector():
    prog = sm.least_squares_program()
    with pytest.raises(ValueError, match="flat parameter vector"):
        HessianAggregate(prog, torch.zeros((2, 2)))


# ---------------------------------------------------------------------------
# The deterministic solvers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["compiled", "host"])
@pytest.mark.parametrize("name,stepsize,max_iters,tol", [
    ("least_squares", 1e-3, 200, 1.0),     # converges
    ("logistic", 2e-3, 25, 1e-6),          # runs out of rounds
    ("lasso", 1e-3, 30, 1e-6),
])
def test_gradient_descent_matches_jax(mode, name, stepsize, max_iters, tol):
    prog, jprog, data = _programs()[name]
    cols = data(5)
    t, jt = _tables(cols)
    d = cols["x"].shape[1]
    got, trace, conv = gradient_descent(
        prog, t, torch.zeros(d), stepsize=stepsize, max_iters=max_iters,
        tol=tol, block_size=256, mode=mode)
    want, jtrace, jconv = jcvx.gradient_descent(
        jprog, jt, jnp.zeros(d), stepsize=stepsize, max_iters=max_iters,
        tol=tol, block_size=256, mode=mode)
    assert len(trace) == len(jtrace) and conv == jconv
    assert conv == (name == "least_squares")
    _close(got, want)
    _close(np.array(trace), np.array(jtrace), 1e-4, 1e-4, "trace")


@pytest.mark.parametrize("mode", ["compiled", "host"])
@pytest.mark.parametrize("name", ["least_squares", "logistic"])
def test_newton_matches_jax(mode, name):
    prog, jprog, data = _programs()[name]
    cols = data(6)
    t, jt = _tables(cols)
    d = cols["x"].shape[1]
    got, trace, conv = newton(prog, t, torch.zeros(d), max_iters=20,
                              tol=1e-5, block_size=200, mode=mode)
    want, jtrace, jconv = jcvx.newton(jprog, jt, jnp.zeros(d), max_iters=20,
                                      tol=1e-5, block_size=200, mode=mode)
    assert len(trace) == len(jtrace) and conv == jconv and conv
    _close(got, want)
    _close([tr[0] for tr in trace], [tr[0] for tr in jtrace], 1e-5, 1e-4,
           "loss trace")


def test_newton_least_squares_is_ols():
    """One Newton step at ridge 0 solves the normal equations, as
    ``linregr`` does (chip_smoke.py holds the card to this)."""
    cols = _regression(7)
    t, _ = _tables(cols)
    w, trace, _ = newton(sm.least_squares_program(), t, torch.zeros(5),
                         max_iters=1, tol=None, ridge=0.0)
    assert len(trace) == 1
    _close(w, lin.linregr(t).coef, 1e-4, 1e-5)


@pytest.mark.parametrize("tol,max_iters", [(1e-3, None), (1e-8, 5)])
def test_conjugate_gradient_matches_jax(tol, max_iters):
    cols = _regression(8, n=400, d=12)
    x = cols["x"].astype(np.float32)
    b = (x.T @ cols["y"]).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    got, res, it = conjugate_gradient(lambda v: xt.T @ (xt @ v),
                                      torch.from_numpy(b), tol=tol,
                                      max_iters=max_iters)
    want, jres, jit_n = jcvx.conjugate_gradient(
        lambda v: xj.T @ (xj @ v), jnp.asarray(b), tol=tol,
        max_iters=max_iters)
    assert it == int(jit_n)
    assert it == (5 if max_iters else it) and 0 < it < 24
    _close(got, want)
    _close(res, jres, 1e-3, 1e-4, "residual")
    if max_iters is None:
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(
            x.T.astype(np.float64) @ x, b), rtol=1e-3, atol=1e-4)


def test_svm_gd_matches_jax():
    cols = _classification(9, n=500)
    t, jt = _tables(cols)
    got = svm.svm_fit(t, solver="gd")
    want = jsvm.svm_fit(jt, solver="gd")
    _close(got, want)
    np.testing.assert_array_equal(svm.svm_predict(got, t["x"]).numpy(),
                                  np.asarray(jsvm.svm_predict(want, jt["x"])))


@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fit_grouped_linregr_task_matches_jax(pattern, use_kernel):
    draw = Draw(10)
    cols = _regression(11, n=900, d=4)
    gids, _ = group_layout(draw, 900, 6, pattern)
    cols["g"] = gids
    t, jt = _tables(cols)
    kw = {"max_iters": 1, "tol": None}
    got = fit_grouped(lin.LinregrTask(use_kernel), t, "g", 6, **kw)
    want = jit_.fit_grouped(jlin.LinregrTask(), jt, "g", 6, **kw)
    np.testing.assert_array_equal(got.n_iters, np.asarray(want.n_iters))
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        np.testing.assert_array_equal(np.asarray(got.stats[k]),
                                      np.asarray(want.stats[k]), err_msg=k)
    np.testing.assert_array_equal(got.result.num_rows.numpy(),
                                  np.asarray(want.result.num_rows))
    full = want.result.num_rows > 4        # groups with a solvable fit
    for f in ("coef", "r2", "std_err"):
        _close(getattr(got.result, f).numpy()[full],
               np.asarray(getattr(want.result, f))[full], what=f)


def test_fit_grouped_linregr_task_equals_linregr_grouped():
    draw = Draw(12)
    cols = _regression(13, n=700, d=3)
    cols["g"], _ = group_layout(draw, 700, 5, "uniform")
    t, _ = _tables(cols)
    got = fit_grouped(lin.LinregrTask(), t, "g", 5, max_iters=1, tol=None)
    want = lin.linregr_grouped(t, "g", 5)
    _close(got.result.coef, want.coef, 1e-5, 1e-6)
    np.testing.assert_array_equal(got.result.num_rows, want.num_rows)


# ---------------------------------------------------------------------------
# SGD: full batch (the shuffle only reorders a sum) against JAX.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("anneal", [True, False])
@pytest.mark.parametrize("name,stepsize", [("least_squares", 0.5),
                                           ("logistic", 1.0), ("svm", 0.5),
                                           ("lasso", 0.5)])
def test_sgd_full_batch_matches_jax(anneal, name, stepsize):
    prog, jprog, data = _programs()[name]
    cols = data(14, n=320)
    t, jt = _tables(cols)
    d = cols["x"].shape[1]
    w0 = Draw(15).normal((d,)) * 0.1
    got = sgd(prog, t, torch.from_numpy(w0), stepsize=stepsize, epochs=3,
              batch=320, seed=1, anneal=anneal)
    want = jcvx.sgd(jprog, jt, jnp.asarray(w0), stepsize=stepsize, epochs=3,
                    batch=320, anneal=anneal)
    _close(got, want)
    assert not np.allclose(got.numpy(), w0)


def test_sgd_drops_the_tail_and_reads_the_mask():
    """n mod batch rows sit out each epoch; with batch > n no step runs.
    ``fit``'s mask reaches the minibatches: masked rows add nothing."""
    prog, _, data = _programs()["least_squares"]
    cols = data(16, n=100)
    t, _ = _tables(cols)
    w0 = torch.zeros(5)
    assert torch.equal(sgd(prog, t, w0, batch=101), w0)
    from repro_torch.core import fit
    from repro_torch.core.convex import SGDEpochTask
    mask = torch.zeros(100, dtype=torch.bool)
    res = fit(SGDEpochTask(sm.least_squares_program(), w0, 0.1, 10), t,
              max_iters=2, tol=None, mask=mask)
    assert torch.equal(res.state["params"], w0)
    assert int(res.state["epoch"]) == 2


def test_sgd_seed_is_reproducible_and_a_generator_works():
    prog, _, data = _programs()["logistic"]
    t, _ = _tables(data(17))
    a = sgd(prog, t, torch.zeros(5), batch=32, epochs=2, seed=3)
    b = sgd(prog, t, torch.zeros(5), batch=32, epochs=2, seed=3)
    gen = torch.Generator().manual_seed(3)
    c = sgd(prog, t, torch.zeros(5), batch=32, epochs=2, seed=gen)
    d = sgd(prog, t, torch.zeros(5), batch=32, epochs=2, seed=4)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, d)


def test_parallel_sgd_without_a_mesh_is_sgd():
    prog, _, data = _programs()["logistic"]
    t, _ = _tables(data(18))
    a = parallel_sgd(prog, t, torch.zeros(5), batch=32, seed=2)
    b = sgd(prog, t, torch.zeros(5), batch=32, seed=2)
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Mesh"):
        parallel_sgd(prog, t, torch.zeros(5), mesh=object())


# ---------------------------------------------------------------------------
# SGD with small batches: the reference's property tests.
# ---------------------------------------------------------------------------

def test_logregr_sgd_agrees_with_irls():
    cols = _classification(19, n=8192, d=6)
    t, _ = _tables(cols)
    irls = lr.logregr(t)
    w = lr.logregr_sgd(t, epochs=10, stepsize=0.5, batch=128, seed=5)
    cos = float(torch.dot(w, irls.coef)
                / (torch.linalg.norm(w) * torch.linalg.norm(irls.coef)))
    assert cos > 0.98


def test_svm_sgd_separates_two_classes():
    cols = _two_class(20)
    t, _ = _tables(cols)
    w = svm.svm_fit(t, epochs=5, stepsize=0.1, seed=6)
    acc = float((svm.svm_predict(w, t["x"]) == t["y"].to(torch.int32))
                .float().mean())
    assert acc > 0.97
    assert svm.svm_predict(w, t["x"]).dtype == torch.int32


def test_lowrank_sgd_learns():
    draw = Draw(21)
    nr, nc, rank, n = 64, 48, 3, 6000
    l0, r0 = draw.normal((nr, rank)), draw.normal((nc, rank))
    ii, jj = draw.ints((n,), 0, nr - 1), draw.ints((n,), 0, nc - 1)
    vv = np.sum(l0[ii] * r0[jj], -1).astype(np.float32)
    t = Table.from_columns({"i": ii.astype(np.float32),
                            "j": jj.astype(np.float32), "v": vv},
                           device="cpu")
    params = svd.lowrank_sgd(t, nr, nc, rank, seed=7)
    pred = torch.sum(params["L"][torch.from_numpy(ii).long()]
                     * params["R"][torch.from_numpy(jj).long()], -1)
    rmse = float(torch.sqrt(torch.mean((pred - torch.from_numpy(vv)) ** 2)))
    assert rmse < 0.5 * float(np.std(vv))


def test_lowrank_program_matches_jax_gradient():
    from repro.methods import svd as jsvd
    draw = Draw(22)
    cols = {"i": draw.ints((200,), 0, 9).astype(np.float32),
            "j": draw.ints((200,), 0, 6).astype(np.float32),
            "v": draw.normal((200,))}
    params = {"L": draw.normal((10, 3)), "R": draw.normal((7, 3))}
    t, jt = _tables(cols)
    got = run_local(GradientAggregate(
        svd.lowrank_program(10, 7, 3, 0.1),
        {k: torch.from_numpy(v) for k, v in params.items()}), t)
    want = jrun_local(jcvx.GradientAggregate(
        jsvd.lowrank_program(10, 7, 3, 0.1),
        {k: jnp.asarray(v) for k, v in params.items()}), jt)
    for k in ("L", "R"):
        _close(got["grad"][k], want["grad"][k], 1e-5, 1e-5, k)
    _close(got["loss"], want["loss"], 1e-5, 1e-5)


def test_sgd_registry_fits_least_squares_and_lasso():
    draw = Draw(23)
    x = draw.normal((2048, 6))
    b = draw.normal((6,))
    y = (x @ b + 0.1 * draw.normal((2048,))).astype(np.float32)
    t, _ = _tables({"x": x, "y": y})
    for name in ("least_squares", "lasso"):
        w = sm.fit_sgd_model(name, t, torch.zeros(6), epochs=3,
                             stepsize=0.05, seed=8)
        assert float(torch.linalg.norm(w - torch.from_numpy(b))) < 0.8
    assert set(sm.REGISTRY) == set(jsm.REGISTRY) == {
        "least_squares", "lasso", "logistic", "svm", "recommendation", "crf"}


def test_convex_program_adds_the_regularizer_once():
    prog = ConvexProgram(loss=lambda p, b, m: torch.sum(b["x"] * p * m),
                         regularizer=lambda p: 10.0 * p)
    block = {"x": torch.ones(4)}
    mask = torch.ones(4)
    assert float(prog.total_loss(torch.tensor(2.0), block, mask)) == 28.0
