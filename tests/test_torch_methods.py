"""The port's one-pass and EM methods against the JAX package's: naive
Bayes, quantiles, decision trees, apriori, SVD, LDA, RLE sparse vectors
and array operations.

The same numpy draws (``strategies.Draw``) go through both packages.
Tolerances, by what each state is made of:

* bitwise: fold states that are sums of exact terms (naive Bayes on
  dyadic features, histograms, split statistics and apriori supports,
  which count 1.0s), trees grown from them, grouped against solo, RLE
  and array operations on exact values;
* naive Bayes models: rtol 1e-6 on dyadic features (the libraries'
  ``log`` differ in the last ulp), 1e-5 on Gaussian ones (f32 sums in
  another order); predictions equal where the top two log-likelihoods
  are more than 1e-3 apart;
* quantile values: rtol 1e-6 (the interpolation's f32 rounding);
* SVD: the ``A^T A Q`` state from the same ``q`` rtol 1e-5; singular
  values rtol 1e-4 (each package draws its own start and converges);
* LDA: the E-step state and one M-step update from the same
  ``log_beta`` rtol 1e-5 (digamma and logsumexp differ in the last
  ulps between the libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.methods.array_ops as jarr
import repro.methods.assoc_rules as jar
import repro.methods.decision_tree as jdt
import repro.methods.lda as jlda
import repro.methods.naive_bayes as jnb
import repro.methods.quantiles as jq
import repro.methods.sparse_vector as jsv
import repro.methods.svd as jsvd
from repro_torch.core import (
    Session, Table, run_grouped, run_local, trace_execution,
)
from repro_torch.methods import (
    array_ops as tarr, assoc_rules as tar, decision_tree as tdt, lda as tlda,
    naive_bayes as tnb, quantiles as tq, sparse_vector as tsv, svd as tsvd,
)
from strategies import Draw


def _tables(cols):
    return Table.from_columns(cols, device="cpu"), \
        jcore.Table.from_columns(cols)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Naive Bayes.
# ---------------------------------------------------------------------------

def _nb_cols(seed, n=700, d=5, classes=3, dyadic=True):
    draw = Draw(seed)
    x = draw.dyadic((n, d)) if dyadic else draw.normal((n, d))
    return {"x": x, "y": draw.ints((n,), 0, classes - 1).astype(np.float32),
            "g": draw.ints((n,), 0, 3)}


@pytest.mark.parametrize("block_size", [None, 64, 333])
def test_naive_bayes_fold_state_bitwise(block_size):
    t, j = _tables(_nb_cols(1 + (block_size or 0)))
    got = run_local(tnb.NaiveBayesAggregate(3), t.select("x", "y"),
                    block_size=block_size, finalize=False)
    want = jcore.run_local(jnb.NaiveBayesAggregate(3), j.select("x", "y"),
                           block_size=block_size, finalize=False)
    for k in want:
        _eq(got[k], want[k])


def test_naive_bayes_model_and_predictions():
    cols = _nb_cols(2, n=2000, dyadic=False)
    cols["x"][cols["y"] == 1] += 1.0
    t, j = _tables(cols)
    got, want = tnb.naive_bayes_fit(t, 3), jnb.naive_bayes_fit(j, 3)
    for f in ("log_prior", "mean", "var"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-5)
    # the same model in both packages: predictions agree off near ties
    model = tnb.NaiveBayesModel(*(_t(np.asarray(getattr(want, f)))
                                  for f in ("log_prior", "mean", "var")))
    x = cols["x"]
    pred = _np(tnb.naive_bayes_predict(model, _t(x)))
    jpred = np.asarray(jnb.naive_bayes_predict(want, jnp.asarray(x)))
    ll = -0.5 * np.sum(np.log(2 * np.pi * _np(model.var))[None]
                       + (x[:, None, :] - _np(model.mean)[None]) ** 2
                       / _np(model.var)[None], -1) + _np(model.log_prior)
    top2 = np.sort(ll, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(pred[clear], jpred[clear])


def test_naive_bayes_grouped_matches_jax_and_solo():
    cols = _nb_cols(3, n=1200, d=4)
    t, j = _tables(cols)
    got = tnb.naive_bayes_grouped(t, "g", 3)
    want = jnb.naive_bayes_grouped(j, "g", 3)
    assert got.mean.shape == (4, 3, 4)
    for f in ("log_prior", "mean", "var"):   # log differs in the last ulp
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    states = run_grouped(tnb.NaiveBayesAggregate(3), t, "g", 4,
                         finalize=False)
    jstates = jcore.run_grouped(jnb.NaiveBayesAggregate(3), j, "g", 4,
                                finalize=False)
    for k in jstates:
        _eq(states[k], jstates[k])
    for i in range(4):
        sel = cols["g"] == i
        solo = tnb.naive_bayes_fit(Table.from_columns(
            {"x": cols["x"][sel], "y": cols["y"][sel]}, device="cpu"), 3)
        for f in ("log_prior", "mean", "var"):
            _eq(getattr(got, f)[i], _np(getattr(solo, f)))


def test_session_naive_bayes_fuses_with_the_batch():
    t, _ = _tables(_nb_cols(4))
    sess = Session()
    nb = sess.naive_bayes(t, 3)
    sess.linregr(t)
    with trace_execution() as tr:
        sess.run()
    assert len(tr.scans) == 1
    solo = tnb.naive_bayes_fit(t, 3)
    for f in ("log_prior", "mean", "var"):
        _eq(getattr(nb.result(), f), _np(getattr(solo, f)))


# ---------------------------------------------------------------------------
# Quantiles.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bins", [7, 1000, 4096])
def test_quantile_bin_index_matches_jax(bins):
    draw = Draw(bins)
    t = np.concatenate([draw.uniform((500,), -0.2, 1.2),
                        np.array([np.nan, np.inf, -np.inf, -0.0, 1.0,
                                  -1e-7, 0.99999994, 3e9, -3e9],
                                 np.float32)]).astype(np.float32)
    want = jnp.clip((jnp.asarray(t) * bins).astype(jnp.int32), 0, bins - 1)
    _eq(tq.bin_index(_t(t) * bins, bins), want)


@pytest.mark.parametrize("bins,block_size", [(4096, None), (1000, 256),
                                             (37, 999)])
def test_histogram_equal_and_quantiles_close(bins, block_size):
    draw = Draw(10 + bins)
    v = np.concatenate([draw.normal((3000,)),
                        draw.dyadic((500,), denom=4, scale=3.0)])
    t, j = _tables({"v": v})
    lo, hi = float(v.min()), float(v.max())
    got = run_local(tq.HistogramAggregate(lo, hi, bins), t,
                    block_size=block_size)
    want = jcore.run_local(jq.HistogramAggregate(lo, hi, bins), j,
                           block_size=block_size)
    _eq(got, want)
    qs = [0.01, 0.1, 0.25, 0.5, 0.9, 0.999]
    np.testing.assert_allclose(
        _np(tq.quantiles(t, qs, bins=bins, block_size=block_size)),
        np.asarray(jq.quantiles(j, qs, bins=bins, block_size=block_size)),
        rtol=1e-6)


def test_quantiles_grouped_matches_jax_and_solo_with_one_sort():
    draw = Draw(20)
    cols = {"v": draw.normal((1500,)), "g": draw.ints((1500,), 0, 4)}
    t, j = _tables(cols)
    qs = [0.1, 0.25, 0.5, 0.9]
    with trace_execution() as tr:
        got = tq.quantiles_grouped(t, "g", qs, bins=512)
    assert len(tr.sorts) == 1
    want = jq.quantiles_grouped(j, "g", qs, bins=512)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    for i in range(4):
        solo = tq.quantiles(Table.from_columns(
            {"v": cols["v"][cols["g"] == i]}, device="cpu"), qs, bins=512)
        _eq(got[i], _np(solo))


# ---------------------------------------------------------------------------
# Decision trees.
# ---------------------------------------------------------------------------

def _xor_cols(seed=6, n=4000):
    draw = Draw(seed)
    x = draw.uniform((n, 3))
    y = ((x[:, 0] > 0.5) ^ (x[:, 1] > 0.3)).astype(np.int32)
    return {"x": x, "y": y}


def _same_tree(got, want):
    _eq(got.feature, want.feature)
    _eq(got.threshold, want.threshold)
    _eq(got.leaf_class, want.leaf_class)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_split_stats_bitwise(level):
    cols = _xor_cols(7, 1500)
    t, j = _tables(cols)
    x = cols["x"]
    lo, hi = x.min(0), x.max(0) + np.float32(1e-6)
    want_tree = jdt.decision_tree_fit(j, num_classes=2, max_depth=level)
    model = tdt.TreeModel(_t(np.asarray(want_tree.feature)),
                          _t(np.asarray(want_tree.threshold)),
                          _t(np.asarray(want_tree.leaf_class)), level)
    got = run_local(tdt.SplitStatsAggregate(model, level, _t(lo), _t(hi), 16,
                                            2), t, block_size=500)
    want = jcore.run_local(jdt.SplitStatsAggregate(
        want_tree, level, jnp.asarray(lo), jnp.asarray(hi), 16, 2), j,
        block_size=500)
    _eq(got, want)
    assert float(got.sum()) == x.shape[0] * x.shape[1]
    # the driver's split choice from the same statistics
    for a, b in zip(tdt._best_splits(got, _t(lo), _t(hi), 8.0),
                    jdt._best_splits(want, jnp.asarray(lo), jnp.asarray(hi),
                                     8.0)):
        _eq(a, b)


def test_best_split_ties_pick_the_first_feature():
    """Two identical features tie on every threshold: both packages keep
    the first (argmax's first maximum)."""
    draw = Draw(8)
    stats = draw.ints((2, 1, 8, 2), 0, 20).astype(np.float32)
    stats = np.concatenate([stats, stats], axis=1)      # (2, 2, 8, 2)
    lo, hi = np.zeros(2, np.float32), np.ones(2, np.float32)
    got = tdt._best_splits(_t(stats), _t(lo), _t(hi), 1.0)
    want = jdt._best_splits(jnp.asarray(stats), jnp.asarray(lo),
                            jnp.asarray(hi), 1.0)
    for a, b in zip(got, want):
        _eq(a, b)
    assert (_np(got[0]) == 0).all()


def test_decision_tree_xor_equal():
    cols = _xor_cols()
    t, j = _tables(cols)
    got = tdt.decision_tree_fit(t, num_classes=2, max_depth=3)
    want = jdt.decision_tree_fit(j, num_classes=2, max_depth=3)
    _same_tree(got, want)
    pred = tdt.decision_tree_predict(got, _t(cols["x"]))
    _eq(pred, jdt.decision_tree_predict(want, jnp.asarray(cols["x"])))
    assert float((_np(pred) == cols["y"]).mean()) > 0.95


# ---------------------------------------------------------------------------
# Association rules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [2, 3])
def test_apriori_supports_and_rules_equal(max_len):
    rng = np.random.default_rng(0)
    items = (rng.random((2000, 8)) < 0.15).astype(np.float32)
    items[:, 1] = np.maximum(items[:, 0], items[:, 1])
    items[:, 3] = np.maximum(items[:, 1] * (rng.random(2000) < 0.8),
                             items[:, 3])
    t, j = _tables({"items": items})
    got = tar.apriori(t, min_support=0.05, min_confidence=0.6,
                      max_len=max_len, block_size=512)
    want = jar.apriori(j, min_support=0.05, min_confidence=0.6,
                       max_len=max_len, block_size=512)
    assert got.itemsets == want.itemsets
    assert got.supports == want.supports
    assert got.rules == want.rules
    assert any(r[0] == (0,) and r[1] == (1,) for r in got.rules)
    for s, supp in got.supports.items():
        count = np.all(items[:, list(s)] > 0, 1).sum()
        assert supp == float(np.float32(count) / 2000)


# ---------------------------------------------------------------------------
# SVD.
# ---------------------------------------------------------------------------

def _decaying(seed=9, n=512, d=16):
    draw = Draw(seed)
    u = np.linalg.qr(draw.normal((n, d)).astype(np.float64))[0]
    v = np.linalg.qr(draw.normal((d, d)).astype(np.float64))[0]
    s = np.array([100., 50., 25., 12.] + [1.0] * (d - 4))
    return ((u * s) @ v.T).astype(np.float32), s


def test_atAq_state_close():
    a, _ = _decaying()
    q = Draw(10).normal((16, 6))
    t, j = _tables({"a": a})
    got = run_local(tsvd.AtAQAggregate(_t(q)), t, block_size=100)
    want = jcore.run_local(jsvd.AtAQAggregate(jnp.asarray(q)), j,
                           block_size=100)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("method", ["power", "randomized"])
def test_svd_singular_values_close(method):
    import jax
    a, s_true = _decaying()
    t, j = _tables({"a": a})
    if method == "power":
        s, v = tsvd.svd_power(t, 4, n_iters=30, seed=3)
        js, jv = jsvd.svd_power(j, 4, n_iters=30, key=jax.random.PRNGKey(3))
    else:
        s, v = tsvd.svd_randomized(t, 4, seed=3)
        js, jv = jsvd.svd_randomized(j, 4, key=jax.random.PRNGKey(3))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-4)
    np.testing.assert_allclose(_np(s), s_true[:4], rtol=1e-4)
    # the same right singular subspace, whatever the signs
    overlap = np.abs(_np(v).T @ np.asarray(jv))
    np.testing.assert_allclose(overlap, np.eye(4), atol=1e-3)


def test_lowrank_sgd_names_the_item_that_brings_it():
    """ROADMAP item 9 brought ``lowrank_sgd`` (it raised naming the item
    until the convex layer was ported): it now fits from its seed."""
    t = Table.from_columns({"i": np.array([0., 1., 2., 3.], np.float32),
                            "j": np.array([1., 0., 3., 2.], np.float32),
                            "v": np.ones(4, np.float32)}, device="cpu")
    p = tsvd.lowrank_sgd(t, 4, 4, 2, epochs=2, batch=2, seed=1)
    assert p["L"].shape == (4, 2) and p["R"].shape == (4, 2)
    assert torch.equal(p["L"], tsvd.lowrank_sgd(t, 4, 4, 2, epochs=2,
                                                batch=2, seed=1)["L"])


# ---------------------------------------------------------------------------
# LDA.
# ---------------------------------------------------------------------------

def _corpus(seed=11, n_docs=150, V=40, K=3, length=80):
    rng = np.random.default_rng(seed)
    topics = rng.dirichlet(np.full(V, 0.05), K)
    docs = np.stack([rng.multinomial(length, rng.dirichlet(np.full(K, 0.3))
                                     @ topics) for _ in range(n_docs)])
    return docs.astype(np.int32)


def test_lda_estep_and_update_close():
    docs = _corpus()
    t, j = _tables({"counts": docs})
    log_beta = np.log(np.random.default_rng(1).dirichlet(
        np.ones(40), 3)).astype(np.float32)
    got = run_local(tlda.LDAEStepAggregate(_t(log_beta)), t, block_size=64)
    want = jcore.run_local(jlda.LDAEStepAggregate(jnp.asarray(log_beta)), j,
                           block_size=64)
    for k in ("counts", "bound", "n_tokens"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    state = {"log_beta": _t(log_beta), "perp": torch.tensor(np.inf)}
    up = tlda.LDATask(_t(log_beta), 0.1, 0.01).update(state, got)
    jup = jlda.LDATask(jnp.asarray(log_beta), 0.1, 0.01).update(
        {"log_beta": jnp.asarray(log_beta), "perp": jnp.inf}, want)
    for k in ("log_beta", "perp"):
        np.testing.assert_allclose(_np(up[k]), np.asarray(jup[k]),
                                   rtol=1e-5)


def test_lda_perplexity_decreases():
    t, _ = _tables({"counts": _corpus(12)})
    learned, trace = tlda.lda_fit(t, 3, 40, max_iters=10, seed=5)
    assert trace[-1] < 0.6 * trace[0]
    np.testing.assert_allclose(_np(learned.sum(-1)), 1.0, rtol=1e-4)


def test_dirichlet_start_is_seeded_and_normalized():
    a = tlda.dirichlet_topics(4, 50, seed=7, device="cpu")
    b = tlda.dirichlet_topics(4, 50, seed=7, device="cpu")
    assert torch.equal(a, b) and (a > 0).all()
    np.testing.assert_allclose(_np(a.sum(-1)), 1.0, rtol=1e-6)
    if not torch.cuda.is_available():          # the card is the default
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tlda.dirichlet_topics(4, 50)


# ---------------------------------------------------------------------------
# RLE sparse vectors and array operations.
# ---------------------------------------------------------------------------

def _runs(draw, n, levels):
    """A dense vector of runs of dyadic values."""
    vals = draw.dyadic((n,), denom=4, scale=2.0)
    lens = draw.ints((n,), 1, 5)
    return np.repeat(vals, lens)[:n].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rle_ops_equal(seed):
    draw = Draw(40 + seed)
    a, b = _runs(draw, 60, 4), _runs(draw, 60 - 7 * seed, 4)
    dense = draw.dyadic((60,), denom=4)
    cap = 64
    va, vb = tsv.rle_encode(_t(a), cap), tsv.rle_encode(_t(b), cap)
    ja, jb = jsv.rle_encode(jnp.asarray(a), cap), \
        jsv.rle_encode(jnp.asarray(b), cap)
    for f in ("values", "runs", "n_runs"):
        _eq(getattr(va, f), getattr(ja, f))
    _eq(tsv.rle_decode(va), jsv.rle_decode(ja))
    _eq(tsv.rle_decode(va), a)
    _eq(tsv.rle_scale(va, 0.5).values, jsv.rle_scale(ja, 0.5).values)
    _eq(tsv.rle_dot_dense(va, _t(dense)),
        jsv.rle_dot_dense(ja, jnp.asarray(dense)))
    _eq(tsv.rle_dot_rle(va, vb), jsv.rle_dot_rle(ja, jb))


ARRAY_CASES = [
    ("array_add", 2), ("array_sub", 2), ("array_mult", 2), ("array_div", 2),
    ("array_dot", 2), ("array_sqrt", 1), ("norm1", 1), ("norm2", 1),
]


@pytest.mark.parametrize("name,arity", ARRAY_CASES,
                         ids=[c[0] for c in ARRAY_CASES])
def test_array_ops_equal(name, arity):
    draw = Draw(50)
    a = np.abs(draw.dyadic((4, 6), denom=4)) + 0.25
    b = draw.dyadic((4, 6), denom=4) + 2.0
    args = (a, b)[:arity]
    _eq(getattr(tarr, name)(*map(_t, args)),
        getattr(jarr, name)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_array_reductions_equal(axis):
    a = Draw(51).dyadic((4, 8), denom=4)    # means by powers of two
    for name in ("array_sum", "array_mean", "array_max", "array_min"):
        _eq(getattr(tarr, name)(_t(a), axis),
            getattr(jarr, name)(jnp.asarray(a), axis))
    _eq(tarr.array_scalar_mult(_t(a), 3.0),
        jarr.array_scalar_mult(jnp.asarray(a), 3.0))
    _eq(tarr.array_pow(_t(a), 2), jarr.array_pow(jnp.asarray(a), 2))
    _eq(tarr.array_filter(_t(a), lambda z: z > 0),
        jarr.array_filter(jnp.asarray(a), lambda z: z > 0))


def test_closest_column_equal():
    m = Draw(52).dyadic((6, 3), denom=4)
    v = np.array([0.25, -0.5, 0.75], np.float32)
    gi, gd = tarr.closest_column(_t(m), _t(v))
    ji, jd = jarr.closest_column(jnp.asarray(m), jnp.asarray(v))
    assert int(gi) == int(ji)
    _eq(gd, jd)
