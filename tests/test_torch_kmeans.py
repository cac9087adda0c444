"""The port's k-means against the JAX package's.

The same numpy draws (well-separated blobs, as the reference's own
grouped test uses, so no near-tie row decides a round) and the same
seeding go through both packages.  Held equal: ``n_iters`` and
``converged``.  Held bitwise on dyadic data: the fused transition's fold
state (sums, counts, SSE, moved) with and without the kernel's plain
version.  Held allclose: centroids and SSE traces (rtol 1e-5, atol
1e-5; the libraries' matmuls round in different orders).

k-means++ cannot match the reference's picks (``jax.random`` bits), so
its properties are tested instead: every seed is a row, no repeats,
k - 1 fused scans, and the same seeds whatever the block size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregates import run_local as jrun_local
from repro.core.table import Table as JTable
from repro.methods import kmeans as jkm
from repro_torch.core import fit, run_local, trace_execution
from repro_torch.core.table import Table
from repro_torch.methods import kmeans as km
from strategies import Draw

CENTERS = np.array([[0., 0., 0., 0.], [8., 0., 0., 0.], [0., 8., 0., 0.],
                    [0., 0., 8., 0.], [0., 0., 0., 8.]], np.float32)
K = 5


def _blobs(seed: int, n: int = 1000, dyadic: bool = False):
    draw = Draw(seed)
    lab = draw.ints((n,), 0, K - 1)
    noise = draw.dyadic((n, 4), scale=0.6) if dyadic \
        else 0.6 * draw.normal((n, 4))
    x = (CENTERS[lab] + noise).astype(np.float32)
    # pulled towards the middle, so the first rounds reassign rows
    init = (0.375 * CENTERS + 2.0 + draw.dyadic((K, 4))).astype(np.float32)
    return draw, x, init


def _tables(cols):
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_result_close(got, want):
    assert got.n_iters == want.n_iters
    assert got.converged == want.converged
    np.testing.assert_allclose(_np(got.centroids), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.sse_trace, want.sse_trace, rtol=1e-5)
    np.testing.assert_allclose(got.sse, want.sse, rtol=1e-5)


@pytest.mark.parametrize("variant,use_kernel", [
    ("fused", False), ("fused", True), ("fused", "ref"),
    ("two_pass", False)])
@pytest.mark.parametrize("block_size", [None, 128])
def test_kmeans_fit_matches_jax(variant, use_kernel, block_size):
    _, x, init = _blobs(2)
    t, jt = _tables({"x": x})
    kw = {"init_centroids": init, "max_iters": 30, "variant": variant,
          "block_size": block_size}
    got = km.kmeans_fit(t, K, use_kernel=use_kernel, **kw)
    want = jkm.kmeans_fit(jt, K, **kw)
    _assert_result_close(got, want)
    assert got.converged and got.n_iters >= 2


@pytest.mark.parametrize("mode", ["host", "compiled"])
def test_kmeans_fit_modes_and_tolerance_match_jax(mode):
    _, x, init = _blobs(3)
    t, jt = _tables({"x": x})
    for tol in (0.0, 0.01):
        kw = {"init_centroids": init, "max_iters": 30, "mode": mode,
              "reassign_frac_tol": tol}
        _assert_result_close(km.kmeans_fit(t, K, **kw),
                             jkm.kmeans_fit(jt, K, **kw))


@pytest.mark.parametrize("use_kernel", [False, "ref"])
def test_fused_transition_state_is_bitwise_on_dyadic_data(use_kernel):
    draw, x, init = _blobs(3, dyadic=True)
    prev = init[::-1].copy()  # every centroid elsewhere: rows move
    mask = draw.bools((x.shape[0],), p=0.9)
    t, jt = _tables({"x": x})
    for block_size in (None, 96):
        got = run_local(km.KMeansAggregate(torch.from_numpy(init),
                                           torch.from_numpy(prev),
                                           use_kernel), t,
                        block_size=block_size, mask=torch.from_numpy(mask),
                        finalize=False)
        want = jrun_local(jkm.KMeansAggregate(jnp.asarray(init),
                                              jnp.asarray(prev)), jt,
                          block_size=block_size, mask=jnp.asarray(mask),
                          finalize=False)
        assert float(want["moved"]) > 0
        for name in want:
            np.testing.assert_array_equal(_np(got[name]),
                                          np.asarray(want[name]),
                                          err_msg=name)


def test_kmeans_grouped_matches_jax_and_solo():
    draw, x, init = _blobs(4, 1800)
    g = (np.arange(1800) % 3).astype(np.int32)
    t, jt = _tables({"x": x, "g": g})
    for use_kernel in (False, True):
        got = km.kmeans_grouped(t, "g", K, init_centroids=init, max_iters=30,
                                use_kernel=use_kernel)
        want = jkm.kmeans_grouped(jt, "g", K, init_centroids=init,
                                  max_iters=30)
        np.testing.assert_array_equal(got.n_iters, want.n_iters)
        np.testing.assert_array_equal(got.converged, want.converged)
        np.testing.assert_allclose(_np(got.centroids),
                                   np.asarray(want.centroids), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got.sse), np.asarray(want.sse),
                                   rtol=1e-5)
        assert got.centroids.shape == (3, K, 4) and got.converged.all()
    # a stacked (G, k, d) seeding, and grouped == solo per group
    stacked = np.stack([init, init[::-1].copy(), init + 0.25])
    grouped = km.kmeans_grouped(t, "g", K, init_centroids=stacked,
                                max_iters=30)
    for i in range(3):
        sel = g == i
        solo = km.kmeans_fit(Table.from_columns({"x": x[sel]}, device="cpu"),
                             K, init_centroids=stacked[i], max_iters=30)
        np.testing.assert_allclose(_np(grouped.centroids[i]),
                                   _np(solo.centroids), rtol=1e-4, atol=1e-4)
        assert int(grouped.n_iters[i]) == solo.n_iters
        assert bool(grouped.converged[i]) == solo.converged


def test_two_pass_kmeans_runs_two_passes_per_iteration():
    counts = {"bary": 0, "reassign": 0}

    class CountBary(km.KMeansStoredAssignAggregate):
        def transition(self, state, block, mask):
            counts["bary"] += 1
            return super().transition(state, block, mask)

    class CountReassign(km.KMeansReassignAggregate):
        def transition(self, state, block, mask):
            counts["reassign"] += 1
            return super().transition(state, block, mask)

    class Task(km.KMeansTwoPassTask):
        def iteration(self, state, run_pass):
            out = run_pass(CountBary(state["cents"], state["assign"]))
            upd = run_pass(CountReassign(out["centroids"], state["assign"]))
            new = {"cents": out["centroids"], "assign": upd["assign"],
                   "it": state["it"] + 1}
            n = torch.clamp(torch.sum(out["counts"]), min=1.0)
            m = upd["moved"] / n if int(new["it"]) > 1 else float("inf")
            return new, {"sse": out["sse"], "counts": out["counts"]}, m

    draw = Draw(5)
    pts = draw.normal((512, 2))
    seed = draw.normal((4, 2))
    t = Table.from_columns({"x": pts, "__row__": np.arange(
        512, dtype=np.int32)}, device="cpu")
    res = fit(Task(seed), t, max_iters=5, tol=0.5 / 512, mode="host")
    assert counts["bary"] == res.n_iters
    assert counts["reassign"] == res.n_iters


# ---------------------------------------------------------------------------
# k-means++: properties (the RNG differs from the reference's).
# ---------------------------------------------------------------------------

def test_kmeans_pp_seed_properties():
    draw, x, _ = _blobs(6, 700)
    t, _ = _tables({"x": x})
    k = 6
    with trace_execution() as tr:
        seeds = km.kmeans_pp_seed(t, k, seed=11)
    assert len(tr.scans) == k - 1  # one fused scan per pick
    assert seeds.shape == (k, 4)
    rows = {tuple(r) for r in x.tolist()}
    picked = [tuple(r) for r in seeds.tolist()]
    assert all(p in rows for p in picked)            # every seed is a row
    assert len(set(picked)) == k                     # no repeats
    blocked = km.kmeans_pp_seed(t, k, seed=11, block_size=64)
    assert torch.equal(seeds, blocked)               # block size free
    assert not torch.equal(seeds, km.kmeans_pp_seed(t, k, seed=12))
    gen = torch.Generator().manual_seed(3)
    again = torch.Generator().manual_seed(3)
    assert torch.equal(km.kmeans_pp_seed(t, k, seed=gen),
                       km.kmeans_pp_seed(t, k, seed=again))


def test_kmeans_pp_seed_without_enough_distinct_points():
    """Three distinct points and k = 5: after they are picked the
    potential is zero and the rest fall back to row 0, as in JAX."""
    x = np.repeat(np.eye(3, 2, dtype=np.float32) * 4, 50, axis=0)
    t, _ = _tables({"x": x})
    seeds = km.kmeans_pp_seed(t, 5, seed=1)
    assert {tuple(r) for r in seeds[:3].tolist()} == {
        tuple(r) for r in np.unique(x, axis=0).tolist()}
    assert torch.equal(seeds[3], t["x"][0]) and torch.equal(seeds[4],
                                                            t["x"][0])


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_fit_seeded_inits_converge(init):
    _, x, _ = _blobs(7, 1500)
    t, _ = _tables({"x": x})
    res = km.kmeans_fit(t, K, seed=5, init=init, max_iters=50)
    assert res.converged and res.centroids.shape == (K, 4)
    again = km.kmeans_fit(t, K, seed=5, init=init, max_iters=50)
    assert torch.equal(res.centroids, again.centroids)
    if init == "kmeans++":  # one seed per blob: the true centers come out
        got = np.sort(_np(res.centroids), axis=0)
        np.testing.assert_allclose(got, np.sort(CENTERS, axis=0), atol=0.1)
    with pytest.raises(ValueError, match="unknown init"):
        km.kmeans_fit(t, K, init="farthest")
