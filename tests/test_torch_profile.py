"""The port's profile, templated aggregates and Session against the JAX
package's.

The same numpy draws go through both packages.  ``ProfileAggregate``
states: count, min and max bit for bit on any data; sum and sumsq bit
for bit on dyadic draws (every partial sum exact in f32, so the two
libraries' summation orders agree) and allclose on Gaussian draws (rtol
1e-5 of the largest entry: the orders differ).  The Session batch of the
analytics mix (profile, linregr, Count-Min, FM) must plan as ONE scan
and give what the statements give alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregates as jagg
from repro.core.session import Session as JSession
from repro.core.table import Table as JTable
from repro.core.templates import ProfileAggregate as JProfileAggregate
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro.core.templates import map_columns as jmap_columns
from repro.core.templates import one_hot_encode as jone_hot_encode
from repro.methods import profile as jprof
from repro_torch.core import (
    ProfileAggregate, Session, map_columns, one_hot_encode, run_grouped,
    run_local, trace_execution,
)
from repro_torch.core.plan import ScanAgg, execute, fused_scan_pass
from repro_torch.core.table import Table
from repro_torch.methods import profile as prof
from repro_torch.methods.linregr import linregr
from repro_torch.methods.sketches import (
    CountMinAggregate, countmin_sketch, fm_distinct_count,
)
from strategies import Draw

STATS = ("count", "sum", "sumsq", "min", "max")


def _columns(seed: int, kind: str, n: int = 401, k: int = 3) -> dict:
    draw = Draw(seed)
    x = draw.dyadic((n, k)) if kind == "dyadic" else draw.normal((n, k))
    y = draw.dyadic((n,)) if kind == "dyadic" else draw.normal((n,))
    return {"x": x, "y": y, "g": draw.ints((n,), 0, 4),
            "item": draw.ints((n,), -60, 60),
            "flag": draw.bools((n,))}


def _tables(cols):
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


def _assert_stats(got: dict, want: dict, kind: str, keys=STATS) -> None:
    assert set(got) == set(want)
    for col in want:
        for key in keys:
            g = got[col][key].numpy()
            w = np.asarray(want[col][key])
            exact = kind == "dyadic" or key in ("count", "min", "max")
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=f"{col}.{key}")
            else:
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                           err_msg=f"{col}.{key}")


@pytest.mark.parametrize("block_size", [None, 64])
@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
def test_profile_state_matches_jax(kind, block_size):
    t, jt = _tables(_columns(5, kind))
    mask = Draw(6).bools((t.n_rows,), p=0.8)
    got = run_local(ProfileAggregate(), t, block_size=block_size,
                    mask=torch.from_numpy(mask), finalize=False)
    want = jagg.run_local(JProfileAggregate(), jt, block_size=block_size,
                          mask=jnp.asarray(mask), finalize=False)
    assert set(got) == {"x", "y", "g", "item"}  # bool is not numeric
    _assert_stats(got, want, kind)


def test_profile_merge_ops_are_built_on_meta_tensors():
    cols = {"x": torch.empty((0, 2), device="meta"),
            "flag": torch.empty((0,), dtype=torch.bool, device="meta")}
    agg = ProfileAggregate()
    state = agg.init(cols)
    assert state["x"]["min"].device.type == "meta"
    assert agg.segment_ops(state) == {"x": {
        "count": "sum", "sum": "sum", "sumsq": "sum", "min": "min",
        "max": "max"}}


@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
def test_profile_grouped_matches_jax(kind):
    t, jt = _tables(_columns(7, kind))
    got = run_grouped(ProfileAggregate(), t, "g", 5, block_size=16,
                      finalize=False)
    want = jagg.run_grouped(JProfileAggregate(), jt, "g", 5, block_size=16,
                            finalize=False)
    _assert_stats(got, want, kind)


def test_distinct_count_columns_match_jax():
    t, jt = _tables(_columns(8, "dyadic"))
    assert prof.distinct_count_columns(t) == jprof.distinct_count_columns(jt)
    assert prof.distinct_count_columns(t) == ("g", "item")


@pytest.mark.parametrize("distinct_counts", [False, True])
def test_profile_matches_jax(distinct_counts):
    t, jt = _tables(_columns(9, "dyadic"))
    with trace_execution() as tr:
        got = prof.profile(t, distinct_counts=distinct_counts)
    want = jprof.profile(jt, distinct_counts=distinct_counts)
    assert len(tr.scans) == 1
    _assert_stats(got, want, "dyadic")
    for col in want:  # XLA fuses the division and sqrt: 1 ulp apart
        for key in ("mean", "std"):
            np.testing.assert_allclose(got[col][key].numpy(),
                                       np.asarray(want[col][key]), rtol=1e-6)
    for col in ("g", "item"):
        assert ("approx_distinct" in got[col]) == distinct_counts
        if distinct_counts:
            np.testing.assert_allclose(
                got[col]["approx_distinct"].numpy(),
                np.asarray(want[col]["approx_distinct"]), rtol=1e-6)


def test_map_columns_and_one_hot_encode_match_jax():
    cols = {"a": np.array([0, 2, 1, 5, -1], np.int32),
            "b": np.arange(5, dtype=np.float32)}
    t, jt = _tables(cols)
    got = one_hot_encode(t, "a", 3)
    want = jone_hot_encode(jt, "a", 3)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    def fn(name, c):
        return None if name == "a" else c * 2
    assert map_columns(t, fn).column_names == ("b",)
    np.testing.assert_array_equal(map_columns(t, fn)["b"].numpy(),
                                  np.asarray(jmap_columns(jt, fn)["b"]))


# ---------------------------------------------------------------------------
# Session: the analytics mix in one batch.
# ---------------------------------------------------------------------------

def _mix(sess, t, cm_agg):
    return (sess.profile(t, distinct_counts=True),
            sess.linregr(t, use_kernel=True),
            sess.scan(cm_agg, t, columns=("item",), label="countmin"),
            sess.fm_distinct_count(t))


def test_session_batch_is_one_scan_and_equals_the_solo_statements():
    t, jt = _tables(_columns(10, "dyadic"))
    sess = Session()
    handles = _mix(sess, t, CountMinAggregate(use_kernel=True))
    assert [h.label for h in handles[1:]] == ["linregr", "countmin",
                                              "fm_distinct"]
    with trace_execution() as tr:
        sess.run()
    assert len(tr.scans) == 1
    # one column_stats a numeric column (x, y, g, item) of the profile
    assert sorted((e.detail["name"], e.engine) for e in tr.kernels) == [
        *[("column_stats", "ref")] * 4, ("countmin", "ref"), ("xtx", "ref")]
    stats, ols, cm, fm = (h.result() for h in handles)

    assert torch.equal(cm, execute(ScanAgg(
        CountMinAggregate(use_kernel="ref"), t, label="countmin")))
    assert torch.equal(fm, fm_distinct_count(t))
    assert torch.equal(ols.coef, linregr(t, use_kernel=True).coef)
    solo = prof.profile(t, distinct_counts=True)
    for col in solo:
        for key, v in solo[col].items():
            assert torch.equal(stats[col][key], v), (col, key)

    jsess = JSession()
    jh = (jsess.profile(jt, distinct_counts=True), jsess.linregr(jt),
          jsess.countmin_sketch(jt), jsess.fm_distinct_count(jt))
    jsess.run()
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jh[2].result()))
    np.testing.assert_allclose(fm.numpy(), np.asarray(jh[3].result()),
                               rtol=1e-6)
    _assert_stats({c: stats[c] for c in ("x", "y", "g", "item")},
                  jh[0].result(), "dyadic")


def test_session_grouped_statements_share_one_sort():
    t, jt = _tables(_columns(11, "dyadic"))
    sess = Session()
    a = sess.grouped_scan(CountMinAggregate(use_kernel=True), t, "g", 5,
                          columns=("item",))
    b = sess.grouped_scan(CountMinAggregate(width=64), t, "g", 5,
                          columns=("item",))
    with trace_execution() as tr:
        sess.run()
    assert len(tr.sorts) == 1 and len(tr.scans) == 1
    # in the fused grouped pass the member with a kernel runs its segment
    # kernel over the shared layout; the other folds block by block
    assert [e.detail["name"] for e in tr.kernels] == ["segment_countmin"]
    assert a.result().shape == (5, 4, 1024) and b.result().shape == (5, 4, 64)
    # the same sketches as the reference's fused pass, which folds both
    # members block by block
    jsess = JSession()
    ja = jsess.grouped_scan(JCountMinAggregate(use_kernel=True), jt, "g", 5,
                            columns=("item",))
    jb = jsess.grouped_scan(JCountMinAggregate(width=64), jt, "g", 5,
                            columns=("item",))
    jsess.run()
    np.testing.assert_array_equal(a.result().numpy(), np.asarray(ja.result()))
    np.testing.assert_array_equal(b.result().numpy(), np.asarray(jb.result()))


@pytest.mark.parametrize("conflict", ["mask", "block_size"])
def test_mixed_masks_and_block_sizes_never_fuse(conflict):
    """The planner keeps such statements in passes of their own; a fused
    pass handed them anyway refuses loudly."""
    t, _ = _tables(_columns(12, "dyadic"))
    mask = torch.from_numpy(Draw(12).bools((t.n_rows,), p=0.5))
    sess = Session()
    first = sess.countmin_sketch(t)
    if conflict == "mask":
        second = sess.scan(CountMinAggregate(), t, columns=("item",),
                           mask=mask)
        want = run_local(CountMinAggregate(), t, mask=mask)
        match = "mixed-mask"
    else:
        second = sess.fm_distinct_count(t, block_size=64)
        want = fm_distinct_count(t, block_size=64)
        match = "block_size"
    with trace_execution() as tr:
        sess.run()
    assert len(tr.scans) == 2
    assert torch.equal(first.result(), countmin_sketch(t))
    assert torch.equal(second.result(), want)
    nodes = [ScanAgg(CountMinAggregate(), t, columns=("item",)),
             ScanAgg(CountMinAggregate(), t, columns=("item",),
                     **({"mask": mask} if conflict == "mask"
                        else {"block_size": 64}))]
    with pytest.raises(ValueError, match=match):
        fused_scan_pass(list(enumerate(nodes)))


def test_a_failed_batch_is_discarded_not_replanned():
    t, _ = _tables(_columns(13, "dyadic"))
    sess = Session()
    bad = sess.scan(CountMinAggregate(item_col="missing"), t)
    with pytest.raises(KeyError):
        sess.run()
    with pytest.raises(RuntimeError, match="discarded"):
        bad.result()
    good = sess.countmin_sketch(t)
    with trace_execution() as tr:
        assert len(sess.run()) == 1
    assert len(tr.scans) == 1
    assert torch.equal(good.result(), countmin_sketch(t))
    assert Session().run() == []


def test_handle_before_run_says_so():
    t, _ = _tables(_columns(14, "dyadic"))
    h = Session().countmin_sketch(t)
    with pytest.raises(RuntimeError, match="not executed yet"):
        h.result()


def _tiny():
    return Table.from_columns({"x": np.zeros((2, 1), np.float32)},
                              device="cpu")


# fit, logregr, naive Bayes, the server, explain, joins, living views,
# streams and the sharded engine are ported: a fit given a mesh that is
# not a Mesh raises
@pytest.mark.parametrize("call", [
    lambda s: (s.fit(None, _tiny(), mesh=object()), s.run()),
])
def test_unported_session_methods_raise(call):
    with pytest.raises(TypeError, match="Mesh"):
        call(Session())
