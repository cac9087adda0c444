"""The port's stream engine against the JAX package's.

The same numpy blocks go through ``repro.core.aggregates.run_stream``
and ``repro_torch.core.aggregates.run_stream`` (on the CPU), and through
the statements built on them: ``StreamAgg`` and ``Session.stream_scan``,
``fit_stream`` and ``IterativeFit(blocks=...)``, ``profile_stream`` and
``logregr_stream``.  Fold states are held bit for bit on dyadic draws
(every partial sum exact in f32, so the two libraries' summation orders
agree) and on the integer sketches, and allclose on Gaussian draws:
rtol 1e-5 with an absolute floor of 1e-5 times the leaf's largest
magnitude, since the two libraries sum in different orders.  Fits are
held to equal ``n_iters`` and ``converged``, their parameters allclose
(rtol 1e-4, atol 1e-5, the reference's own stream-against-local limit).
"""

import itertools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import aggregates as jagg
from repro.core import iterative as jit_
from repro.core.templates import ProfileAggregate as JProfileAggregate
from repro.methods import kmeans as jkm
from repro.methods import logregr as jlr
from repro.methods import profile as jprof
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.logregr import IRLSTask as JIRLSTask
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro.methods.sketches import FMAggregate as JFMAggregate
from repro_torch import interop
from repro_torch.core import (
    AnalyticsServer, FusedAggregate, IterativeFit, ProfileAggregate, Session,
    StreamAgg, execute, fit_stream, materialize, run_stream, trace_execution,
)
from repro_torch.core.aggregates import Aggregate
from repro_torch.core.plan import semantic_fingerprint
from repro_torch.core.table import Table
from repro_torch.methods import kmeans as km
from repro_torch.methods import logregr as lr
from repro_torch.methods import profile as prof
from repro_torch.methods.linregr import LinregrAggregate
from repro_torch.methods.logregr import IRLSTask
from repro_torch.methods.sketches import CountMinAggregate, FMAggregate
from strategies import GROUP_PATTERNS, Draw, group_layout

N = 4096
# (block size, the stream's block sizes): one block, equal blocks, and
# equal blocks with a ragged tail
LAYOUTS = {"one block": N, "512 x 8": 512, "600 + tail 496": 600}


class _Raw(Aggregate):
    """An aggregate whose ``final`` returns the fold state."""

    merge_ops = None

    def __init__(self, agg):
        self.agg = agg

    def init(self, block):
        return self.agg.init(block)

    def transition(self, state, block, mask):
        return self.agg.transition(state, block, mask)


class _JRaw(jagg.Aggregate):
    merge_ops = None

    def __init__(self, agg):
        self.agg = agg

    def init(self, block):
        return self.agg.init(block)

    def transition(self, state, block, mask):
        return self.agg.transition(state, block, mask)


AGGS = {
    "linregr": lambda P: (LinregrAggregate() if P == "t"
                          else JLinregrAggregate()),
    "countmin": lambda P: (CountMinAggregate if P == "t"
                           else JCountMinAggregate)(4, 128, item_col="item"),
    "fm": lambda P: (FMAggregate if P == "t"
                     else JFMAggregate)(8, 32, item_col="item"),
    "profile": lambda P: (ProfileAggregate() if P == "t"
                          else JProfileAggregate()),
    "fused profile + fm": lambda P: (
        FusedAggregate if P == "t" else jagg.FusedAggregate)(
        [AGGS["profile"](P), AGGS["fm"](P)]),
}


def _columns(draw: Draw, n: int, kind: str) -> dict:
    def real(shape):
        return draw.dyadic(shape) if kind == "dyadic" else draw.normal(shape)
    # items small enough that profile's f32 sum of squares stays exact
    return {"x": real((n, 3)), "y": real((n,)),
            "item": draw.ints((n,), -40, 40)}


def _blocks(cols: dict, bs: int) -> list[dict]:
    n = next(iter(cols.values())).shape[0]
    return [{k: v[i:i + bs] for k, v in cols.items()}
            for i in range(0, n, bs)]


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return [_np_tree(v) for v in t]
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _assert_tree(got, want, exact: bool, msg: str = "") -> None:
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _assert_tree(got[k], want[k], exact, f"{msg}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), msg
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree(a, b, exact, f"{msg}[{i}]")
    else:
        assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
        if exact or not np.issubdtype(want.dtype, np.floating):
            np.testing.assert_array_equal(got, want, err_msg=msg)
        else:
            scale = max(1.0, float(np.abs(want).max())) if want.size else 1
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=msg)


# ---------------------------------------------------------------------------
# run_stream: fold states against the reference's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(AGGS))
def test_run_stream_matches_jax(name, layout, kind):
    draw = Draw(zlib.crc32(f"{name}/{layout}/{kind}".encode()))
    blocks = _blocks(_columns(draw, N, kind), LAYOUTS[layout])
    with trace_execution() as tr:
        got = run_stream(_Raw(AGGS[name]("t")), iter(blocks), device="cpu")
    want = jagg.run_stream(_JRaw(AGGS[name]("j")), iter(blocks))
    # profile folds each numeric column (x, y, item) of a block through
    # the column_stats kernel's plain version
    stats = 3 * len(blocks) if "profile" in name else 0
    assert [(e.kind, e.engine) for e in tr.events] == [
        ("scan", "stream"), *[("kernel", "ref")] * stats]
    _assert_tree(got, want, exact=kind == "dyadic", msg=f"{name} {draw}")


@pytest.mark.parametrize("name", ["linregr", "countmin", "fm", "profile"])
@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
def test_per_group_streams_match_jax(pattern, name):
    """The stream column of the reference's engine-parity matrix: each
    group's own rows in host-side blocks of 32, bitwise on dyadic data."""
    n, G, bs = 300, 6, 32
    draw = Draw(sum(map(ord, pattern + name)))
    gids, _ = group_layout(draw, n, G, pattern)
    cols = _columns(draw, n, "dyadic")
    jagg_ = _JRaw(AGGS[name]("j"))   # one instance: the reference's memo
    for g in range(G):
        rows = np.where(gids == g)[0]
        if not len(rows):
            continue  # run_stream rejects empty streams by contract
        sub = {k: v[rows] for k, v in cols.items()}
        got = run_stream(_Raw(AGGS[name]("t")), iter(_blocks(sub, bs)),
                         device="cpu")
        want = jagg.run_stream(jagg_, iter(_blocks(sub, bs)))
        _assert_tree(got, want, exact=True, msg=f"{pattern} g={g}")


def test_producer_reusing_one_buffer_gives_the_same_state():
    """A producer that writes every block into the same numpy buffer, or
    the same tensor, folds as fresh blocks do."""
    cols = _columns(Draw(21), N, "dyadic")
    want = run_stream(_Raw(FusedAggregate([LinregrAggregate(),
                                           CountMinAggregate(4, 128)])),
                      iter(_blocks(cols, 600)), device="cpu")

    def reusing(as_torch):
        buf = {k: np.empty((600,) + v.shape[1:], v.dtype)
               for k, v in cols.items()}
        if as_torch:
            buf = {k: torch.from_numpy(v) for k, v in buf.items()}
        for blk in _blocks(cols, 600):
            n = blk["y"].shape[0]
            for k, v in blk.items():
                buf[k][:n] = torch.from_numpy(v) if as_torch else v
            yield {k: v[:n] for k, v in buf.items()}

    for as_torch in (False, True):
        got = run_stream(_Raw(FusedAggregate([LinregrAggregate(),
                                              CountMinAggregate(4, 128)])),
                         reusing(as_torch), device="cpu")
        _assert_tree(got, want, exact=True, msg=f"torch={as_torch}")


def test_empty_stream_and_empty_factory_raise_like_jax():
    for call in (lambda: run_stream(ProfileAggregate(), iter([]),
                                    device="cpu"),
                 lambda: jagg.run_stream(JProfileAggregate(), iter([]))):
        with pytest.raises(ValueError, match="empty block stream"):
            call()
    _, x, init = _blobs(3, 64)
    for call in (lambda: fit_stream(km.KMeansTask(init), lambda: iter([]),
                                    max_iters=3, device="cpu"),
                 lambda: jit_.fit_stream(jkm.KMeansTask(jnp.asarray(init)),
                                         lambda: iter([]), max_iters=3)):
        with pytest.raises(ValueError, match="no blocks"):
            call()
    with pytest.raises(ValueError, match="empty block stream"):
        prof.profile_stream(iter([]), device="cpu")


def test_two_stream_scans_over_one_iterator_fold_once():
    blocks = iter([{"item": np.arange(100) % 30},
                   {"item": np.arange(100) % 60}])
    jblocks = iter([{"item": np.arange(100) % 30},
                    {"item": np.arange(100) % 60}])
    sess, jsess = Session(), jcore.Session()
    h_cm = sess.stream_scan(CountMinAggregate(), blocks, device="cpu")
    h_fm = sess.stream_scan(FMAggregate(), blocks, device="cpu")
    j_cm = jsess.stream_scan(JCountMinAggregate(), jblocks)
    j_fm = jsess.stream_scan(JFMAggregate(), jblocks)
    with trace_execution() as tr:
        sess.run()
    jsess.run()
    # mandatory fusion: the shared iterator is consumed exactly once
    assert len(tr.scans) == 1
    np.testing.assert_array_equal(h_cm.result().numpy(),
                                  np.asarray(j_cm.result()))
    assert float(h_fm.result()) == float(j_fm.result())
    assert h_cm.result().dtype == torch.int32


def test_stream_scan_projection_and_factory_source():
    """``columns=`` renames a member's inputs; a factory is called once
    per pass."""
    cols = _columns(Draw(5), 700, "dyadic")
    calls = []

    def factory():
        calls.append(1)
        return iter(_blocks({"a": cols["x"], "b": cols["y"]}, 256))

    sess = Session()
    h = sess.stream_scan(_Raw(LinregrAggregate()), factory,
                         columns={"x": "a", "y": "b"}, device="cpu")
    sess.run()
    want = jagg.run_stream(_JRaw(JLinregrAggregate()),
                           iter(_blocks(cols, 256)))
    assert calls == [1]
    _assert_tree(h.result(), want, exact=True)


# ---------------------------------------------------------------------------
# The planner: explain, materialize, the server.
# ---------------------------------------------------------------------------

def _explain_batch(P, table, blocks, factory):
    Sess = jcore.Session if P == "j" else Session
    cm = (JCountMinAggregate if P == "j" else CountMinAggregate)(4, 64)
    fm = (JFMAggregate if P == "j" else FMAggregate)(4, 16)
    sess = Sess()
    sess.stream_scan(cm, blocks, label="cm")
    sess.scan(fm, table)
    sess.stream_scan(fm, blocks)
    sess.stream_scan(JProfileAggregate() if P == "j" else ProfileAggregate(),
                     factory, label="prof")
    sess.fit(JIRLSTask() if P == "j" else IRLSTask(), blocks=factory,
             max_iters=5, tol=1e-4, label="irls_s")
    sess.fit(JIRLSTask() if P == "j" else IRLSTask(), blocks=factory,
             max_iters=7, tol=None)
    return sess.explain()


def test_explain_of_stream_passes_equals_the_reference():
    cols = _columns(Draw(8), 256, "dyadic")
    blocks = iter(_blocks(cols, 100))

    def factory():
        return iter(_blocks(cols, 100))

    got = _explain_batch("t", Table.from_columns(cols, device="cpu"),
                         blocks, factory)
    want = _explain_batch("j", jcore.Table.from_columns(cols), blocks,
                          factory)
    assert got == want
    assert got == (
        "plan: 6 statements -> 5 passes\n"
        "  pass 0: stream-scan [stream]\n"
        "    cm: CountMinAggregate\n"
        "    s2: FMAggregate\n"
        "  pass 1: shared-scan [local] t0 rows=256 cost=256 [heuristic]\n"
        "    s1: FMAggregate\n"
        "  pass 2: stream-scan [stream]\n"
        "    prof: ProfileAggregate\n"
        "  pass 3: fit [stream] max_iters=5 tol=0.0001\n"
        "    irls_s: IRLSTask\n"
        "  pass 4: fit [stream] max_iters=7 tol=none\n"
        "    s5: IRLSTask")


def test_materialize_refuses_a_stream_statement_like_jax():
    text = "fit and stream statements hold no mergeable state"
    blocks = [{"item": np.arange(10)}]
    with pytest.raises(TypeError, match=text):
        materialize([StreamAgg(CountMinAggregate(), blocks, device="cpu")])
    with pytest.raises(TypeError, match=text):
        jcore.materialize([jcore.StreamAgg(JCountMinAggregate(), blocks)])


def test_stream_statement_through_the_server_is_never_cached():
    cols = {"item": Draw(9).ints((900,), 0, 50)}
    want = np.asarray(jagg.run_local(JCountMinAggregate(4, 64),
                                     jcore.Table.from_columns(cols)))
    srv = AnalyticsServer(window_size=1024)
    try:
        for _ in range(2):
            sess = Session(server=srv)
            node = StreamAgg(CountMinAggregate(4, 64),
                             iter(_blocks(cols, 256)), device="cpu")
            assert semantic_fingerprint(node) is None
            with trace_execution() as tr:
                h = sess.statement(node)
                got = h.result()
            assert len(tr.scans) == 1 and not tr.cache_hits
            np.testing.assert_array_equal(got.numpy(), want)
        assert srv.stats["cache_hits"] == 0
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# profile_stream, logregr_stream, fit_stream.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distinct_counts", [False, True])
@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
def test_profile_stream_matches_jax(kind, distinct_counts):
    cols = _columns(Draw(11), 5000, kind)
    cols["g"] = Draw(12).ints((5000,), 0, 40)
    got = prof.profile_stream(iter(_blocks(cols, 700)),
                              distinct_counts=distinct_counts, device="cpu")
    want = jprof.profile_stream(iter(_blocks(cols, 700)),
                                distinct_counts=distinct_counts)
    # the fold's fields bitwise on dyadic data; mean and std are computed
    # from them by each library's own division and square root
    derived = ("mean", "std")
    _assert_tree({c: {k: v for k, v in f.items() if k not in derived}
                  for c, f in got.items()},
                 {c: {k: v for k, v in f.items() if k not in derived}
                  for c, f in want.items()}, exact=kind == "dyadic")
    _assert_tree(got, want, exact=False)
    assert ("approx_distinct" in got["item"]) == distinct_counts
    # every field as the resident profile of the whole table gives it
    local = prof.profile(Table.from_columns(cols, device="cpu"),
                         distinct_counts=distinct_counts)
    _assert_tree(got, local, exact=kind == "dyadic")


def _classification(seed: int, n: int = 3000, d: int = 4):
    draw = Draw(seed)
    x = draw.normal((n, d))
    b = draw.normal((d,))
    p = 1.0 / (1.0 + np.exp(-(x @ b)))
    y = (draw.uniform((n,)) < p).astype(np.float32)
    return {"x": x, "y": y}


def test_logregr_stream_matches_jax():
    cols = _classification(14)

    def factory():
        return iter(_blocks(cols, 600))

    with trace_execution() as tr:
        got = lr.logregr_stream(factory, device="cpu")
    want = jlr.logregr_stream(factory)
    assert got.n_iters == want.n_iters and got.converged == want.converged
    assert got.converged
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-4, atol=1e-5)
    # one fit event, then one stream scan per round
    assert [e.engine for e in tr.fits] == ["stream"]
    assert len(tr.scans) == got.n_iters
    assert {e.engine for e in tr.scans} == {"stream"}
    # and the resident fit at the same blocks
    local = lr.logregr(Table.from_columns(cols, device="cpu"),
                       block_size=600)
    assert local.n_iters == got.n_iters
    np.testing.assert_allclose(got.coef.numpy(), local.coef.numpy(),
                               rtol=1e-5, atol=1e-6)


CENTERS = np.array([[0., 0., 0.], [6., 0., 0.], [0., 6., 0.], [0., 0., 6.]],
                   np.float32)


def _blobs(seed: int, n: int):
    draw = Draw(seed)
    x = (CENTERS[draw.ints((n,), 0, 3)] + 0.5 * draw.normal((n, 3))
         ).astype(np.float32)
    init = (CENTERS + np.array([1.0, -0.5, 0.75], np.float32)).astype(
        np.float32)
    return draw, x, init


@pytest.mark.parametrize("route", ["fit_stream", "execute", "session",
                                   "warm start from jax"])
def test_kmeans_fit_stream_matches_jax(route):
    _, x, init = _blobs(16, 2000)
    tol = 1e-3 + 0.5 / len(x)

    def factory():
        return iter(_blocks({"x": x}, 300))

    jtask = jkm.KMeansTask(jnp.asarray(init))
    task = km.KMeansTask(init)
    warm = jwarm = None
    if route == "warm start from jax":
        head = jit_.fit_stream(jtask, factory, max_iters=2, tol=None)
        state = {k: np.asarray(v) for k, v in head.state.items()}
        warm = interop.state_from_numpy(state, device="cpu")
        jwarm = {k: jnp.asarray(v) for k, v in state.items()}
    want = jit_.fit_stream(jtask, factory, max_iters=30, tol=tol,
                           warm_start=jwarm)
    with trace_execution() as tr:
        if route == "execute":
            got = execute(IterativeFit(task, blocks=factory, max_iters=30,
                                       tol=tol, device="cpu"))
        elif route == "session":
            sess = Session()
            h = sess.fit(task, blocks=factory, max_iters=30, tol=tol,
                         device="cpu")
            sess.run()
            got = h.result()
        else:
            got = fit_stream(task, factory, max_iters=30, tol=tol,
                             warm_start=warm, device="cpu")
    assert got.n_iters == want.n_iters and got.converged == want.converged
    assert got.converged
    assert [e.engine for e in tr.fits] == ["stream"]
    np.testing.assert_allclose(got.state["cents"].numpy(),
                               np.asarray(want.state["cents"]),
                               rtol=1e-5, atol=1e-5)
    assert got.state["cents"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The device policy.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["run_stream", "fit_stream",
                                   "profile_stream", "logregr_stream",
                                   "stream_scan"])
def test_stream_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = _classification(17, n=64)

    def factory():
        return iter(_blocks(cols, 32))

    calls = {
        "run_stream": lambda: run_stream(LinregrAggregate(), factory()),
        "fit_stream": lambda: fit_stream(IRLSTask(), factory),
        "profile_stream": lambda: prof.profile_stream(factory()),
        "logregr_stream": lambda: lr.logregr_stream(factory),
    }
    if entry == "stream_scan":
        sess = Session()
        sess.stream_scan(LinregrAggregate(), factory())
        calls[entry] = sess.run
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()


def test_blocks_match_the_reference():
    cols = _columns(Draw(19), 1000, "dyadic")
    t, jt = Table.from_columns(cols, device="cpu"), jcore.Table.from_columns(
        cols)
    got, want = list(t.blocks(300)), list(jt.blocks(300))
    assert [b.n_rows for b in got] == [b.n_rows for b in want] == [
        300, 300, 300, 100]
    for b, jb in zip(got, want):
        assert b.device == t.device
        _assert_tree(dict(b.columns), dict(jb.columns), exact=True)
    assert list(itertools.chain.from_iterable(
        b["item"].tolist() for b in got)) == cols["item"].tolist()
