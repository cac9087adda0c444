"""The port's living views against the JAX package's.

The same numpy tables and deltas (dyadic draws, ``tests/strategies.py``)
go through ``repro.core.materialize`` and
``repro_torch.core.materialize`` on the CPU.  Each scenario records the
refresh kinds, the trace counts (delta folds, scans, the rows each sort
saw) and the retained fold states.  Kinds and counts must be equal; the
states bitwise equal to the reference's and to a fresh rescan in the
port (dyadic f32 sums and integer sketches are exact in any order);
finalized results allclose (rtol 1e-5).
"""

import importlib
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.templates import ProfileAggregate as JProfileAggregate
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro.methods.sketches import FMAggregate as JFMAggregate
from repro_torch.core import (
    GroupedScanAgg, ScanAgg, Session, Table, materialize, trace_execution,
)
from repro_torch.core.templates import ProfileAggregate
from repro_torch.methods.linregr import LinregrAggregate
from repro_torch.methods.sketches import CountMinAggregate, FMAggregate
from strategies import Draw, cases, group_layout

J = SimpleNamespace(
    table=jcore.Table.from_columns, col=jnp.asarray,
    ScanAgg=jcore.ScanAgg, GroupedScanAgg=jcore.GroupedScanAgg,
    materialize=jcore.materialize, trace=jcore.trace_execution,
    execute=jcore.execute, Session=jcore.Session,
    CM=JCountMinAggregate, FM=JFMAggregate, LR=JLinregrAggregate,
    PROF=JProfileAggregate)
T = SimpleNamespace(
    table=lambda c: Table.from_columns(c, device="cpu"),
    col=torch.from_numpy,
    ScanAgg=ScanAgg, GroupedScanAgg=GroupedScanAgg,
    materialize=materialize, trace=trace_execution,
    execute=tcore.execute, Session=Session,
    CM=CountMinAggregate, FM=FMAggregate, LR=LinregrAggregate,
    PROF=ProfileAggregate)


def _cols(draw: Draw, n: int, d: int = 3, groups: int = 4, pattern=None):
    gids, _ = group_layout(draw, n, groups, pattern)
    return {"x": draw.dyadic((n, d)), "y": draw.dyadic((n,)),
            "item": draw.ints((n,), 0, 40), "g": gids}


def _delta(draw: Draw, m: int, d: int = 3, groups: int = 4):
    return {"x": draw.dyadic((m, d)), "y": draw.dyadic((m,)),
            "item": draw.ints((m,), 0, 40),
            "g": draw.ints((m,), 0, groups - 1)}


def _flat(tree) -> list:
    """Leaves in a package-independent order (dict keys sorted,
    dataclass fields in order) as numpy arrays."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _flat(t)]
    if hasattr(tree, "__dataclass_fields__"):
        return [v for f in tree.__dataclass_fields__
                for v in _flat(getattr(tree, f))]
    return [np.asarray(tree)]


def _bitwise(a, b, what="") -> None:
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb), what
    for x, y in zip(fa, fb):
        assert x.shape == y.shape and np.array_equal(x, y), what


def _close(a, b, what="") -> None:
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb), what
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=what)


def _close_result(got, want, what="") -> None:
    """Finalized results allclose; for a grouped linregr, over the groups
    with at least as many rows as variables: a rank-deficient X^T X has
    eigenvalues of rounding noise, which the two packages' eigh round
    to either side of the pseudo-inverse's cut (the states, compared
    bitwise, are equal there too)."""
    if hasattr(want, "num_rows") and np.ndim(want.num_rows) == 1:
        keep = np.asarray(want.num_rows) >= np.shape(want.coef)[-1]
        got = [np.asarray(v)[keep] for v in _flat(got)]
        want = [np.asarray(v)[keep] for v in _flat(want)]
    _close(got, want, what)


def _scan_members(P, t):
    return [P.ScanAgg(P.CM(4, 64, item_col="item"), t, columns=("item",)),
            P.ScanAgg(P.FM(4, 16, item_col="item"), t, columns=("item",)),
            P.ScanAgg(P.LR(), t, columns={"x": "x", "y": "y"}),
            P.ScanAgg(P.PROF(), t, columns=("x", "y"))]


def _grouped_member(P, t, G):
    return P.GroupedScanAgg(P.LR(), t, "g", num_groups=G,
                            columns={"x": "x", "y": "y"})


def _run(P, cols, deltas, build, mutate=None):
    """Materialize ``build(P, table)``, then per delta: append it (or
    call ``mutate``) and refresh.  Returns kinds, per-refresh trace
    counts, the handle and its table."""
    t = P.table(cols)
    h = P.materialize(build(P, t))
    kinds, counts = [], []
    for d in deltas:
        if d is None:
            mutate(P, t)
        else:
            t.append(d)
        with P.trace() as tr:
            kinds.append(h.refresh())
        counts.append((len(tr.deltas), len(tr.scans),
                       [e.detail["n_rows"] for e in tr.sorts]))
    return kinds, counts, h, t


def _check_both(cols, deltas, build, mutate=None, what=""):
    got = _run(T, cols, deltas, build, mutate)
    want = _run(J, cols, deltas, build, mutate)
    assert got[0] == want[0], what
    assert got[1] == want[1], what
    _bitwise(got[2]._state, want[2]._state, what)
    _close_result(got[2].result(), want[2].result(), what)
    # the port's refreshed state against a fresh rescan of its table
    rescan = materialize(build(T, got[3]))
    _bitwise(got[2]._state, rescan._state, what)
    return got


def test_scan_delta_equals_the_reference_and_a_rescan():
    for draw in cases(3, base_seed=61):
        cols = _cols(draw, draw.integers(300, 900))
        deltas = [_delta(draw, draw.integers(20, 150))]
        kinds, counts, *_ = _check_both(cols, deltas, _scan_members,
                                        what=str(draw))
        assert kinds == ["delta"] and counts[0][:2] == (1, 0)


def test_multiple_appends_chain():
    draw = Draw(11)
    cols = _cols(draw, 256)
    deltas = [_delta(draw, 64) for _ in range(3)]
    kinds, *_ = _check_both(cols, deltas, lambda P, t: P.ScanAgg(
        P.CM(4, 32, item_col="item"), t, columns=("item",)))
    assert kinds == ["delta"] * 3


@pytest.mark.parametrize("pattern", ("uniform", "skewed", "empty"))
def test_grouped_delta_sorts_only_the_delta(pattern):
    """The grouped view's delta fold (through ``segment_linregr``'s plain
    version here) re-sorts only the appended rows and equals a rescan
    bitwise."""
    for draw in cases(2, base_seed=71):
        G = 5
        cols = _cols(draw, draw.integers(300, 800), groups=G,
                     pattern=pattern)
        m = draw.integers(16, 120)
        kinds, counts, *_ = _check_both(
            cols, [_delta(draw, m, groups=G)],
            lambda P, t: _grouped_member(P, t, G), what=str(draw))
        assert kinds == ["delta"] and counts[0] == (1, 0, [m])


def test_grouped_view_through_the_kernel_path():
    """``use_kernel=True`` routes the build, the delta and the rescan
    through the registered ``segment_linregr`` (its plain version on the
    CPU); still bitwise against the reference's kernel path."""
    draw = Draw(72)
    G = 4
    cols = _cols(draw, 400, groups=G)
    build = (lambda P, t: P.GroupedScanAgg(
        P.LR(use_kernel=True), t, "g", num_groups=G,
        columns={"x": "x", "y": "y"}))
    kinds, *_ = _check_both(cols, [_delta(draw, 70, groups=G)], build)
    assert kinds == ["delta"]


def test_new_group_id_forces_rescan():
    draw = Draw(5)
    cols = _cols(draw, 200, groups=3)
    cols["g"] = np.minimum(cols["g"], 2).astype(np.int32)
    delta = _delta(draw, 32, groups=3)
    delta["g"] = np.full(32, 7, np.int32)  # a key outside the pinned G
    kinds, counts, h, _ = _check_both(cols, [delta], lambda P, t:
                                      P.GroupedScanAgg(
                                          P.LR(), t, "g",
                                          columns={"x": "x", "y": "y"}))
    assert kinds == ["rescan"] and counts[0][:2] == (0, 1)
    assert tuple(h.result().num_rows.shape) == (8,)


def test_fixed_group_count_drops_out_of_range_delta_keys():
    draw = Draw(13)
    cols = _cols(draw, 200, groups=4)
    delta = _delta(draw, 24, groups=4)
    delta["g"][:8] = 9  # out of range under num_groups=4: dropped
    kinds, *_ = _check_both(cols, [delta],
                            lambda P, t: _grouped_member(P, t, 4))
    assert kinds == ["delta"]


def test_invalidate_forces_rescan():
    draw = Draw(15)
    cols = _cols(draw, 256)
    new_y = draw.dyadic((256,))

    def mutate(P, t):
        t.columns["y"] = P.col(new_y.copy())
        t.invalidate()

    kinds, counts, *_ = _check_both(
        cols, [None, _delta(draw, 40)], lambda P, t: P.ScanAgg(
            P.LR(), t, columns={"x": "x", "y": "y"}), mutate)
    assert kinds == ["rescan", "delta"]
    assert counts[0][:2] == (0, 1)


def test_noop_and_empty_append():
    draw = Draw(7)
    t = Table.from_columns(_cols(draw, 200), device="cpu")
    h = materialize(ScanAgg(LinregrAggregate(), t,
                            columns={"x": "x", "y": "y"}))
    with trace_execution() as tr:
        assert h.refresh() == "noop"
    assert not tr.scans and not tr.deltas and not h.stale()
    t.append({k: v[:0] for k, v in _delta(draw, 1).items()})
    assert h.stale() and h.refresh() == "noop" and not h.stale()


@pytest.mark.parametrize("case", ("masked", "mixed", "prebuilt", "mixed-kind"))
def test_loud_rejections(case):
    t1 = Table.from_columns({"y": np.arange(8.0, dtype=np.float32),
                             "g": np.zeros(8, np.int32)}, device="cpu")
    t2 = Table.from_columns({"y": np.arange(8.0, dtype=np.float32),
                             "g": np.zeros(8, np.int32)}, device="cpu")
    if case == "masked":
        with pytest.raises(ValueError, match="mask"):
            materialize(ScanAgg(ProfileAggregate(), t1,
                                mask=torch.ones(8, dtype=torch.bool)))
    elif case == "mixed":
        with pytest.raises(ValueError, match="different tables"):
            materialize([ScanAgg(ProfileAggregate(), t1),
                         ScanAgg(ProfileAggregate(), t2)])
    elif case == "prebuilt":
        with pytest.raises(TypeError, match="GroupedView"):
            materialize(GroupedScanAgg(ProfileAggregate(),
                                       t1.group_by("g", 1)))
    else:
        with pytest.raises(TypeError, match="mix scan and grouped"):
            materialize([ScanAgg(ProfileAggregate(), t1),
                         GroupedScanAgg(ProfileAggregate(), t1, "g")])
    with pytest.raises(ValueError, match="empty"):
        materialize([])


def test_session_materialize_and_refresh():
    draw = Draw(3)
    cols = _cols(draw, 300)
    delta = _delta(draw, 50)
    out = {}
    for name, P in (("torch", T), ("jax", J)):
        t = P.table(cols)
        sess = P.Session()
        h = sess.materialize(
            P.ScanAgg(P.CM(4, 32, item_col="item"), t, columns=("item",)),
            P.ScanAgg(P.LR(), t, columns={"x": "x", "y": "y"}))
        t.append(delta)
        with P.trace() as tr:
            (res,) = sess.refresh()
        assert len(tr.deltas) == 1 and len(tr.scans) == 0
        assert h in sess._materialized
        out[name] = res
    _bitwise(out["torch"][0], out["jax"][0])
    _close(out["torch"][1], out["jax"][1])


def test_concurrent_refresh_folds_the_delta_once(monkeypatch):
    mat = importlib.import_module("repro_torch.core.materialize")
    draw = Draw(17)
    t = Table.from_columns(_cols(draw, 256), device="cpu")
    h = materialize(ScanAgg(CountMinAggregate(4, 1024), t,
                            columns=("item",)))
    started, release = threading.Event(), threading.Event()
    real = mat.run_local

    def gated(*args, **kwargs):
        started.set()
        if not release.wait(60):
            raise RuntimeError("gated fold never released")
        return real(*args, **kwargs)

    monkeypatch.setattr(mat, "run_local", gated)
    t.append(_delta(draw, 64))
    with trace_execution() as tr:
        threads = [threading.Thread(target=h.result, daemon=True)
                   for _ in range(2)]
        for th in threads:
            th.start()
        assert started.wait(30)
        release.set()
        for th in threads:
            th.join(30)
            assert not th.is_alive()
    assert len(tr.deltas) == 1
    fresh = tcore.execute(ScanAgg(CountMinAggregate(4, 1024), t,
                                  columns=("item",)))
    assert torch.equal(h.result(), fresh)


def test_delta_racing_invalidate_leaves_the_view_stale(monkeypatch):
    mat = importlib.import_module("repro_torch.core.materialize")
    draw = Draw(19)
    t = Table.from_columns(_cols(draw, 256), device="cpu")
    h = materialize(ScanAgg(CountMinAggregate(4, 1024), t,
                            columns=("item",)))
    started, release = threading.Event(), threading.Event()
    real = mat.run_local

    def gated(*args, **kwargs):
        started.set()
        if not release.wait(60):
            raise RuntimeError("gated fold never released")
        return real(*args, **kwargs)

    monkeypatch.setattr(mat, "run_local", gated)
    t.append(_delta(draw, 64))
    refresher = threading.Thread(target=h.refresh, daemon=True)
    refresher.start()
    assert started.wait(30)
    t.columns["item"] = torch.from_numpy(draw.ints((t.n_rows,), 0, 40))
    t.invalidate()
    release.set()
    refresher.join(30)
    assert not refresher.is_alive()
    assert h.stale()
    monkeypatch.setattr(mat, "run_local", real)
    assert h.refresh() == "rescan"
    fresh = tcore.execute(ScanAgg(CountMinAggregate(4, 1024), t,
                                  columns=("item",)))
    assert torch.equal(h.result(), fresh)
