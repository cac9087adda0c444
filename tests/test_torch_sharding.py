"""The port's mesh, row sharding, distributed tables and the planner's
engine choice, against the JAX package's.

A :class:`repro_torch.distributed.sharding.Mesh` names its axes and
holds a ``torch.device`` per position; one device may appear at several
positions, so CPU meshes of 1, 2, 8 and 24 segments run here.  Held
bitwise against JAX: ``pad_to`` (values and mask) and
``sharded_blocks`` at one segment (the whole layout).  Held equal to the
JAX functions, which take the port's ``Mesh`` (they read only its
``shape``): ``scan_cost``, ``grouped_cost``, ``select_scan_engine`` and
``select_grouped_method`` over a grid of rows, segments, masks and
forced choices, ``ENGINE_CAPS``, and ``explain`` line for line on a
distributed table.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.compat import make_mesh as jmake_mesh
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.logregr import IRLSTask as JIRLSTask
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
import repro_torch.core as tcore
from repro_torch.core import (
    ENGINE_CAPS, Table, explain, make_mesh, scan_cost, select_scan_engine,
    trace_execution,
)
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.methods.linregr import LinregrAggregate
from repro_torch.methods.logregr import IRLSTask
from repro_torch.methods.sketches import CountMinAggregate
from strategies import GROUP_PATTERNS, Draw, group_layout

# the packages export a function ``plan``, which hides the module
jplan = importlib.import_module("repro.core.plan")
tplan = importlib.import_module("repro_torch.core.plan")
SEGS = (1, 2, 8, 24)


def _mesh(p: int, device: str = "cpu"):
    return make_mesh((p,), ("data",), devices=[device] * p)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------

def test_make_mesh_names_axes_and_repeats_devices():
    m = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4}
    assert m.axis_names == ("data", "model") and m.size == 8
    assert m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert len(m.segments(("data",))) == 2
    assert len(m.segments(("data", "model"))) == 8
    assert sh.mesh_segments(m, ("model",)) == 4
    with pytest.raises(ValueError, match="devices for a mesh"):
        make_mesh((3,), ("data",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not in"):
        m.segments(("pod",))


def test_segments_are_row_major_over_the_row_axes():
    devs = [torch.device("cpu"), torch.device("meta")] * 4
    m = sh.Mesh(np.array(devs, dtype=object).reshape(2, 2, 2),
                ("pod", "data", "model"))
    # model varies fastest: every segment over (pod, data) sits at model 0
    assert m.segments(("pod", "data")) == [torch.device("cpu")] * 4
    assert m.segments(("model",)) == [torch.device("cpu"),
                                      torch.device("meta")]
    # the first axis named is the slowest
    assert m.segments(("model", "pod")) == [
        m.devices[0, 0, 0], m.devices[1, 0, 0], m.devices[0, 0, 1],
        m.devices[1, 0, 1]]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_meshes_of_cards_raise_without_one():
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh((24,), ("data",), devices=["cuda:0"] * 24)
    with pytest.raises(RuntimeError, match="devices="):
        make_host_mesh()


@pytest.mark.parametrize("p", SEGS)
def test_row_sharding_splits_rows_as_p_row_axes_does(p):
    n = 24 * 5
    ranges = sh.row_sharding(_mesh(p), ("data",), n)
    assert [(a, b) for _, a, b in ranges] == [
        (s * n // p, (s + 1) * n // p) for s in range(p)]
    if p > 1:
        with pytest.raises(ValueError, match="pad first"):
            sh.row_sharding(_mesh(p), ("data",), n + 1)


def test_segment_views_are_views_on_the_segments_device():
    x = torch.arange(16.0).reshape(8, 2)
    with trace_execution() as tr:
        parts = sh.segment_views(_mesh(4), ("data",), {"x": x})
    assert [p["x"].data_ptr() for p in parts] == [
        x[2 * s].data_ptr() for s in range(4)]
    assert tr.summary().get("copy", 0) == 0
    # a segment on another device gets its rows copied, once per segment
    with trace_execution() as tr:
        parts = sh.segment_views(_mesh(4, "meta"), ("data",), {"x": x})
    assert [p["x"].device.type for p in parts] == ["meta"] * 4
    assert [e.detail["bytes"] for e in tr.events
            if e.kind == "copy"] == [16] * 4


def test_replicate_puts_one_copy_on_each_device():
    t = torch.arange(5)
    assert sh.replicate(_mesh(8), t) == {torch.device("cpu"): t}
    reps = sh.replicate(_mesh(2, "meta"), t)
    assert list(reps) == [torch.device("meta")]


# ---------------------------------------------------------------------------
# Distributed tables.
# ---------------------------------------------------------------------------

def _table(n=48, seed=0):
    draw = Draw(seed)
    return Table.from_columns({"x": draw.dyadic((n, 3)),
                               "y": draw.dyadic((n,)),
                               "g": draw.ints((n,), 0, 3)}, device="cpu")


@pytest.mark.parametrize("p", SEGS)
def test_distribute_and_what_keeps_the_mesh(p):
    t = _table()
    d = t.distribute(_mesh(p))
    assert d.mesh is not None and d.row_axes == ("data",)
    assert all(torch.equal(d[k], t[k]) for k in t.columns)
    for derived in (d.select("x"), d.with_column("z", torch.ones(48)),
                    d.map_rows(lambda c: {"w": c["y"] * 2}),
                    d.group_by("g", 4).table, next(d.blocks(48))):
        assert derived.mesh is d.mesh and derived.row_axes == ("data",)
    if p > 1:
        with pytest.raises(ValueError, match="pad first"):
            _table(49).distribute(_mesh(p))
        with pytest.raises(ValueError, match="pad first"):
            d.append({"x": np.zeros((1, 3), np.float32),
                      "y": np.zeros(1, np.float32),
                      "g": np.zeros(1, np.int32)})
    d.append({k: v[:p] for k, v in t.columns.items()})
    assert d.n_rows == 48 + p


def test_a_mesh_that_is_no_mesh_raises_type_error():
    t = _table()
    with pytest.raises(TypeError, match="Mesh"):
        t.distribute(object())
    with pytest.raises(TypeError, match="Mesh"):
        Table(dict(t.columns), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        t.group_by("g", 4).sharded_blocks(object())


@pytest.mark.parametrize("fill", [0.0, 1.5, -2.0])
@pytest.mark.parametrize("n", [48, 50, 64])
def test_pad_to_is_bitwise_jax(n, fill):
    draw = Draw(n)
    cols = {"x": draw.normal((45, 3)), "y": draw.normal((45,)),
            "g": draw.ints((45,), 0, 7), "b": draw.bools((45,))}
    got, gmask = Table.from_columns(cols, device="cpu").pad_to(n, fill)
    want, wmask = jcore.Table.from_columns(cols).pad_to(n, fill)
    np.testing.assert_array_equal(_np(gmask), np.asarray(wmask))
    for k in cols:
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    # on a distributed table the padded table and its mask keep the mesh
    d, m = _table(45).distribute(_mesh(1)).pad_to(48)
    assert d.mesh is not None and m.shape == (48,) and int(m.sum()) == 45
    with pytest.raises(ValueError, match="smaller"):
        _table(45).pad_to(44)


@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
def test_sharded_blocks_at_one_segment_is_jax_layout(pattern):
    draw = Draw(sum(map(ord, pattern)))
    n = 300
    gids, _ = group_layout(draw, n, 6, pattern)
    cols = {"x": draw.dyadic((n, 2)), "y": draw.dyadic((n,)), "g": gids}
    base = draw.bools((n,), p=0.7)
    view = Table.from_columns(cols, device="cpu").group_by("g", 6)
    jview = jcore.Table.from_columns(cols).group_by("g", 6)
    got = view.sharded_blocks(_mesh(1), ("data",), 64,
                              view.permute(torch.from_numpy(base)))
    want = jview.sharded_blocks(jmake_mesh((1,), ("data",)), ("data",), 64,
                                jview.permute(jnp.asarray(base)))
    assert set(got[0]) == set(want[0])
    for k in got[0]:
        np.testing.assert_array_equal(_np(got[0][k]), np.asarray(want[0][k]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize("p", [2, 8, 24])
def test_sharded_blocks_chunk_whole_blocks(p):
    draw = Draw(p)
    n = 500
    gids, _ = group_layout(draw, n, 5, "skewed")
    cols = {"x": draw.dyadic((n, 2)), "g": gids}
    view = Table.from_columns(cols, device="cpu").group_by("g", 5)
    jview = jcore.Table.from_columns(cols).group_by("g", 5)
    got = view.sharded_blocks(_mesh(p), ("data",), 64)
    want = jview.aligned_blocks(64, pad_blocks_to=p)
    np.testing.assert_array_equal(_np(got[0]["x"]), np.asarray(want[0]["x"]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    nb = got[2].shape[0]
    assert nb % p == 0 and got[1].shape[0] == nb * 64
    # every segment's chunk of rows holds whole blocks of its block ids
    chunks = sh.segment_views(_mesh(p), ("data",), {"v": got[1]})
    assert all(c["v"].shape[0] == nb // p * 64 for c in chunks)


# ---------------------------------------------------------------------------
# The planner's engine choice, against the JAX functions (which take the
# port's Mesh: they read its ``shape`` only).
# ---------------------------------------------------------------------------

def test_engine_caps_are_jax():
    assert ENGINE_CAPS == jplan.ENGINE_CAPS


@pytest.mark.parametrize("p", (None,) + SEGS)
def test_scan_choice_equals_jax(p):
    mesh = None if p is None else _mesh(p)
    for rows in (0, 1, 23, 4096, 10_000_008):
        for engine in ("local", "sharded"):
            assert scan_cost(engine, rows, p or 1) == jplan.scan_cost(
                engine, rows, p or 1)
        for mask in (False, True):
            for forced in ("auto", "local", "sharded"):
                got = select_scan_engine(rows, mesh, ("data",), mask=mask,
                                         forced=forced, agg_cls="xtx")
                want = jplan.select_scan_engine(rows, mesh, ("data",),
                                                mask=mask, forced=forced,
                                                agg_cls="xtx")
                assert got == want, (rows, mask, forced)
    with pytest.raises(ValueError, match="unknown scan engine"):
        select_scan_engine(10, mesh, forced="stream")


@pytest.mark.parametrize("p", SEGS)
def test_grouped_choice_equals_jax(p):
    for rows in (1, 1000, 10_000_000):
        for groups in (1, 8, 64, 1024):
            for method in ("segment", "masked"):
                for block in (64, 4096):
                    assert tplan.grouped_cost(method, rows, groups, block,
                                              p) == jplan.grouped_cost(
                        method, rows, groups, block, p)
            for ok in (True, False):
                for mask in (False, True):
                    for forced in ("auto", "segment", "masked"):
                        kw = {"segment_ok": ok, "segs": p, "mask": mask,
                              "forced": forced, "block_size": None}
                        if forced == "segment" and not ok:
                            with pytest.raises(ValueError):
                                tplan.select_grouped_method(rows, groups,
                                                            **kw)
                            continue
                        assert tplan.select_grouped_method(
                            rows, groups, **kw) == \
                            jplan.select_grouped_method(rows, groups, **kw)


def _batch(t, P):
    """One batch of scans, a masked scan, a grouped scan and two fits."""
    core, lin, cm, irls = (
        (tcore, LinregrAggregate, CountMinAggregate, IRLSTask) if P == "t"
        else (jcore, JLinregrAggregate, JCountMinAggregate, JIRLSTask))
    xy = {"x": "x", "y": "y"}
    return [core.ScanAgg(lin(), t, columns=xy, label="ols"),
            core.ScanAgg(cm(depth=4, width=64, item_col="item"), t,
                         columns=("item",), label="cm"),
            core.GroupedScanAgg(lin(), t, "g", 4, columns=xy,
                                label="ols_g"),
            core.ScanAgg(lin(), t, columns=xy, mask=t["mask"],
                         label="ols_masked"),
            core.IterativeFit(irls(), t, max_iters=3, label="irls"),
            core.IterativeFit(irls(), t, group_col="g", num_groups=4,
                              max_iters=3, label="irls_g")]


def _cols(n=96):
    draw = Draw(9)
    return {"x": draw.normal((n, 3)), "y": draw.ints((n,), 0, 1)
            .astype(np.float32), "item": draw.ints((n,), 0, 40),
            "g": (np.arange(n) % 4).astype(np.int32),
            "mask": draw.bools((n,), p=0.8)}


def test_explain_on_a_one_segment_table_is_jax_line_for_line():
    cols = _cols()
    t = Table.from_columns(cols, device="cpu").distribute(_mesh(1))
    jt = jcore.Table.from_columns(cols).distribute(
        jmake_mesh((1,), ("data",)))
    got = explain(_batch(t, "t"))
    want = jcore.explain(_batch(jt, "j"))
    assert got.splitlines() == want.splitlines()
    assert "shared-scan [local]" in got and "(rejected: sharded=97)" in got


@pytest.mark.parametrize("p", [2, 8, 24])
def test_explain_on_segments_is_jax_line_for_line(p):
    """The JAX planner never executes to render a plan, so a JAX table
    that carries the port's p-segment Mesh renders what the reference
    plans over p devices."""
    cols = _cols()
    mesh = _mesh(p)
    t = Table.from_columns(cols, device="cpu").distribute(mesh)
    jt = jcore.Table(dict(jcore.Table.from_columns(cols).columns), mesh,
                     ("data",))
    got = explain(_batch(t, "t"))
    want = jcore.explain(_batch(jt, "j"))
    assert got.splitlines() == want.splitlines()
    assert "shared-scan [sharded]" in got
    assert "grouped-scan [sharded-grouped[segment]]" in got
    assert "fit [sharded]" in got
