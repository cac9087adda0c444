"""The port's Table against the JAX package's: the partitioning sort, the
group_by memo, the group-aligned layout, versioning, the device policy,
and the port's import boundary.

Inputs are numpy draws from ``tests/strategies.py`` handed to both
packages; layouts must come out identical element for element.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.table import Table as JTable
from repro_torch.core import trace_execution
from repro_torch.core.table import Table, synthetic_regression_table
from strategies import GROUP_PATTERNS, Draw, group_layout

ROOT = Path(__file__).resolve().parents[1]


def _tables(pattern: str, n: int = 157, G: int = 6, k: int = 3):
    draw = Draw(sum(map(ord, pattern)))
    gids, _ = group_layout(draw, n, G, pattern)
    cols = {"x": draw.dyadic((n, k)), "y": draw.dyadic((n,)), "g": gids}
    mask = draw.bools((n,), p=0.7)
    return (Table.from_columns(cols, device="cpu"),
            JTable.from_columns(cols), mask)


@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
def test_sort_and_group_by_match_jax(pattern):
    t, jt, _ = _tables(pattern)
    keys, perm = t.sort_permutation("g")
    jkeys, jperm = jt.sort_permutation("g")
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert perm.dtype == torch.int32
    view, jview = t.group_by("g", 6), jt.group_by("g", 6)
    for name in ("gids", "perm", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(view, name).numpy(),
                                      np.asarray(getattr(jview, name)))
    for name in ("x", "y"):
        np.testing.assert_array_equal(view.table[name].numpy(),
                                      np.asarray(jview.table[name]))
    assert "g" not in view.table.columns


@pytest.mark.parametrize("pad_to", [None, 3, 8])
@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
def test_aligned_blocks_match_jax(pattern, pad_to):
    t, jt, mask = _tables(pattern)
    view, jview = t.group_by("g", 6), jt.group_by("g", 6)
    for base in (None, mask):
        pm = None if base is None else view.permute(base)
        jpm = None if base is None else jview.permute(base)
        cols, valid, bgids = view.aligned_blocks(16, pm, pad_blocks_to=pad_to)
        jcols, jvalid, jbgids = jview.aligned_blocks(16, jpm,
                                                     pad_blocks_to=pad_to)
        for name in jcols:
            np.testing.assert_array_equal(cols[name].numpy(),
                                          np.asarray(jcols[name]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(bgids.numpy(), np.asarray(jbgids))
        assert valid.dtype == torch.bool and bgids.dtype == torch.int32


@pytest.mark.parametrize("pad_to", [None, 4])
def test_empty_view_aligned_blocks_match_jax(pad_to):
    # every id is out of range for num_groups=3: no real blocks at all
    cols = {"x": np.ones((9, 2), np.float32),
            "g": np.full((9,), 5, np.int32)}
    view = Table.from_columns(cols, device="cpu").group_by("g", 3)
    jview = JTable.from_columns(cols).group_by("g", 3)
    got = view.aligned_blocks(8, pad_blocks_to=pad_to)
    want = jview.aligned_blocks(8, pad_blocks_to=pad_to)
    np.testing.assert_array_equal(got[0]["x"].numpy(),
                                  np.asarray(want[0]["x"]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].shape[0] == (pad_to or 0)


def test_group_by_memo_and_sort_sharing():
    t, _, _ = _tables("uniform")
    with trace_execution() as tr:
        v1 = t.group_by("g", 6)
        v2 = t.group_by("g", 6)
        v3 = t.group_by("g")           # None caches under its resolved count
        t.sort_permutation("g")
    assert v1 is v2 and v3.num_groups == 6
    assert len(tr.sorts) == 1 and tr.sorts[0].detail["table"] == id(t)
    # as in the reference, the None lookup builds a view of its own (from
    # the memoized sort) and files it under the resolved count as well
    assert t.cached_group_by("g", 6) is v3 and t.group_by("g") is v3
    assert t.select("x", "g").cached_group_by("g", 6) is None


def test_version_epoch_and_mutation_hooks():
    t, _, _ = _tables("uniform")
    seen = []
    hook = seen.append
    t.on_mutation(hook)
    v = t.group_by("g", 6)
    n = t.n_rows
    extra = {"x": np.zeros((2, 3), np.float32),
             "y": np.zeros((2,), np.float32), "g": np.zeros(2, np.int32)}
    assert t.append(extra) is t
    assert (t.version, t.epoch, t.n_rows) == (1, 0, n + 2)
    assert t.cached_group_by("g", 6) is None     # stale after append
    assert t.group_by("g", 6) is not v
    t.invalidate()
    assert (t.version, t.epoch) == (2, 1)
    assert t.cached_group_by("g", 6) is None and not t._sort_cache
    assert seen == [t, t]
    t.remove_mutation_hook(hook)
    t.remove_mutation_hook(hook)                 # no-op when absent
    t.invalidate()
    assert len(seen) == 2
    with pytest.raises(ValueError, match="append columns"):
        t.append({"x": extra["x"]})
    with pytest.raises(ValueError, match="dtype"):
        t.append(dict(extra, y=np.zeros((2,), np.int32)))
    with pytest.raises(ValueError, match="trailing shape"):
        t.append(dict(extra, x=np.zeros((2, 4), np.float32)))


def test_with_column_select_and_ragged_rejection():
    t, _, _ = _tables("uniform")
    t2 = t.with_column("z", np.arange(t.n_rows, dtype=np.int32))
    assert set(t2.column_names) == {"g", "x", "y", "z"}
    assert t.column_names == ("g", "x", "y")
    assert t2.select("z").n_rows == t.n_rows
    with pytest.raises(ValueError, match="ragged"):
        Table.from_columns({"a": np.zeros(3), "b": np.zeros(4)},
                           device="cpu")


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Table.from_columns({"a": np.zeros(3)})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        synthetic_regression_table(0, 10, 2)
    t, b = synthetic_regression_table(0, 10, 2, device="cpu")
    assert t["x"].shape == (10, 2) and b.shape == (2,)
    assert t.device.type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.methods.linregr" in modules


# ---------------------------------------------------------------------------
# Columns are stored as the reference stores them: JAX with 64-bit types
# off narrows float64 to float32, int64 to int32 (its low 32 bits) and
# complex128 to complex64, and makes Python ints and floats int32 and
# float32.  Before the port narrowed them it kept 64-bit columns as they
# came, and each case below failed.
# ---------------------------------------------------------------------------

BIG = [2 ** 40 + 5, -(2 ** 40) - 3, 2 ** 31, 7]

COLUMN_CASES = {
    "float64": lambda: np.linspace(-2.0, 2.0, 4),
    "float64 2-D": lambda: np.arange(8, dtype=np.float64).reshape(4, 2) / 3,
    "int64 beyond 2^31": lambda: np.array(BIG, np.int64),
    "complex128": lambda: np.array([1 + 2j, 3, -1j, 0.5]),
    "Python ints": lambda: [1, -2, 3, 2 ** 31 - 1],
    "Python floats": lambda: [0.1, 2.5, -1.0, 1e-8],
    "Python ints and floats": lambda: [1, 2.5, -3, 4],
    "Python bools": lambda: [True, False, True, True],
    "float32": lambda: np.float32([1.5, 2, 3, 4]),
    "int32": lambda: np.int32([1, 2, 3, 4]),
    "float16": lambda: np.float16([1.5, 2, 3, 4]),
    "int16": lambda: np.int16([1, -2, 3, 4]),
    "uint8": lambda: np.uint8([1, 2, 255, 4]),
    "bool": lambda: np.array([True, False, False, True]),
}


def _same_column(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
def test_from_columns_stores_columns_as_jax_does(case):
    col = COLUMN_CASES[case]()
    t = Table.from_columns({"c": col}, device="cpu")
    _same_column(t["c"], JTable.from_columns({"c": col})["c"])
    if case == "int64 beyond 2^31":
        assert t["c"].tolist() == [5, -3, -2 ** 31, 7]


@pytest.mark.parametrize("case", ["float64", "int64 beyond 2^31",
                                  "Python ints", "Python floats"])
def test_with_column_and_table_from_numpy_store_as_jax_does(case):
    from repro_torch.interop import table_from_numpy
    col = COLUMN_CASES[case]()
    base = {"a": np.zeros(4, np.float32)}
    t = Table.from_columns(base, device="cpu").with_column("c", col)
    jt = JTable.from_columns(base).with_column("c", jnp.asarray(col))
    _same_column(t["c"], jt["c"])
    if case != "Python ints" and case != "Python floats":
        _same_column(table_from_numpy({"c": col}, device="cpu")["c"],
                     jt["c"])


def test_python_ints_beyond_int32_raise_as_in_jax():
    with pytest.raises(OverflowError):
        Table.from_columns({"c": [2 ** 40, 1]}, device="cpu")
    with pytest.raises(OverflowError):
        JTable.from_columns({"c": [2 ** 40, 1]})


def test_append_of_64_bit_rows_works_as_in_jax():
    cols = {"x": np.ones((3, 2), np.float32), "g": np.int32([0, 1, 2])}
    rows = {"x": np.full((2, 2), 0.1), "g": np.array([2 ** 40 + 5, 1])}
    t = Table.from_columns(cols, device="cpu").append(rows)
    jt = JTable.from_columns(cols).append(rows)
    for name in cols:
        _same_column(t[name], jt[name])
    assert t["g"].tolist() == [0, 1, 2, 5, 1]


def test_int64_group_ids_group_as_in_jax():
    gids = np.array([2 ** 40 + 1, 0, 2 ** 32 + 2, 1, 1, 2], np.int64)
    cols = {"x": np.arange(6, dtype=np.float64), "g": gids}
    t = Table.from_columns(cols, device="cpu")
    jt = JTable.from_columns(cols)
    assert t["g"].dtype == torch.int32 and t["x"].dtype == torch.float32
    view, jview = t.group_by("g"), jt.group_by("g")
    assert view.num_groups == jview.num_groups == 3
    for name in ("gids", "perm", "counts", "offsets"):
        _same_column(getattr(view, name), getattr(jview, name))
    _same_column(view.table["x"], jview.table["x"])


def test_linregr_of_float64_numpy_answers_in_float32_as_jax_does():
    from repro.methods.linregr import linregr as jlinregr
    from repro_torch.methods.linregr import linregr
    draw = Draw(31)
    cols = {"x": draw.normal((300, 3)).astype(np.float64),
            "y": draw.normal((300,)).astype(np.float64)}
    got = linregr(Table.from_columns(cols, device="cpu"))
    want = jlinregr(JTable.from_columns(cols))
    for name in ("coef", "r2", "std_err", "t_stats", "p_values"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def test_warm_starts_are_stored_as_jax_stores_them():
    from repro.core import iterative as jit_
    from repro.methods import kmeans as jkm
    from repro.methods.logregr import IRLSTask as JIRLSTask
    from repro_torch.core import fit
    from repro_torch.methods import kmeans as km
    from repro_torch.methods.logregr import IRLSTask
    draw = Draw(32)
    x = draw.normal((200, 3))
    cols = {"x": x, "y": (x[:, 0] > 0).astype(np.float32)}
    t, jt = Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)
    beta = np.array([0.5, -0.25, 0.125], np.float64)
    got = fit(IRLSTask(), t, max_iters=1, tol=None, warm_start={"beta": beta})
    want = jit_.fit(JIRLSTask(), jt, max_iters=1, tol=None,
                    warm_start={"beta": beta})
    assert got.state["beta"].dtype == torch.float32
    np.testing.assert_allclose(got.state["beta"].numpy(),
                               np.asarray(want.state["beta"]), rtol=1e-5,
                               atol=1e-6)
    init = x[:4].astype(np.float64)
    got = fit(km.KMeansTask(init), t, max_iters=2, tol=None)
    want = jit_.fit(jkm.KMeansTask(init), jt, max_iters=2, tol=None)
    for name in ("cents", "prev", "it"):
        assert (got.state[name].numpy().dtype
                == np.asarray(want.state[name]).dtype), name


def test_stream_blocks_are_stored_as_jax_stores_them():
    from repro.core import aggregates as jagg
    from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
    from repro.methods.sketches import CountMinAggregate as JCountMin
    from repro_torch.core import FusedAggregate, run_stream
    from repro_torch.methods.linregr import LinregrAggregate
    from repro_torch.methods.sketches import CountMinAggregate
    draw = Draw(33)
    n = 1000
    x = draw.dyadic((n, 3)).astype(np.float64)
    y = draw.dyadic((n,)).astype(np.float64)
    item = draw.ints((n,), 0, 50).astype(np.int64) + (2 ** 40) * (
        np.arange(n) % 3)
    blocks = [{"x": x[i:i + 300], "y": y[i:i + 300], "item": item[i:i + 300]}
              for i in range(0, n, 300)]
    blocks[1] = {k: torch.from_numpy(v) for k, v in blocks[1].items()}
    blocks[2] = dict(blocks[2], x=blocks[2]["x"].tolist(),
                     y=blocks[2]["y"].tolist())
    got = run_stream(FusedAggregate([LinregrAggregate(),
                                     CountMinAggregate(4, 64)]),
                     iter(blocks), device="cpu")
    want = jagg.run_stream(jagg.FusedAggregate([JLinregrAggregate(),
                                                JCountMin(4, 64)]),
                           iter([{k: np.asarray(v) for k, v in b.items()}
                                 for b in blocks]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for name in ("coef", "r2"):
        g, w = getattr(got[0], name).numpy(), np.asarray(getattr(want[0],
                                                                 name))
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_uint64_columns_stay_uint64_and_hash_like_jax():
    """The one 64-bit type the port keeps: torch on the CPU has no uint32
    shift, remainder or subtraction, so a uint32 column could not be
    profiled.  The reference keeps the low 32 bits as uint32; the port's
    hashes read the same low 32 bits, so sketches agree."""
    from repro.methods.sketches import countmin_sketch as jcountmin
    from repro_torch.methods.sketches import countmin_sketch
    items = np.array([2 ** 40 + 5, 2 ** 32 - 1, 2 ** 63 + 7, 3, 5, 5],
                     np.uint64)
    t = Table.from_columns({"item": items}, device="cpu")
    jt = JTable.from_columns({"item": items})
    assert t["item"].dtype == torch.uint64
    assert np.asarray(jt["item"]).dtype == np.uint32
    np.testing.assert_array_equal(
        countmin_sketch(t, depth=2, width=8).numpy(),
        np.asarray(jcountmin(jt, depth=2, width=8)))
