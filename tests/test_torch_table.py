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
        t.append(dict(extra, y=np.zeros((2,), np.float64)))
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
