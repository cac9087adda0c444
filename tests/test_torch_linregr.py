"""The port's OLS slice against the JAX package, solo and GROUP BY.

The same numpy draws go through both packages.  Fold states
(``finalize=False``) compare bit for bit on dyadic data, where every
partial sum is exact in f32; finalized fields compare with allclose
(rtol 1e-4, atol 1e-5 of the field's scale), because the two
libraries' ``eigh`` and the solve after it round differently (the
reference itself differs by 1 ulp between batched and solo ``eigh``).
Empty groups finalize to NaN in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregates as jagg
from repro.core.table import Table as JTable
from repro.methods import linregr as jlin
from repro_torch.core import (
    FusedAggregate, GroupedScanAgg, ScanAgg, plan, run_grouped, run_local,
    run_many, trace_execution,
)
from repro_torch.core.table import Table
from repro_torch.interop import state_from_numpy, state_to_numpy, \
    table_from_numpy
from repro_torch.methods.linregr import LinregrAggregate, linregr, \
    linregr_grouped
from strategies import Draw, group_layout

G = 5
FIELDS = ("coef", "r2", "std_err", "t_stats", "p_values", "condition_no",
          "num_rows")


def _data(seed: int, n: int = 401, k: int = 4, pattern: str = "skewed"):
    draw = Draw(seed)
    x = draw.dyadic((n, k))
    b = draw.dyadic((k,))
    y = (x @ b + draw.dyadic((n,), scale=0.25)).astype(np.float32)
    gids, _ = group_layout(draw, n, G, pattern)
    cols = {"x": x, "y": y, "g": gids}
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


def _assert_state_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(state_to_numpy(got)[name],
                                      np.asarray(want[name]), err_msg=name)


def _assert_result_close(got, want) -> None:
    # a group with fewer rows than variables has a singular X^T X whose
    # smallest eigenvalue, and so condition number, is rounding noise
    full_rank = np.asarray(want.num_rows) >= want.coef.shape[-1]
    for name in FIELDS:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if name == "condition_no":
            g, w = g[full_rank], w[full_rank]
        scale = max(1.0, float(np.nanmax(np.abs(w), initial=0.0)))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                   equal_nan=True, err_msg=name)


@pytest.mark.parametrize("block_size", [None, 97])
@pytest.mark.parametrize("use_kernel", [False, True, "ref"])
def test_linregr_matches_jax(use_kernel, block_size):
    t, jt = _data(1)
    with trace_execution() as tr:
        got = linregr(t, use_kernel=use_kernel, block_size=block_size)
    want = jlin.linregr(jt, use_kernel=use_kernel, block_size=block_size)
    _assert_result_close(got, want)
    assert len(tr.scans) == 1
    nblocks = 1 if block_size is None else -(-t.n_rows // block_size)
    expected = [] if use_kernel is False else ["ref"] * nblocks
    assert [e.engine for e in tr.kernels] == expected
    state = run_local(LinregrAggregate(use_kernel), t.select("x", "y"),
                      block_size=block_size, finalize=False)
    jstate = jagg.run_local(jlin.LinregrAggregate(use_kernel),
                            jt.select("x", "y"), block_size=block_size,
                            finalize=False)
    _assert_state_equal(state, jstate)


@pytest.mark.parametrize("pattern", ["skewed", "empty", "singleton"])
@pytest.mark.parametrize("block_size", [None, 23])
@pytest.mark.parametrize("use_kernel", [False, True, "ref"])
def test_linregr_grouped_matches_jax(use_kernel, block_size, pattern):
    t, jt = _data(2, pattern=pattern)
    with trace_execution() as tr:
        got = linregr_grouped(t, "g", num_groups=G, use_kernel=use_kernel,
                              block_size=block_size)
    want = jlin.linregr_grouped(jt, "g", num_groups=G, use_kernel=use_kernel,
                                block_size=block_size)
    assert got.coef.shape == (G, 4)
    _assert_result_close(got, want)
    assert [e.engine for e in tr.scans] == ["grouped-segment"]
    assert [e.engine for e in tr.kernels] == \
        ([] if use_kernel is False else ["ref"])
    state = run_grouped(LinregrAggregate(use_kernel), t, "g", G,
                        block_size=block_size, finalize=False)
    jstate = jagg.run_grouped(jlin.LinregrAggregate(use_kernel), jt, "g", G,
                              block_size=block_size, finalize=False)
    _assert_state_equal(state, jstate)


@pytest.mark.parametrize("pattern", ["uniform", "empty"])
def test_grouped_masked_method_and_base_mask_match_jax(pattern):
    t, jt = _data(3, pattern=pattern)
    mask = Draw(4).bools((t.n_rows,), p=0.6)
    for method in ("segment", "masked"):
        state = run_grouped(LinregrAggregate(), t, "g", G, method=method,
                            mask=torch.from_numpy(mask), block_size=16,
                            finalize=False)
        jstate = jagg.run_grouped(jlin.LinregrAggregate(), jt, "g", G,
                                  method=method, mask=mask, block_size=16,
                                  finalize=False)
        _assert_state_equal(state, jstate)


def test_fold_carried_across_from_jax():
    """JAX folds the first half, the state crosses over, the port merges
    its own fold of the second half: bitwise the port's full fold."""
    t, jt = _data(5)
    half = t.n_rows // 2
    x, y = np.asarray(jt["x"]), np.asarray(jt["y"])
    first = JTable.from_columns({"x": x[:half], "y": y[:half]})
    jstate = jagg.run_local(jlin.LinregrAggregate(), first, block_size=64,
                            finalize=False)
    carried = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                               device="cpu")
    agg = LinregrAggregate(True)
    rest = table_from_numpy({"x": x[half:], "y": y[half:]}, device="cpu")
    merged = agg.merge(carried, run_local(agg, rest, block_size=64,
                                          finalize=False))
    full = run_local(agg, t.select("x", "y"), block_size=64, finalize=False)
    _assert_state_equal(merged, {k: v.numpy() for k, v in full.items()})
    np.testing.assert_allclose(agg.final(merged).coef.numpy(),
                               agg.final(full).coef.numpy())


def test_grouped_state_round_trips_through_numpy():
    t, jt = _data(6)
    jstate = jagg.run_grouped(jlin.LinregrAggregate(), jt, "g", G,
                              finalize=False)
    state = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             device="cpu")
    assert state["xtx"].shape == (G, 4, 4)
    back = state_to_numpy(state)
    for k, v in jstate.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    _assert_result_close(LinregrAggregate().final(state),
                         jax_final_grouped(jstate))


def jax_final_grouped(jstate):
    return jax.vmap(jlin.LinregrAggregate().final)(jstate)


def test_plan_fuses_statements_and_rejects_mixed_masks():
    t, _ = _data(7)
    a, b = LinregrAggregate(), LinregrAggregate(True)
    stmts = [ScanAgg(a, t, columns={"x": "x", "y": "y"}),
             ScanAgg(b, t, columns=("x", "y"))]
    with trace_execution() as tr:
        out = plan(stmts).execute()
    assert len(tr.scans) == 1
    np.testing.assert_array_equal(out[0].coef.numpy(), out[1].coef.numpy())
    solo = run_many([a], t.select("x", "y"))[0]
    np.testing.assert_array_equal(out[0].coef.numpy(), solo.coef.numpy())
    gstmts = [GroupedScanAgg(a, t, "g", G, columns=("x", "y")),
              GroupedScanAgg(b, t, "g", G, columns=("x", "y"))]
    with trace_execution() as tr:
        gout = plan(gstmts).execute()
    assert len(tr.scans) == 1 and len(tr.sorts) <= 1
    np.testing.assert_array_equal(gout[0].coef.numpy(), gout[1].coef.numpy())
    m1 = torch.ones(t.n_rows, dtype=torch.bool)
    m2 = torch.ones(t.n_rows, dtype=torch.bool)
    assert len(plan([ScanAgg(a, t, mask=m1),
                     ScanAgg(b, t, mask=m2)]).passes) == 2
    from repro_torch.core.plan import fused_grouped_pass, fused_scan_pass
    with pytest.raises(ValueError, match="mixed-mask"):
        fused_scan_pass([(0, ScanAgg(a, t, mask=m1)),
                         (1, ScanAgg(b, t, mask=m2))])
    with pytest.raises(ValueError, match="block_size"):
        fused_scan_pass([(0, ScanAgg(a, t, block_size=8)),
                         (1, ScanAgg(b, t, block_size=16))])
    with pytest.raises(ValueError, match="different tables"):
        fused_scan_pass([(0, ScanAgg(a, t)), (1, ScanAgg(b, t.select("x")))])
    with pytest.raises(ValueError, match="mixed-mask"):
        fused_grouped_pass([(0, GroupedScanAgg(a, t, "g", G, mask=m1)),
                            (1, GroupedScanAgg(b, t, "g", G, mask=m2))])
    with pytest.raises(ValueError, match="unknown scan engine"):
        fused_scan_pass([(0, ScanAgg(a, t, engine="bogus"))])
    # a forced sharded engine without a mesh is local, as run_sharded is
    assert fused_scan_pass([(0, ScanAgg(a, t, engine="sharded"))]
                           ).engine == "local"
    assert fused_scan_pass([(0, ScanAgg(a, t))]).engine == "local"


def test_fused_aggregate_forwards_kernel_hook_and_names():
    one = FusedAggregate([LinregrAggregate("ref")])
    two = FusedAggregate({"a": LinregrAggregate(), "b": LinregrAggregate()})
    assert (one.segment_kernel, one.kernel_impl) == ("segment_linregr",
                                                     "ref")
    assert two.segment_kernel is None and two.kernel_impl is None
    t, _ = _data(8)
    out = run_many({"a": LinregrAggregate(), "b": LinregrAggregate()},
                   t.select("x", "y"))
    assert set(out) == {"a", "b"}
    with pytest.raises(ValueError, match="unknown engine"):
        run_many([LinregrAggregate()], t, engine="bogus")
