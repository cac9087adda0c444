"""The port's ``explain()`` against the JAX package's goldens.

The reference's golden plans (``tests/test_plan.py``) must come out of
the port line for line, and batches beyond the goldens (joins, shared
sorts, grouped fits, forced methods, the server's admission window) must
render exactly as the reference renders the same statements.  The only
permitted difference is the table in ``repro_torch/core/plan.py``'s
docstring: kernel impl names (``"pallas"`` there, ``"cuda"`` here), which
the statements carry and the plan text never shows.
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.methods.linregr import LinregrAggregate as JLinregrAggregate
from repro.methods.logregr import IRLSTask as JIRLSTask
from repro.methods.quantiles import HistogramAggregate as JHistogram
from repro.methods.sketches import CountMinAggregate as JCountMinAggregate
from repro.methods.sketches import FMAggregate as JFMAggregate
from repro_torch.core import (
    GroupedScanAgg, IterativeFit, Join, ScanAgg, Session, Table, explain,
)
from repro_torch.methods.linregr import LinregrAggregate
from repro_torch.methods.logregr import IRLSTask
from repro_torch.methods.quantiles import HistogramAggregate
from repro_torch.methods.sketches import CountMinAggregate, FMAggregate

N, GROUPS = 512, 4


def _cols():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((N, 3)).astype(np.float32),
            "y": rng.standard_normal(N).astype(np.float32),
            "item": rng.integers(0, 100, N).astype(np.int32),
            "g": (np.arange(N) % GROUPS).astype(np.int32)}


@pytest.fixture(scope="module")
def tables():
    cols = _cols()
    return (Table.from_columns(cols, device="cpu"),
            jcore.Table.from_columns(cols))


def _cm(P="t"):
    cls = CountMinAggregate if P == "t" else JCountMinAggregate
    return cls(depth=4, width=256, item_col="item")


def _fm(P="t"):
    cls = FMAggregate if P == "t" else JFMAggregate
    return cls(num_hashes=4, bits=16, item_col="item")


def _hist(P="t"):
    cls = HistogramAggregate if P == "t" else JHistogram
    return cls(-4.0, 4.0, bins=64, value_col="y")


def test_explain_golden_fused_batch(tables):
    table, _ = tables
    sess = Session()
    sess.scan(_cm(), table)
    sess.scan(_fm(), table)
    sess.scan(_hist(), table)
    sess.grouped_scan(_cm(), table, "g", num_groups=GROUPS,
                      columns=("item",))
    sess.grouped_scan(_fm(), table, "g", num_groups=GROUPS,
                      columns=("item",))
    assert sess.explain() == (
        "plan: 5 statements -> 2 passes, 1 sort\n"
        "  pass 0: shared-scan [local] t0 rows=512 cost=512 [heuristic]\n"
        "    s0: CountMinAggregate\n"
        "    s1: FMAggregate\n"
        "    s2: HistogramAggregate\n"
        "  pass 1: grouped-scan [grouped-segment] t0 by g groups=4 "
        "sort=v0 rows=512 cost=1024 [heuristic] (rejected: masked=2048)\n"
        "    s3: CountMinAggregate\n"
        "    s4: FMAggregate"
    )


def test_explain_golden_masked_and_fit(tables):
    table, _ = tables
    mask = torch.from_numpy(np.arange(N) % 2 == 0)
    sess = Session()
    sess.scan(_hist(), table, mask=mask, block_size=128)
    sess.grouped_scan(_cm(), table, "g", num_groups=GROUPS,
                      columns=("item",), method="masked")
    sess.statement(IterativeFit(
        IRLSTask(), table.select("x", "y"), max_iters=5, tol=1e-4,
        label="irls"))
    assert sess.explain() == (
        "plan: 3 statements -> 3 passes, 1 sort\n"
        "  pass 0: shared-scan [local] t0 rows=512 mask=yes block=128 "
        "cost=512 [heuristic]\n"
        "    s0: HistogramAggregate\n"
        "  pass 1: grouped-scan [grouped-masked] t0 by g groups=4 "
        "sort=v0 rows=512 cost=2048 [heuristic] (rejected: segment=1024)\n"
        "    s1: CountMinAggregate\n"
        "  pass 2: fit [local] t1 rows=512 max_iters=5 tol=0.0001 "
        "cost=2560 [heuristic]\n"
        "    irls: IRLSTask"
    )


def _batch(P, table, case):
    """The same batch in either package (P = "t" port, "j" reference);
    kernel impl names follow the table in plan.py's docstring."""
    Sess = jcore.Session if P == "j" else Session
    LR = JLinregrAggregate if P == "j" else LinregrAggregate
    impl = "pallas" if P == "j" else "cuda"
    Fit = jcore.IterativeFit if P == "j" else IterativeFit
    Task = JIRLSTask if P == "j" else IRLSTask
    JoinC = jcore.Join if P == "j" else Join
    sess = Sess()
    if case == "kernel-impls":
        sess.linregr(table, use_kernel=impl)
        sess.countmin_sketch(table)
        sess.grouped_scan(LR(use_kernel=impl), table, "g", GROUPS,
                          columns={"x": "x", "y": "y"})
    elif case == "grouped-fit-shares-sort":
        sess.grouped_scan(LR(), table, "g", GROUPS, columns=("x", "y"))
        sess.statement(Fit(Task(), table, group_col="g",
                           num_groups=GROUPS, max_iters=3, tol=None,
                           label="fit_g"))
        sess.grouped_scan(_cm(P), table, "g", GROUPS, columns=("item",),
                          block_size=64)
    elif case == "joins":
        dcols = {"key": np.arange(100, dtype=np.int32) * 3 + 1,
                 "region": (np.arange(100) % 5).astype(np.int32)}
        dim = (jcore.Table.from_columns(dcols) if P == "j"
               else Table.from_columns(dcols, device="cpu"))
        fk = "item"
        sess.joined_grouped_scan(LR(), JoinC(table, dim, fk, "key",
                                             "region", on_missing="drop"),
                                 columns={"x": "x", "y": "y"})
        sess.joined_grouped_scan(_cm(P), JoinC(table, dim, fk, "key",
                                               "region", on_missing="drop"),
                                 columns=("item",))
        sess.joined_grouped_scan(LR(), JoinC(table, dim, fk, "key",
                                             "region", on_missing="drop"),
                                 num_groups=8, columns=("x", "y"),
                                 method="masked")
        sess.linregr(table)
    elif case == "two-keys":
        t2 = table.select("x", "y", "g")
        sess.grouped_scan(_cm(P), table, "g", GROUPS, columns=("item",))
        sess.grouped_scan(LR(), t2, "g", None, columns=("x", "y"))
        sess.scan(_fm(P), table, block_size=100)
    return sess.explain()


@pytest.mark.parametrize("case", ["kernel-impls", "grouped-fit-shares-sort",
                                  "joins", "two-keys"])
def test_explain_equals_the_reference(tables, case):
    table, jtable = tables
    got = _batch("t", table, case)
    assert got == _batch("j", jtable, case)
    assert "pallas" not in got and "cuda" not in got


def test_solo_explain_equals_the_reference(tables):
    table, jtable = tables
    got = explain(GroupedScanAgg(LinregrAggregate(), table, "g", GROUPS,
                                 columns=("x", "y")))
    want = jcore.explain(jcore.GroupedScanAgg(
        JLinregrAggregate(), jtable, "g", GROUPS, columns=("x", "y")))
    assert got == want
    assert explain([ScanAgg(_fm(), table)]) == jcore.explain(
        [jcore.ScanAgg(_fm("j"), jtable)])

