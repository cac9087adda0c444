"""The port's measured calibration against the JAX package's.

The reference's calibration cases (``tests/test_plan.py``) run on the
port; one synthetic calibration, activated in both packages, gives the
same ``explain()`` text line for line, the same chosen grouped method
and the same segment block; a file written by either package loads in
the other; and the card-side harness, run on the CPU at ``--tiny``,
writes a file that covers ``local`` and both grouped engines and flips
``explain``.  Everything compared here is exact (text, choices, block
sizes, and the seconds a lookup interpolates from the same table).
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as jcore
import repro.core.calibration as jcal
from repro.core.aggregates import segment_block_size as jblock
from repro_torch.core import Session, Table
from repro_torch.core import calibration as tcal
from repro_torch.core.aggregates import segment_block_size
from repro_torch.core.plan import select_grouped_method
from repro_torch.methods.sketches import CountMinAggregate
from test_torch_explain import GROUPS, N, _batch, _cols

# the module: the reference's core package exports a function "plan"
jplan = importlib.import_module("repro.core.plan")
ROOT = Path(__file__).resolve().parents[1]
TS = "2026-08-07T00:00:00"


@pytest.fixture(scope="module")
def tables():
    cols = _cols()
    return Table.from_columns(cols, device="cpu"), \
        jcore.Table.from_columns(cols)


def _cal(engines, **kw):
    return tcal.Calibration(backend="cpu", timestamp=TS, engines=engines,
                           kernels=kw.get("kernels", {}),
                           grouped_block=kw.get("grouped_block", []))


def _cm():
    return CountMinAggregate(depth=4, width=256, item_col="item")


# -- the reference's four cases (tests/test_plan.py) ------------------------

def test_calibration_flips_grouped_choice_and_explain(tables):
    table, _ = tables
    cal = _cal({
        "grouped-segment": {"sketch": [
            {"rows": 512, "groups": 4, "seconds": 2.0e-3}]},
        "grouped-masked": {"sketch": [
            {"rows": 512, "groups": 4, "seconds": 5.0e-4}]},
    })
    sess = Session()
    sess.grouped_scan(_cm(), table, "g", num_groups=GROUPS,
                      columns=("item",))
    with tcal.use(cal):
        txt = sess.explain()
    assert "[grouped-masked]" in txt, txt
    assert f"[measured cpu@{TS}]" in txt
    assert "cost=0.50ms" in txt and "segment=2.00ms" in txt
    # a calibration that is not active changes nothing
    txt2 = sess.explain()
    assert "[grouped-segment]" in txt2 and "[heuristic]" in txt2
    assert "cost=1024" in txt2


def test_calibration_partial_coverage_falls_back():
    cal = _cal({"grouped-masked": {"generic": [
        {"rows": 512, "groups": 4, "seconds": 1e-6}]}})
    with tcal.use(cal):
        m, costs, src = select_grouped_method(512, 4, segment_ok=True)
    assert m == "segment" and src == {"kind": "heuristic"}
    assert costs["segment"] == 1024


def test_calibration_bucket_interpolation():
    cal = tcal.Calibration(
        backend="cpu", timestamp="t", kernels={}, grouped_block=[
            {"rows": 1024, "groups": 4, "block": 256},
            {"rows": 1 << 20, "groups": 4, "block": 4096}],
        engines={"local": {"generic": [
            {"rows": 1000, "seconds": 1.0},
            {"rows": 1_000_000, "seconds": 50.0}]}})
    assert cal.engine_seconds("local", "generic", 2000) == 2.0
    assert cal.engine_seconds("local", "generic", 500_000) == 25.0
    assert cal.engine_seconds("local", "xtx", 1000) == 1.0
    assert cal.engine_seconds("sharded", "generic", 1000) is None
    assert cal.grouped_block_size(2048, 4) == 256
    assert cal.grouped_block_size(1 << 19, 4) == 4096


def test_calibration_drives_segment_block_size():
    heur = segment_block_size(10_000, 10)
    cal = _cal({}, grouped_block=[{"rows": 10_000, "groups": 10,
                                   "block": 512}])
    with tcal.use(cal):
        assert segment_block_size(10_000, 10) == 512
        assert segment_block_size(10_000, 10, 64) == 64
    assert segment_block_size(10_000, 10) == heur


# -- one calibration, both packages -------------------------------------------

def _synthetic(full: bool) -> dict:
    """Measured tables that contradict the heuristic in some buckets;
    ``full=False`` leaves out the segment engine (heuristic costs, but the
    measured blocks still size the segment layout)."""
    def cells(seg, masked):
        return {"xtx": [{"rows": N, "groups": GROUPS, "seconds": seg[0]},
                        {"rows": 64 * N, "groups": 64, "seconds": seg[1]}],
                "sketch": [{"rows": N, "groups": GROUPS,
                            "seconds": masked[0]}],
                "generic": [{"rows": N, "groups": GROUPS,
                             "seconds": masked[1]}]}
    engines = {
        "local": {"generic": [{"rows": N, "seconds": 3.0e-4}],
                  "xtx": [{"rows": N, "seconds": 4.5e-4},
                          {"rows": 100 * N, "seconds": 2.5}]},
        "grouped-masked": cells((9.0e-4, 0.7), (2.0e-4, 1.5e-3)),
    }
    if full:
        engines["grouped-segment"] = cells((2.5e-3, 0.3), (1.0e-3, 1.0e-3))
    return {"backend": "cuda", "timestamp": TS, "engines": engines,
            "kernels": {},
            "grouped_block": [
                {"rows": N, "groups": GROUPS, "block": 64},
                {"rows": 64 * N, "groups": 64, "block": 1024}]}


CASES = ["kernel-impls", "grouped-fit-shares-sort", "joins", "two-keys"]


@pytest.mark.parametrize("full", [True, False], ids=["measured", "partial"])
@pytest.mark.parametrize("case", CASES)
def test_explain_equals_the_reference_under_one_calibration(tables, case,
                                                            full):
    table, jtable = tables
    d = _synthetic(full)
    with tcal.use(tcal.Calibration.from_dict(d)), \
            jcal.use(jcal.Calibration.from_dict(d)):
        got, want = _batch("t", table, case), _batch("j", jtable, case)
    assert got == want
    grouped = [ln for ln in got.splitlines() if "grouped-scan [" in ln]
    assert grouped and all(("[measured cuda@" in ln) == full
                           for ln in grouped), got


@pytest.mark.parametrize("full", [True, False], ids=["measured", "partial"])
def test_choices_and_blocks_equal_the_reference(full):
    d = _synthetic(full)
    grid = [(N, GROUPS), (64 * N, 64), (10 * N, 8), (N // 2, 2),
            (1 << 20, 1024)]
    with tcal.use(tcal.Calibration.from_dict(d)), \
            jcal.use(jcal.Calibration.from_dict(d)):
        for rows, groups in grid:
            assert segment_block_size(rows, groups) == jblock(rows, groups)
            for cls in ("xtx", "sketch", "generic"):
                for ok in (True, False):
                    got = select_grouped_method(rows, groups, segment_ok=ok,
                                                agg_cls=cls)
                    want = jplan.select_grouped_method(
                        rows, groups, segment_ok=ok, agg_cls=cls)
                    assert got == want, (rows, groups, cls, ok)


# -- files and activation -----------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_file_written_by_either_package_loads_in_the_other(tmp_path,
                                                             writer):
    d = _synthetic(True)
    path = str(tmp_path / "cal.json")
    if writer == "port":
        tcal.save(tcal.Calibration.from_dict(d), path,
                  extra={"device": "NVIDIA H100 80GB HBM3, 700.00 W"})
        got = jcal.load(path)
    else:
        jcal.save(jcal.Calibration.from_dict(d), path)
        got = tcal.load(path)
    assert got.to_dict() == d
    assert got.source == path
    other = tcal if writer == "reference" else jcal
    assert got.engine_seconds("grouped-segment", "xtx", 3 * N, GROUPS) == \
        other.Calibration.from_dict(d).engine_seconds(
            "grouped-segment", "xtx", 3 * N, GROUPS)


def test_environment_variable_activates_and_nothing_else_does(tmp_path,
                                                              monkeypatch):
    path = str(tmp_path / "env.json")
    tcal.save(tcal.Calibration.from_dict(_synthetic(True)), path)
    monkeypatch.delenv("MADJAX_CALIBRATION", raising=False)
    assert tcal.current() is None          # a file on disk changes nothing
    monkeypatch.setenv("MADJAX_CALIBRATION", path)
    monkeypatch.setattr(tcal, "_ENV_CACHE", {})
    assert tcal.current().timestamp == TS
    assert tcal.kernel_param("xtx", "tile_n", 7) == 7


def test_harness_tiny_on_the_cpu_writes_a_calibration_that_flips_explain(
        tables, tmp_path):
    out = tmp_path / "cpu.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("MADJAX_CALIBRATION", None)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.calibrate", "--tiny",
         "--device", "cpu", "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    doc = json.loads(out.read_text())
    assert doc["backend"] == "cpu" and doc["kernels"] == {}
    assert doc["device"] == "cpu" and "not applicable" in doc["hlo_context"]
    for cal in (tcal.load(str(out)), jcal.load(str(out))):
        assert {"local", "grouped-segment", "grouped-masked"} <= \
            set(cal.engines)
        for engine in cal.engines.values():
            assert {"xtx", "sketch", "generic"} <= set(engine)
    (blk,) = doc["grouped_block"]
    assert blk["block"] in (64, 256) and set(blk["sweep"]) == {"64", "256"}
    assert blk["heuristic_block"] == segment_block_size(4096, 8)
    table, _ = tables
    sess = Session()
    sess.grouped_scan(_cm(), table, "g", num_groups=GROUPS,
                      columns=("item",))
    sess.linregr(table)
    assert "[measured" not in sess.explain()
    with tcal.use(str(out)):
        txt = sess.explain()
    assert txt.count(f"[measured cpu@{doc['timestamp']}]") == 2, txt
