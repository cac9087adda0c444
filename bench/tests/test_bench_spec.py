"""BENCHMARK.json against the format it must keep, and every file a
cell names found by its name."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness.core import load_module, metric_reader, resolve  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word


def test_names_units_and_lines_use_the_allowed_characters():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert all(NAME.match(n) for n in names), names
        assert len(names) == len(set(names))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"])
    for c in SPEC["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)


def test_entries_have_only_the_allowed_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        for entry in SPEC[group]:
            assert set(entry) <= keys, (group, entry["name"])
            assert keys - {"workloads"} <= set(entry), (group, entry["name"])


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    cells = [w["name"] for w in SPEC["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_config_mix_statement_and_metric_files_are_found_by_name(cell):
    entry, config, mix = resolve(SPEC, cell)
    cfg = {c["name"]: c for c in SPEC["configs"]}[entry["config"]]
    assert (ROOT / cfg["file"]).is_file()
    assert cfg["file"].startswith("bench/")
    assert config["name"] == entry["config"]
    for name, col in config["columns"].items():
        assert (BENCH / "columns" / f"{col['generator']}.py").is_file(), name
    assert (BENCH / "mixes" / f"{entry['traffic']}.json").is_file()
    for s in mix["round"]:
        st = load_module("statements", s["statement"])
        for fn in ("call", "reference", "compare"):
            assert callable(getattr(st, fn))
        assert all(v is None or v >= 0 for v in st.LIMITS.values())
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            if cell in m.get("workloads", [cell]):
                assert callable(metric_reader(m["name"]).read)


def test_each_config_is_used_and_has_a_file_of_its_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_file_names_under_paths_use_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
