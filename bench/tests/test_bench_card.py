"""On the card: a short run of each cell comes out correct with the
full result line, and the control (the reference in
TF32, at the cell's size) does not."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _run(*args):
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.strip().splitlines()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    _need_card()
    out = json.loads(_run("--workload", cell, "--seed", str(2 ** 31 + 11),
                          "--seconds", "2", "--trace", "0")[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert "setup_s" in out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    _need_card()
    for line in _run("--workload", cell, "--control", "--check-seeds",
                     "5,6,7"):
        checks = json.loads(line)["checks"]
        assert any(v > lim for v, lim in checks.values()), checks
