"""Nothing under bench/ imports JAX or the JAX package ``repro``: module
names are compared by their whole top-level name (the part before the
first dot), since the port's own name, ``repro_torch``, begins with
``repro``."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
sys.path.insert(0, str(BENCH))


def _imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        bad = _imported(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_whole_name_is_compared():
    from harness.core import FORBIDDEN as HARNESS_FORBIDDEN
    assert set(HARNESS_FORBIDDEN) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in _imported(f), f


def test_a_run_loads_neither(tmp_path):
    """A whole run on the CPU at a tiny size, in a process of its own,
    leaves no module of JAX or of the JAX package loaded."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}]\n"
        "from harness.core import run_cell, forbidden_modules\n"
        "out = run_cell('fig4-k320.profile', 3, 0.3, False,\n"
        "               device='cpu', rows=4096)\n"
        "assert out['correct'], out\n"
        "print('loaded:', forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "loaded: []"


def test_run_exits_without_a_result_when_the_card_is_missing(tmp_path):
    """The CLI on a machine without a card: exit code 2, no result line.
    (On a machine with a card the test has nothing to check.)"""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "fig4-k320.linregr", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert res.returncode == 2
    assert res.stdout.strip() == ""


def test_run_exits_without_a_result_beside_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and bench/, with no
    program beside them, a run fails and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "fig4-k320.linregr",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
