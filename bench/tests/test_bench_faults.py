"""The comparison that decides ``correct``, shown to fail.

On the CPU, at a size a test run holds, each cell is run through the
harness with its chip check skipped and the timed path broken
underneath, once for each fault the cell can have: a step that returns
its state unchanged, half of the batch left out with the sums taken
over the rest and doubled, and an answer altered where it is produced.
There is one card, so no exchange between chips to leave out.  Each must come out
not correct.  The control (the reference computed in TF32, in the
program's place) must come out not correct too."""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness.core import run_cell, run_control  # noqa: E402

# rows a test run holds
ROWS = 6000
CELLS = ("fig4-k320.linregr", "fig4-k160.linregr", "fig4-k320.profile")


@contextlib.contextmanager
def _kernel(name, wrap):
    """Registry kernel ``name`` with its plain version wrapped."""
    from repro_torch.kernels import registry
    entry = registry.get(name)
    registry.register(name, ref=wrap(entry.ref), cuda=entry.cuda,
                      cost=entry.cost, overwrite=True)
    try:
        yield
    finally:
        registry.register(name, ref=entry.ref, cuda=entry.cuda,
                          cost=entry.cost, overwrite=True)


def _halve(fn):
    """The kernel over every other row, its sums doubled."""
    def half(x, y, *a, **k):
        out = fn(x[::2], y[::2], *a, **k)
        return tuple(2 * t for t in out)
    return half


def _scale_xtx(fn):
    """One entry of the kernel's answer, the first diagonal of X^T X, off
    by 1%."""
    def altered(x, y, *a, **k):
        xtx, xty = fn(x, y, *a, **k)
        xtx = xtx.clone()
        xtx[0, 0] *= 1.01
        return xtx, xty
    return altered


def _faults(cell):
    from repro_torch.core.templates import ProfileAggregate
    from repro_torch.methods.linregr import LinregrAggregate

    def unchanged(self, state, block, mask):
        return state

    def half_profile(orig):
        def f(self, state, block, mask):
            m = mask.clone()
            m[1::2] = False
            new = orig(self, state, block, m)
            return {c: {k: (2 * v - st[k] if k in ("count", "sum", "sumsq")
                            else v) for k, v in d.items()}
                    for (c, d), st in zip(new.items(), state.values())}
        return f

    def max_altered(orig):
        """One column's maximum off by one ulp."""
        def f(self, state):
            out = orig(self, state)
            col = out[sorted(out)[0]]
            col["max"] = torch.nextafter(col["max"],
                                         torch.full_like(col["max"],
                                                         float("inf")))
            return out
        return f

    if cell.endswith(".linregr"):
        yield "state unchanged", mock.patch.object(
            LinregrAggregate, "transition", unchanged)
        yield "half the batch", _kernel("xtx", _halve)
        yield "answer altered", _kernel("xtx", _scale_xtx)
    if cell.endswith(".profile"):
        yield "state unchanged", mock.patch.object(
            ProfileAggregate, "transition", unchanged)
        yield "half the batch", mock.patch.object(
            ProfileAggregate, "transition",
            half_profile(ProfileAggregate.transition))
        yield "answer altered", mock.patch.object(
            ProfileAggregate, "final", max_altered(ProfileAggregate.final))


CASES = [(cell, name) for cell in CELLS
         for name, _ in _faults(cell)]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_cell(cell, 7, 0.3, False, device="cpu", rows=ROWS)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_makes_the_run_not_correct(cell, fault):
    patch = dict(_faults(cell))[fault]
    with patch:
        out = run_cell(cell, 7, 0.3, False, device="cpu", rows=ROWS)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    for seed in (1, 2, 3):
        checks, _ = run_control(cell, seed, device="cpu", rows=ROWS)
        assert any(v > lim for v, lim in checks.values()), (seed, checks)
