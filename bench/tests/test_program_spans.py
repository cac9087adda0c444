"""``harness/program_spans.py`` on synthetic intervals: the device's idle
gaps split by the innermost program span over each part of them."""

from __future__ import annotations

import random
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from harness.program_spans import (  # noqa: E402
    PARTS, idle_by_layer, idle_ms_per_stmt, innermost, last_split,
    split_gaps,
)


class FakeTrace:
    """What ``idle_by_layer`` reads of a ``DeviceTrace``: host operations
    ``(start, end, name)`` and merged device intervals, in microseconds."""

    def __init__(self, host, busy):
        self._host = sorted(host)
        self.busy = [list(b) for b in busy]


class FakeCtx:
    def __init__(self, trace, answered: int):
        self.trace = trace
        self.answered = [object()] * answered


def _split(host, busy):
    out = idle_by_layer(FakeTrace(host, busy))
    return {k: round(v * 1e6, 9) for k, v in out.items()}


# name -> (host operations, device intervals, expected µs per part)
CASES = {
    # one gap (10, 20) inside final, inside statement
    "nested_innermost_wins": (
        [(0, 100, "madlib::statement"), (5, 30, "madlib::final"),
         (12, 14, "aten::any")],
        [(0, 10), (20, 40)],
        {"plan": 0, "fold": 0, "final": 10, "outside": 0}),
    # gap (10, 50): fold to 25, then plan (statement alone) to 30, then
    # final to 50
    "gap_straddles_two_spans": (
        [(0, 100, "madlib::statement"), (2, 25, "madlib::fold"),
         (20, 24, "madlib::dispatch"), (30, 60, "madlib::final")],
        [(0, 10), (50, 100)],
        {"plan": 5, "fold": 15, "final": 20, "outside": 0}),
    # gaps (10, 20) under no span, (30, 40) half under plan
    "gaps_under_no_span_are_outside": (
        [(35, 60, "madlib::plan"), (0, 100, "statement linregr")],
        [(0, 10), (20, 30), (40, 50)],
        {"plan": 5, "fold": 0, "final": 0, "outside": 15}),
    # dispatch inside fold counts to fold; the gap runs past both
    "dispatch_counts_to_fold": (
        [(0, 50, "madlib::statement"), (10, 40, "madlib::fold"),
         (15, 35, "madlib::dispatch")],
        [(0, 12), (60, 70)],
        {"plan": 10, "fold": 28, "final": 0, "outside": 10}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gaps_split_by_the_innermost_span(case):
    host, busy, want = CASES[case]
    got = _split(host, busy)
    assert got == {k: float(v) for k, v in want.items()}


def test_more_than_5000_gaps_are_all_counted():
    # 12,000 statements: each a statement span over (10 i, 10 i + 8) with
    # a fold over its first half; the device is busy for 1 µs from 10 i +
    # 1 and from 10 i + 6.  The gap inside a statement is 2 µs under fold
    # and 2 under plan (the statement alone); the gap to the next one is
    # 1 µs under plan, 2 outside and 1 under the next fold
    n = 12_000
    host, busy = [], []
    for i in range(n):
        t = 10 * i
        host += [(t, t + 8, "madlib::statement"),
                 (t, t + 4, "madlib::fold")]
        busy += [(t + 1, t + 2), (t + 6, t + 7)]
    got = _split(host, busy)
    assert got["fold"] == pytest.approx(2 * n + (n - 1))
    assert got["plan"] == pytest.approx(2 * n + (n - 1))
    assert got["final"] == 0
    assert got["outside"] == pytest.approx(2 * (n - 1))
    gaps = sum(b[0] - a[1] for a, b in zip(busy, busy[1:]))
    assert sum(got.values()) == pytest.approx(gaps)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_parts_sum_to_the_total_gap_length(seed):
    rng = random.Random(seed)
    host = []
    for _ in range(300):
        # properly nested per statement, as one thread's spans are
        t = rng.uniform(0, 10_000)
        host.append((t, t + 20, "madlib::statement"))
        host.append((t + 1, t + 3, "madlib::plan"))
        host.append((t + 4, t + 12, "madlib::fold"))
        host.append((t + 5, t + 9, "madlib::dispatch"))
        host.append((t + 13, t + 19, "madlib::final"))
        host.append((t + 14, t + 15, "aten::mm"))
    busy, t = [], 0.0
    while t < 10_000:
        a = t + rng.expovariate(0.5)
        b = a + rng.expovariate(0.2)
        busy.append((a, b))
        t = b
    got = idle_by_layer(FakeTrace(host, busy))
    gaps = sum(b[0] - a[1] for a, b in zip(busy, busy[1:])) / 1e6
    assert set(got) == set(PARTS)
    assert sum(got.values()) == pytest.approx(gaps, rel=1e-9)
    assert all(v >= 0 for v in got.values())
    assert got["plan"] > 0 and got["fold"] > 0 and got["final"] > 0


def test_innermost_takes_the_latest_started_open_span():
    pieces = innermost([(0, 10, "plan"), (2, 6, "fold"), (4, 8, "final")])
    assert pieces == [(0, 2, "plan"), (2, 4, "fold"), (4, 8, "final"),
                      (8, 10, "plan")]
    assert split_gaps([(1, 9)], pieces) == {
        "plan": 2, "fold": 2, "final": 4, "outside": 0}


def test_no_program_span_reads_nothing():
    trace = FakeTrace([(0, 100, "statement linregr"), (5, 6, "aten::mm")],
                      [(0, 10), (20, 30)])
    assert idle_by_layer(trace) is None
    assert idle_ms_per_stmt(FakeCtx(trace, 10), "plan") is None
    assert idle_ms_per_stmt(FakeCtx(None, 10), "plan") is None


def test_ms_per_statement():
    host, busy, _ = CASES["gap_straddles_two_spans"]
    ctx = FakeCtx(FakeTrace(host, busy), 4)
    # 15 µs under fold over 4 statements
    assert idle_ms_per_stmt(ctx, "fold") == pytest.approx(15e-3 / 4)
    assert idle_ms_per_stmt(FakeCtx(ctx.trace, 0), "fold") is None


def test_a_trace_is_split_once(monkeypatch):
    from harness import program_spans
    host, busy, _ = CASES["gap_straddles_two_spans"]
    ctx = FakeCtx(FakeTrace(host, busy), 4)
    calls = []
    real = program_spans.split_gaps
    monkeypatch.setattr(program_spans, "split_gaps",
                        lambda *a: calls.append(1) or real(*a))
    reads = [idle_ms_per_stmt(ctx, part) for part in ("plan", "fold",
                                                      "final")]
    assert len(calls) == 1
    assert reads == pytest.approx([5e-3 / 4, 15e-3 / 4, 20e-3 / 4])
    split, gaps = last_split()
    assert gaps == 1 and split == idle_by_layer(ctx.trace)
    # another trace is split anew
    other = FakeTrace(host, [(0, 10), (50, 60), (70, 100)])
    assert idle_by_layer(other)["outside"] == pytest.approx(0.0)
    assert len(calls) == 2 and last_split()[1] == 2


def test_the_program_ranges_reach_the_harness_trace():
    """A CPU profile of a program statement: the harness's trace holds
    the program's ranges among its host operations (no device interval,
    so no gap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness.tracing import DeviceTrace
    from repro_torch.core import Table
    from repro_torch.methods.linregr import linregr

    g = torch.Generator().manual_seed(7)
    t = Table({"x": torch.randn(256, 3, generator=g),
               "y": torch.randn(256, generator=g)})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        linregr(t, use_kernel=True)
    trace = DeviceTrace(prof, 1.0)
    names = {n for _, _, n in trace._host if n.startswith("madlib::")}
    assert names == {"madlib::statement", "madlib::plan", "madlib::fold",
                     "madlib::dispatch", "madlib::final"}
    assert not any(n.startswith("madlib::") for n, _, _ in trace.device_ops)
    assert idle_by_layer(trace) == dict.fromkeys(PARTS, 0.0)
