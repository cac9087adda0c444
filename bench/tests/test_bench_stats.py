"""The rate and the percentile are taken over every statement of the
window, not over medians or percentiles of chunks of it."""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness.core import Context, load_module  # noqa: E402
from harness.loop import Record, Window  # noqa: E402
from harness.stats import percentile  # noqa: E402


def _window(latencies, seconds):
    win = Window(seconds=seconds)
    t = 0.0
    for i, lat in enumerate(latencies):
        win.records.append(Record("linregr", 0, t, t + lat,
                                  answer=object()))
        t += lat
    ctx = Context("cpu")
    ctx.window = win
    ctx.answered = list(win.records)
    return ctx


def test_p95_is_over_all_statements():
    # a slow tail in one chunk: chunked p95s, or their median, hide it
    lat = [0.010] * 190 + [0.500] * 10
    ctx = _window(lat, sum(lat))
    got = load_module("metrics", "stmt_p95_ms").read(ctx)
    want = statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
    assert got == want
    chunks = [lat[i:i + 20] for i in range(0, len(lat), 20)]
    chunked = statistics.median(
        statistics.quantiles(c, n=100, method="inclusive")[94]
        for c in chunks) * 1e3
    assert chunked == 10.0 and got > 10.0


def test_percentile_of_a_known_list():
    assert percentile(range(1, 102), 95) == 96.0
    assert percentile([3.0], 95) == 3.0
    assert percentile([], 95) is None


def test_rate_is_statements_over_the_whole_window():
    lat = [0.1, 0.1, 0.5, 0.1]
    ctx = _window(lat, 2.0)            # window longer than the work
    rate = load_module("metrics", "stmts_per_s").read(ctx)
    assert rate == len(lat) / 2.0
    ctx.answered = ctx.answered[:3]    # a failed statement is not answered
    assert load_module("metrics", "stmts_per_s").read(ctx) == 3 / 2.0


def test_setup_metric_reads_the_context():
    ctx = _window([0.1], 0.1)
    ctx.setup_s = 12.5
    assert load_module("metrics", "setup_s").read(ctx) == 12.5
