"""``repro_torch.launch.analytics_serve`` against
``repro.launch.analytics_serve`` at a small size, on the CPU.

The demo loop's per-round telemetry (physical scans, cache hits, dedup,
scans saved) comes from the trace; with ``drain="demand"`` it must equal
the reference's.  With one session the whole line is deterministic and
equal.  With several, analyst threads race the shared window, so which
statements are deduplicated and which are answered from the cache
varies from run to run in both packages; their sum, the scans and the
scans saved do not, and must be equal.
"""

import re

import pytest

from repro.launch.analytics_serve import serve_analytics as jserve
from repro_torch.launch.analytics_serve import main, serve_analytics

ROUND = re.compile(r"round (\d+): \d+ sessions x 4 statements \| scans=(\d+) "
                   r"cache_hits=(\d+) deduped=(\d+) scans_saved=(\d+) \|")
RACE_FREE = ("submitted", "planned", "scans_saved", "evicted", "view_hits",
             "cache_evicted", "cache_rejected", "drain_errors")


def _rounds(text: str) -> list:
    return [tuple(int(v) for v in m.groups()) for m in ROUND.finditer(text)]


def _run(fn, capsys, **kw):
    stats = fn(rows=600, dims=3, rounds=4, window_size=64, seed=3, **kw)
    return stats, _rounds(capsys.readouterr().out)


@pytest.mark.parametrize("sessions", [1, 3])
def test_demand_telemetry_equals_the_reference(capsys, sessions):
    got, got_rounds = _run(serve_analytics, capsys, sessions=sessions,
                           device="cpu")
    want, want_rounds = _run(jserve, capsys, sessions=sessions)
    assert len(got_rounds) == len(want_rounds) == 4
    if sessions == 1:
        assert got_rounds == want_rounds
        assert got == want
        return
    for g, w in zip(got_rounds, want_rounds):
        # round, scans, cache hits + deduped, scans saved
        assert (g[0], g[1], g[2] + g[3], g[4]) == (w[0], w[1], w[2] + w[3],
                                                   w[4])
    assert {k: got[k] for k in RACE_FREE} == {k: want[k] for k in RACE_FREE}
    assert (got["cache_hits"] + got["deduped"]
            == want["cache_hits"] + want["deduped"])


def test_thread_drain_answers_every_round(capsys):
    stats, rounds = _run(serve_analytics, capsys, sessions=2,
                         drain="thread", window_timeout=0.02, device="cpu")
    assert len(rounds) == 4 and stats["drain_errors"] == 0
    # rounds 1 and 3 follow an unchanged table: answered without a scan
    assert rounds[1][1] == 0 and rounds[3][1] == 0
    assert stats["submitted"] == 2 * 4 * 4


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["analytics_serve", "--rows", "64"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main()


def test_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "analytics_serve", "--rows", "300", "--dims", "2", "--sessions",
        "2", "--rounds", "2", "--device", "cpu"])
    main()
    out = capsys.readouterr().out
    assert len(_rounds(out)) == 2 and "lifetime:" in out
