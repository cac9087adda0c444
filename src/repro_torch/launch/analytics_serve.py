"""Analytics serving front end: a multi-session demo loop over
:class:`~repro_torch.core.AnalyticsServer`.

``python -m repro_torch.launch.analytics_serve`` stands up one server and
N simulated analyst sessions issuing rounds of same-table statements
(profile / linregr / Count-Min / FM) from concurrent threads, with an
append-ingest cadence racing the admission window.  It prints per-round
serving telemetry (statements, physical scans, dedup and cache-hit
counts, scans saved) from the server's trace events: many analysts, one
scan.  ``--drain thread`` switches to the background drainer, with the
analyst threads waiting passively on their handles.

The demo table (``x``, ``y``, ``item`` as in the reference) is made on
``--device`` from ``--seed``: the card unless ``--device cpu``.  The
port's counterpart of ``repro.launch.analytics_serve``.
"""

from __future__ import annotations

import argparse
import threading
import time

import torch

from ..core import AnalyticsServer, Session, Table, trace_execution
from ..device import resolve_device


def _make_table(rows: int, dims: int, seed: int, device) -> Table:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    x = torch.randn((rows, dims), generator=gen, device=dev)
    b = torch.randn((dims,), generator=gen, device=dev)
    y = x @ b + 0.1 * torch.randn((rows,), generator=gen, device=dev)
    item = torch.randint(0, 1000, (rows,), generator=gen, dtype=torch.int32,
                         device=dev)
    return Table({"x": x, "y": y, "item": item})


def _analyst_round(session: Session, table: Table,
                   passive: bool = False) -> list:
    hs = [session.profile(table), session.linregr(table),
          session.countmin_sketch(table), session.fm_distinct_count(table)]
    if passive:
        # drain="thread": wait for the background drainer to fire the
        # window; run() then only gathers resolved handles
        for h in hs:
            if hasattr(h, "wait") and not h.wait(60):
                raise RuntimeError("background drainer never fired")
    return session.run()


def serve_analytics(*, rows: int = 100_000, dims: int = 8,
                    sessions: int = 8, rounds: int = 4,
                    window_size: int = 64, drain: str = "demand",
                    window_timeout: float | None = None,
                    append_every: int = 2, seed: int = 0,
                    device=None) -> dict:
    """Run the demo loop; returns the final server stats dict."""
    table = _make_table(rows, dims, seed, device)
    dev = table.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 1)
    if drain == "thread" and window_timeout is None:
        window_timeout = 0.01
    server = AnalyticsServer(window_size=window_size, drain=drain,
                             window_timeout=window_timeout)
    pool = [Session(server=server) for _ in range(sessions)]
    passive = drain == "thread"
    try:
        for rnd in range(rounds):
            if append_every and rnd and rnd % append_every == 0:
                m = max(1, rows // 200)
                table.append({
                    "x": torch.randn((m, dims), generator=gen, device=dev),
                    "y": torch.randn((m,), generator=gen, device=dev),
                    "item": torch.randint(0, 1000, (m,), generator=gen,
                                          dtype=torch.int32, device=dev)})
                print(f"round {rnd}: ingest +{m} rows -> cache evicted "
                      f"(total {server.stats['evicted']})")
            results: list = [None] * sessions
            with trace_execution() as t:
                t0 = time.perf_counter()
                threads = [threading.Thread(
                    target=lambda i=i: results.__setitem__(
                        i, _analyst_round(pool[i], table, passive)))
                    for i in range(sessions)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
            if any(r is None for r in results):
                raise RuntimeError(f"round {rnd}: an analyst thread failed")
            summ = t.summary()
            stmts = sessions * 4
            print(f"round {rnd}: {sessions} sessions x 4 statements | "
                  f"scans={summ.get('scan', 0)} "
                  f"cache_hits={summ.get('cache_hit', 0)} "
                  f"deduped={summ.get('deduped', 0)} "
                  f"scans_saved={summ.get('scans_saved', 0)} | "
                  f"{stmts / dt:.0f} stmts/s")
        stats = dict(server.stats)
    finally:
        server.close()
    print(f"lifetime: {stats}")
    return stats


def main():
    ap = argparse.ArgumentParser(
        description="analytics serving demo: N sessions, one scan")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--dims", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--window-size", type=int, default=64)
    ap.add_argument("--drain", choices=("demand", "thread"),
                    default="demand",
                    help="'thread' = background drainer; analysts wait "
                         "passively instead of flushing")
    ap.add_argument("--window-timeout", type=float, default=None,
                    help="window age (s) that auto-drains; defaults to "
                         "0.01 with --drain=thread")
    ap.add_argument("--append-every", type=int, default=2,
                    help="ingest a delta every K rounds (0 = never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the table lives and the scans run: the "
                         "card by default, 'cpu' for the plain versions")
    args = ap.parse_args()
    serve_analytics(rows=args.rows, dims=args.dims,
                    sessions=args.sessions, rounds=args.rounds,
                    window_size=args.window_size, drain=args.drain,
                    window_timeout=args.window_timeout,
                    append_every=args.append_every, seed=args.seed,
                    device=args.device)


if __name__ == "__main__":
    main()
