"""The one traffic generator: a closed-loop analyst, driven by a mix file.

A mix (``mixes/<name>.json``) gives:

* ``round``: the statements of one round, each ``{"statement": <name of
  a file in statements/>, "args": {...}}``, issued one after the other;
* ``warmup_rounds``: rounds run before the window.

The loop is closed: the analyst waits for each answer before issuing
the next statement.  A statement's latency runs from its submission to
its answer, after ``torch.cuda.synchronize()``.  Rounds start until the
window's seconds are up; the last one runs to its end.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass
class Record:
    """One statement: when it was submitted and answered (host clock,
    seconds from the window's start), and its answer or its error."""

    statement: str
    index: int                  # position in the round
    submitted: float
    answered: float | None = None
    answer: Any = None
    error: str | None = None

    @property
    def latency(self) -> float:
        return self.answered - self.submitted


@dataclass
class Window:
    records: list = field(default_factory=list)
    seconds: float = 0.0        # from the window's start to its last answer


class ClosedLoop:
    """Runs a mix against one table."""

    def __init__(self, mix: dict, table, statements: dict, device):
        self.mix = mix
        self.table = table
        self.statements = statements
        self.device = torch.device(device)
        self.round = mix["round"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run_round(self, t0: float) -> list:
        """One round; returns its records."""
        recs = []
        for i, spec in enumerate(self.round):
            st = self.statements[spec["statement"]]
            rec = Record(spec["statement"], i, time.perf_counter() - t0)
            recs.append(rec)
            try:
                with torch.profiler.record_function(
                        f"statement {spec['statement']}"):
                    rec.answer = st.call(self.table, spec.get("args", {}))
                self._sync()
            except Exception as e:  # counted as failed
                rec.error = repr(e)
            rec.answered = time.perf_counter() - t0
        return recs

    def warm_up(self) -> None:
        """``warmup_rounds`` rounds, each statement of the mix at the
        table's shapes."""
        t0 = time.perf_counter()
        for _ in range(int(self.mix.get("warmup_rounds", 1))):
            bad = [r for r in self.run_round(t0) if r.error is not None]
            if bad:
                raise RuntimeError(f"warm-up statement {bad[0].statement} "
                                   f"failed: {bad[0].error}")

    def run_window(self, seconds: float) -> Window:
        """Rounds until ``seconds`` have passed since the window opened."""
        win = Window()
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            win.records.extend(self.run_round(t0))
        self._sync()
        win.seconds = time.perf_counter() - t0
        return win
