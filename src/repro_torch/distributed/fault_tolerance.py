"""Straggler detection (counterpart of ``StragglerMitigator`` in the
reference package's ``distributed/fault_tolerance.py``; the heartbeat
monitor and the elastic mesh plan are ROADMAP Queue 1 item 13b)."""

from __future__ import annotations

import numpy as np


class StragglerMitigator:
    """An exponential moving average of each host's step time; a host
    whose average exceeds ``threshold`` x the fleet median on ``patience``
    consecutive checks is a straggler."""

    def __init__(self, hosts: list[str], *, threshold: float = 1.5,
                 patience: int = 5, alpha: float = 0.2):
        self.ema = {h: None for h in hosts}
        self.flags = {h: 0 for h in hosts}
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha

    def record(self, host: str, step_time: float):
        prev = self.ema[host]
        self.ema[host] = (step_time if prev is None
                          else (1 - self.alpha) * prev
                          + self.alpha * step_time)

    def stragglers(self) -> list[str]:
        """Hosts persistently slower than threshold × fleet median."""
        vals = [v for v in self.ema.values() if v is not None]
        if len(vals) < 2:
            return []
        med = float(np.median(vals))
        out = []
        for h, v in self.ema.items():
            if v is not None and v > self.threshold * med:
                self.flags[h] += 1
                if self.flags[h] >= self.patience:
                    out.append(h)
            else:
                self.flags[h] = 0
        return out
