"""Fault tolerance and straggler mitigation (counterpart of the reference
package's ``distributed/fault_tolerance.py``; the logic is independent
of the hardware, and the launcher wires it to real signals).

* :class:`HeartbeatMonitor`: per-host liveness by missed beats, on an
  injectable clock; a host that misses ``max_missed`` intervals is dead.
* :func:`plan_elastic_mesh`: the largest (pod, data, model) mesh for the
  surviving devices that keeps the model-parallel degree (the weights
  must still fit), or None (halt and restart from a checkpoint).  With
  ``checkpoint.restore(..., shardings=)`` onto the new mesh this is
  checkpoint-restart elasticity.
* :class:`StragglerMitigator`: an exponential moving average of each
  host's step time, flagging hosts persistently slower than the fleet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class HostState:
    last_beat: float
    missed: int = 0
    alive: bool = True


class HeartbeatMonitor:
    """Liveness of ``hosts``: :meth:`beat` records a host's heartbeat at
    ``clock()``; :meth:`sweep` marks dead every live host whose last beat
    is ``max_missed`` or more ``interval``s old."""

    def __init__(self, hosts: list[str], *, interval: float = 10.0,
                 max_missed: int = 3, clock: Callable[[], float] = time.time):
        self.interval = interval
        self.max_missed = max_missed
        self.clock = clock
        now = clock()
        self.hosts = {h: HostState(last_beat=now) for h in hosts}

    def beat(self, host: str):
        st = self.hosts[host]
        st.last_beat = self.clock()
        st.missed = 0
        st.alive = True

    def sweep(self) -> list[str]:
        """Advance the failure detector; returns the newly dead hosts."""
        now = self.clock()
        dead = []
        for h, st in self.hosts.items():
            if not st.alive:
                continue
            st.missed = int((now - st.last_beat) // self.interval)
            if st.missed >= self.max_missed:
                st.alive = False
                dead.append(h)
        return dead

    @property
    def alive_hosts(self) -> list[str]:
        return [h for h, st in self.hosts.items() if st.alive]


def plan_elastic_mesh(n_devices: int, *, model_parallel: int,
                      pods: int = 1) -> tuple[int, ...] | None:
    """The largest (pod, data, model) mesh of ``n_devices`` that keeps
    ``model_parallel``; None where not even one model group fits."""
    if n_devices < model_parallel:
        return None
    for p in range(min(pods, n_devices // model_parallel), 0, -1):
        data = n_devices // p // model_parallel
        if data >= 1:
            return (p, data, model_parallel)
    return None


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
