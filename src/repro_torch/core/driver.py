"""Driver functions for multipass iteration — MADlib §3.1.2.

The port's counterpart of the reference ``core/driver.py``: helpers for
step-function-shaped iteration that has no table scan at all —
``step: state -> state`` plus a convergence metric.  PyTorch runs
eagerly, so all three are host loops over ``step``:

* :func:`host_driver`    — one scalar (the metric) pulled per round;
* :func:`device_driver`  — the same loop (the reference fuses it into one
  ``lax.while_loop``; a CUDA-graph body would be the counterpart here);
* :func:`counted_driver` — a fixed number of rounds.

Anything that scans a table each round should instead register an
:class:`repro_torch.core.iterative.IterativeTask` and call
:func:`repro_torch.core.iterative.fit`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import torch

from ..tree import tree_map

S = TypeVar("S")

StepFn = Callable[[S], S]                   # state -> state
MetricFn = Callable[[S, S], torch.Tensor]   # (prev, new) -> scalar metric


@dataclasses.dataclass
class IterationResult:
    state: Any
    n_iters: int
    converged: bool
    metric_trace: list


def _copy(state):
    """A private copy of the caller's state, so a ``step`` that updates in
    place never touches the caller's tensors."""
    return tree_map(lambda v: torch.as_tensor(v).clone(), state)


def host_driver(step: StepFn, init_state: S, *, metric: MetricFn,
                tol: float, max_iters: int) -> IterationResult:
    """Host-controlled iteration with device-resident state: one scalar
    (the metric) crosses to the host per round.  ``step`` works on a
    private copy of ``init_state`` (the reference donates its buffers
    instead)."""
    state = _copy(init_state)
    trace = []
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        new = step(state)
        m = float(metric(state, new))  # the only host pull per round
        state = new
        trace.append(m)
        if m < tol:
            converged = True
            break
    return IterationResult(state, it, converged, trace)


def device_driver(step: StepFn, init_state: S, *, metric: MetricFn,
                  tol: float, max_iters: int) -> IterationResult:
    """Data-dependent stopping: iterate until ``metric < tol`` (or a NaN
    metric, as the reference's ``m >= tol`` loop condition stops on one)
    or ``max_iters``.  A host loop here: no fused device loop yet."""
    state = _copy(init_state)
    trace = []
    m = float("inf")
    for _ in range(max_iters):
        new = step(state)
        m = float(metric(state, new))
        state = new
        trace.append(m)
        if not m >= tol:
            break
    return IterationResult(state, len(trace), m < tol, trace)


def counted_driver(step: StepFn, init_state: S, n_iters: int) -> S:
    """Fixed-count iteration (the paper's "virtual table" counted join).
    Like the reference, a ``(state, extra)`` pair comes back as its first
    member.  (The reference's ``unroll``, a ``lax.scan`` compiler hint,
    has no eager counterpart.)"""
    state = _copy(init_state)
    for _ in range(n_iters):
        state = step(state)
    return state[0] if isinstance(state, tuple) and len(state) == 2 \
        else state
