"""The program's own spans in the profiler's trace, and the device's idle
time split by them.

While torch.profiler records, every span of ``repro_torch.core.trace``
is also a host range named ``madlib::<name>``: ``statement``, ``plan``,
``fold``, ``dispatch`` and ``final``.  :func:`idle_by_layer` takes every
gap between the merged device intervals, with no cap on their number,
and splits each exactly (by interval intersection) by the innermost
program range over each part of it.  A program that has no such spans
gives ``None``, and the metrics that read it report nothing.  The
``plan`` part is the front end's and the planner's together: the
``statement`` span's own time and the ``plan`` span's.
"""

from __future__ import annotations

import weakref

PREFIX = "madlib::"
# the part of the idle time each span's own time counts to
LAYER = {"statement": "plan", "plan": "plan", "fold": "fold",
         "dispatch": "fold", "final": "final"}
PARTS = ("plan", "fold", "final", "outside")


def innermost(spans) -> list[tuple[float, float, str]]:
    """Disjoint, ordered pieces ``(start, end, layer)`` of ``spans``
    (``(start, end, layer)`` intervals): at each time, the layer of the
    latest-started span still open.  Time under no span has no piece."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []     # (end, layer), latest last
    t = float("-inf")

    def flush(until: float) -> None:
        nonlocal t
        while stack:
            end, layer = stack[-1]
            if end <= t:                    # ended under a later span
                stack.pop()
                continue
            stop = min(end, until)
            if stop > t:
                out.append((t, stop, layer))
                t = stop
            if end > until:
                break
            stack.pop()

    for a, b, layer in sorted(spans, key=lambda s: (s[0], -s[1])):
        flush(a)
        t = max(t, a)
        stack.append((b, layer))
    flush(float("inf"))
    return out


def split_gaps(gaps, pieces) -> dict[str, float]:
    """The length of ``gaps`` (disjoint ``(start, end)``) under each
    layer of ``pieces`` (disjoint, from :func:`innermost`), and
    ``outside`` any piece; the parts add up to the gaps' length."""
    parts = dict.fromkeys(PARTS, 0.0)
    j = 0
    for a, b in sorted(gaps):
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                parts[pieces[k][2]] += hi - lo
                covered += hi - lo
            k += 1
        parts["outside"] += (b - a) - covered
    return parts


# the trace split last (a weak reference), its split and its gap count
_last: tuple = (None, None, 0)


def idle_by_layer(trace) -> dict[str, float] | None:
    """Seconds of the device's idle gaps in ``trace`` (a
    ``harness.tracing.DeviceTrace``) under the innermost program span of
    each layer: ``plan`` (``statement`` or ``plan``), ``fold`` (``fold``
    or ``dispatch``), ``final``, and ``outside`` any (the harness's loop
    and its synchronize).  ``None`` when the trace holds no program
    span.  Computed once a trace: the metrics of one run share it."""
    global _last
    ref, split, _ = _last
    if ref is not None and ref() is trace:
        return split
    split, gaps = _split(trace)
    _last = (weakref.ref(trace), split, gaps)
    return split


def last_split() -> tuple[dict[str, float] | None, int]:
    """The newest trace's split (:func:`idle_by_layer`) and its number
    of idle gaps, for a tool that runs a cell in its own process."""
    return _last[1], _last[2]


def _split(trace) -> tuple[dict[str, float] | None, int]:
    spans = [(a, b, LAYER[name[len(PREFIX):]]) for a, b, name in trace._host
             if name.startswith(PREFIX) and name[len(PREFIX):] in LAYER]
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(trace.busy, trace.busy[1:])]
    if not spans:
        return None, len(gaps)
    parts = split_gaps(gaps, innermost(spans))
    return {k: v / 1e6 for k, v in parts.items()}, len(gaps)


def idle_ms_per_stmt(ctx, part: str) -> float | None:
    """``part`` of :func:`idle_by_layer` in ms per statement answered in
    the window, or ``None`` with no trace or no program span."""
    if ctx.trace is None or not ctx.answered:
        return None
    split = idle_by_layer(ctx.trace)
    if split is None:
        return None
    return 1e3 * split[part] / len(ctx.answered)
