"""The port's spans (``repro_torch.core.trace.span``), on the CPU.

While torch.profiler records, a statement opens the ranges
``madlib::statement`` -> {``plan``, ``fold`` -> ``dispatch``, ``final``},
nested in the profiler's trace as the spans are in the code.  Without
the profiler, ``span()`` is one shared no-op context, and spans never
reach ``Trace.events``.
"""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile as torch_profile

from repro_torch.core import Session, Table, make_mesh, trace_execution
from repro_torch.core import trace as trace_mod
from repro_torch.core.trace import span
from repro_torch.methods.linregr import linregr, linregr_grouped
from repro_torch.methods.profile import profile, profile_stream

N = 512
CALLERS = ("repro_torch.core.plan", "repro_torch.core.session",
           "repro_torch.core.aggregates", "repro_torch.kernels.registry")


def _tables():
    g = torch.Generator().manual_seed(31)
    x = torch.randn(N, 4, generator=g)
    y = torch.randn(N, generator=g)
    k = torch.randint(0, 3, (N,), generator=g, dtype=torch.int32)
    return Table({"x": x, "y": y}), Table({"x": x, "y": y, "k": k})


def _batch(xy, xyk):
    s = Session()
    s.linregr(xy, use_kernel=True)
    s.profile(xyk)
    s.run()


def _stream(xy, xyk):
    half = N // 2
    blocks = [{"x": xy["x"][:half], "y": xy["y"][:half]},
              {"x": xy["x"][half:], "y": xy["y"][half:]}]
    profile_stream(blocks, device="cpu")


def _sharded(xy, xyk):
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    linregr(xy.distribute(mesh), use_kernel=True)


# name -> (statement, its tree of ranges)
CASES = {
    "linregr": (lambda xy, xyk: linregr(xy, use_kernel=True),
                [("statement", "plan", ("fold", "dispatch"), "final")]),
    "profile": (lambda xy, xyk: profile(xy),
                [("statement", "plan", ("fold", "dispatch", "dispatch"),
                  "final")]),
    "profile_distinct": (lambda xy, xyk: profile(xyk, distinct_counts=True),
                         [("statement", "plan",
                           ("fold", "dispatch", "dispatch", "dispatch"),
                           "final")]),
    "grouped": (lambda xy, xyk: linregr_grouped(xyk, "k", 3,
                                                use_kernel=True),
                [("statement", "plan", ("fold", "dispatch"), "final")]),
    "stream": (_stream, [("statement", "plan",
                          ("fold", *["dispatch"] * 4), "final")]),
    "sharded": (_sharded,
                [("statement", "plan", ("fold", "dispatch", "dispatch"),
                  "final")]),
    "session_batch": (_batch,
                      [("statement", "plan", ("fold", "dispatch"), "final",
                        ("fold", "dispatch", "dispatch", "dispatch"),
                        "final")]),
}


def _ranges(prof) -> list:
    return sorted((e for e in prof.events()
                   if e.name.startswith("madlib::")),
                  key=lambda e: e.time_range.start)


def _madlib_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("madlib::"):
        p = p.cpu_parent
    return p


def _tree(ranges) -> list:
    """The ranges as nested tuples ``(name, *children)``, by the
    profiler's parent links, children in the order they started."""
    kids: dict = {}
    for e in ranges:
        p = _madlib_parent(e)
        kids.setdefault(None if p is None else p.id, []).append(e)

    def node(e):
        name = e.name[len("madlib::"):]
        c = kids.get(e.id, [])
        return (name,) + tuple(node(k) for k in c) if c else name

    return [node(e) for e in kids.get(None, [])]


def _profiled(call, *args):
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        call(*args)
    return prof


@pytest.mark.parametrize("case", sorted(CASES))
def test_statement_records_its_span_tree(case):
    call, tree = CASES[case]
    ranges = _ranges(_profiled(call, *_tables()))
    assert _tree(ranges) == tree
    for e in ranges:
        p = _madlib_parent(e)
        assert e.time_range.start <= e.time_range.end
        if p is not None:
            assert p.thread == e.thread
            assert p.time_range.start <= e.time_range.start
            assert e.time_range.end <= p.time_range.end


def test_dispatch_range_holds_the_kernels_work():
    xy, _ = _tables()
    ranges = _ranges(_profiled(lambda: linregr(xy, use_kernel=True)))
    (d,) = [e for e in ranges if e.name == "madlib::dispatch"]
    inside = set()
    stack = list(d.cpu_children)
    while stack:
        e = stack.pop()
        inside.add(e.name)
        stack.extend(e.cpu_children)
    # xtx's plain version on the CPU: X^T X and X^T y by matmul
    assert inside & {"aten::mm", "aten::matmul", "aten::addmm",
                     "aten::mv"}, sorted(inside)


@pytest.mark.parametrize("case", sorted(CASES))
def test_events_and_summary_are_the_same_without_spans(case, monkeypatch):
    call = CASES[case][0]
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_execution() as with_spans:
            call(*_tables())
    assert _ranges(prof)
    for mod in CALLERS:
        monkeypatch.setattr(sys.modules[mod], "span",
                            lambda name: trace_mod._OFF)
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_execution() as without:
            call(*_tables())
    assert _ranges(prof) == []

    def events(t):
        # sort events name a table by id(); the tables are made anew
        return [(e.kind, e.engine, {k: v for k, v in e.detail.items()
                                    if k != "table"}) for e in t.events]

    assert events(with_spans) == events(without)
    strip = lambda s: {k: v for k, v in s.items() if k != "sorts_by_table"}
    assert strip(with_spans.summary()) == strip(without.summary())


def test_span_is_a_shared_no_op_without_the_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("fold"), span("statement")
    assert a is b is trace_mod._OFF
    with a as rec:
        assert rec is None
    xy, _ = _tables()
    with trace_execution() as t:
        assert span("plan") is trace_mod._OFF
        linregr(xy, use_kernel=True)
    assert [e.kind for e in t.events] == ["scan", "kernel"]


@pytest.mark.parametrize("traced", [False, True])
def test_profiler_ranges_nest_as_the_spans(traced):
    xy, _ = _tables()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        if traced:
            with trace_execution():
                linregr(xy, use_kernel=True)
        else:
            linregr(xy, use_kernel=True)
    pairs = [(e.name, getattr(_madlib_parent(e), "name", None))
             for e in _ranges(prof)]
    assert sorted(pairs) == sorted([
        ("madlib::statement", None),
        ("madlib::plan", "madlib::statement"),
        ("madlib::fold", "madlib::statement"),
        ("madlib::dispatch", "madlib::fold"),
        ("madlib::final", "madlib::statement")])
