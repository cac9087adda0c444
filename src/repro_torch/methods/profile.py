"""Data profiling (paper Table 1): MADlib's ``profile`` gives one summary
row per column of an arbitrary table, in a SINGLE table scan.

The port's counterpart of the reference ``methods/profile.py``.
``profile`` is a planned batch: one ``ScanAgg`` statement per part (the
templated :class:`ProfileAggregate`, plus one FM distinct-count sketch
per 1-D integer column when asked), issued into a
:class:`~repro_torch.core.session.Session`, whose planner fuses them into
one data pass.  :func:`profile_stream` plans the same parts as
``StreamAgg`` statements over one block source: one ``run_stream`` fold.
"""

from __future__ import annotations

import itertools

import torch

from ..core.plan import StreamAgg
from ..core.session import Session
from ..core.table import Table, host_tensor, stored_dtype
from ..core.templates import ProfileAggregate, is_numeric
from .sketches import FMAggregate

_STATS = "__stats__"
_FM = "__fm__"


def distinct_count_columns(table: Table) -> tuple[str, ...]:
    """Columns eligible for FM distinct-count enrichment (1-D integer)."""
    return tuple(
        name for name, col in sorted(table.columns.items())
        if is_numeric(col.dtype) and not col.dtype.is_floating_point
        and col.dim() == 1)


def profile_aggregates(table: Table, *, distinct_counts: bool = False
                       ) -> dict:
    """The aggregates a profile run plans as one batch."""
    aggs = {_STATS: ProfileAggregate()}
    if distinct_counts:
        for name in distinct_count_columns(table):
            aggs[_FM + name] = FMAggregate(item_col=name)
    return aggs


def _shape_results(results: dict) -> dict:
    out = {name: dict(stats) for name, stats in results[_STATS].items()}
    for key, est in results.items():
        if key.startswith(_FM):
            out[key[len(_FM):]]["approx_distinct"] = est
    return out


def profile(table: Table, *, distinct_counts: bool = False,
            block_size: int | None = None, jit: bool = True) -> dict:
    """Univariate stats for every numeric column (plus approximate
    distinct counts of the integer columns when asked), in ONE data pass
    through the planner.  ``jit`` either value (eager)."""
    sess = Session()
    handle = sess.profile(table, distinct_counts=distinct_counts,
                          block_size=block_size, jit=jit)
    sess.run()
    return handle.result()


def profile_stream(blocks, *, distinct_counts: bool = False,
                   device=None) -> dict:
    """Streaming fused profile, the out-of-core workload.

    ``blocks`` is a host-side iterable of column dicts (e.g. one per file
    of an out-of-core table).  Each part becomes a ``StreamAgg``
    statement over the SAME block iterator, which the planner fuses into
    one ``run_stream`` fold on ``device`` (the card unless
    ``device="cpu"``): the same numbers as :func:`profile` on the
    concatenated table, in one pass.  The first block's stored dtypes
    pick the distinct-count columns."""
    it = iter(blocks)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("profile_stream: empty block stream") from None
    schema = {}
    for k, v in first.items():
        t = host_tensor(v)
        schema[k] = torch.empty(tuple(t.shape), device="meta",
                                dtype=stored_dtype(t.dtype))
    aggs = profile_aggregates(Table(schema), distinct_counts=distinct_counts)
    source = itertools.chain([first], it)
    sess = Session()
    handles = {name: sess.statement(StreamAgg(agg, source, label=name,
                                              device=device))
               for name, agg in aggs.items()}
    sess.run()
    return _shape_results({name: h.result() for name, h in handles.items()})
