"""User-defined aggregates: the core MADlib design pattern (§3.1.1, §4.1).

The port's counterpart of the reference ``core/aggregates.py``.  A
method is an ``(init, transition, merge, final)``
quadruple; the transition is block-at-a-time: it receives a block of rows
``(B, ...)`` and a validity mask, so the OLS ``x xᵀ`` rank-1 update is a
``(k, B) @ (B, k)`` product.

Engines here:

* :func:`run_local`   — blocked fold over one table (a host loop over
  row blocks; PyTorch runs eagerly, so there is no program cache).
* :func:`run_sharded` — the Greenplum segment model over a
  :class:`~repro_torch.distributed.sharding.Mesh`: every segment folds
  its own rows (launching the aggregate's kernel on them), then the
  segment states merge with :meth:`Aggregate.mesh_merge`, a left fold
  in segment order.  One process drives every segment, so there is no
  collective whose summation order is not fixed: the merge is
  deterministic, and on data whose sums are exact (dyadic values,
  counts) the sharded state equals the local one bit for bit.
* :func:`run_many`    — N aggregates in ONE pass through
  :class:`FusedAggregate`.
* :func:`run_stream`  — out-of-core fold over a host-side iterator of
  row blocks, the state kept on the device; on the card each block is
  copied on a stream of its own while the previous block folds.
* :func:`run_grouped` — GROUP BY: rows sorted into group-aligned blocks
  once and every group folded in one pass (:func:`segment_fold`, with the
  aggregate's registered segment kernel where it has one), or the masked
  fallback for generic-merge aggregates.  In a fused grouped pass, each
  member that has a segment kernel runs it over the shared layout; the
  reference folds a fused pass of several members block by block, with
  the same states (bitwise where the sums are exact).  On a mesh the
  group-aligned blocks split into whole-block chunks, one per segment
  (:meth:`~repro_torch.core.table.GroupedView.sharded_blocks`), each
  segment folds its chunk and the ``(G, ...)`` stacks merge in segment
  order (:func:`merge_group_states`).

Where the reference vmaps over the group axis, the port writes the axis
out: inits are stacked per group and ``final_grouped`` finalizes a
stacked state.
"""

from __future__ import annotations

from functools import reduce
from typing import Any, Iterable, Mapping, TypeVar

import torch

from ..device import resolve_device
from ..distributed import sharding as _sh
from ..kernels import registry as _kernels
from ..tree import tree_index, tree_leaves, tree_map, tree_stack
from . import calibration as _calibration
from .table import (
    Columns, GroupedView, Table, _n_rows, as_column, host_tensor,
    stored_dtype, table_mesh,
)
from .trace import record as _record, span

S = TypeVar("S")  # transition state tree
R = TypeVar("R")  # result tree

# Merge combinators, per state leaf.
MERGE_SUM = "sum"
MERGE_MAX = "max"
MERGE_MIN = "min"


class Aggregate:
    """Base class for user-defined aggregates.

    Subclasses implement ``init``/``transition``/``final`` and declare
    ``merge_ops``: one combinator string for every state leaf, or a tree
    of strings matching the state.  Aggregates whose merge is not
    leaf-wise override :meth:`merge` and set ``merge_ops = None``.
    """

    merge_ops: Any = MERGE_SUM

    # Registered segment-fold kernel hook: a key in kernels/registry.py
    # (e.g. "segment_linregr") and the dispatch policy from the method
    # layer's ``use_kernel`` flag (None = the generic segment fold).
    segment_kernel: str | None = None
    kernel_impl: str | None = None
    # The planner's calibration bucket (``"xtx"``, ``"sketch"``, or the
    # generic tables): see repro_torch.core.calibration.
    cost_class: str = "generic"

    def segment_kernel_args(self, columns: Columns, valid, block_gids,
                            num_groups: int):
        """(args, kwargs) for this aggregate's registered segment kernel,
        extracted from the group-aligned layout."""
        raise NotImplementedError

    def segment_kernel_fold(self, columns: Columns, valid, block_gids,
                            num_groups: int, impl: str):
        """Whole-fold (G, ...) state stack via the registered kernel
        (fold-from-zero; the caller merges with the per-group inits)."""
        args, kwargs = self.segment_kernel_args(columns, valid, block_gids,
                                                num_groups)
        return _kernels.dispatch(self.segment_kernel, *args, impl=impl,
                                 _record=False, **kwargs)

    def cache_key(self):
        """Semantic identity for result caching, or ``None`` to opt out."""
        return None

    # -- to implement --------------------------------------------------------
    def init(self, block: Columns) -> S:  # may be meta tensors: shapes only
        raise NotImplementedError

    def transition(self, state: S, block: Columns, mask: torch.Tensor) -> S:
        raise NotImplementedError

    def final(self, state: S) -> R:
        return state

    def final_grouped(self, states: S) -> R:
        """``final`` over a stacked ``(G, ...)`` state: per group, results
        stacked.  Aggregates whose ``final`` takes a leading group axis
        override this with one batched call."""
        g = tree_leaves(states)[0].shape[0]
        return tree_stack([self.final(tree_index(states, i))
                           for i in range(g)])

    # -- default leaf-wise merge ---------------------------------------------
    def merge(self, a: S, b: S) -> S:
        return tree_map(_combine_leaf, self._merge_ops_tree(a), a, b)

    def _merge_ops_tree(self, state: S):
        if self.merge_ops is None:
            raise NotImplementedError(
                "generic-merge aggregate must override merge()")
        if isinstance(self.merge_ops, str):
            return tree_map(lambda _: self.merge_ops, state)
        return self.merge_ops

    def segment_ops(self, state: S):
        """Per-leaf merge-combinator tree for segment reduction, or None
        when only the generic ``merge`` combines states.  Consult after
        ``init`` has run."""
        if self.merge_ops is None:
            return None
        return self._merge_ops_tree(state)

    def mesh_merge(self, states: list) -> S:
        """Merge the per-segment states of a sharded pass (segment order,
        one device): leaf-wise with the merge combinators, or with the
        aggregate's own ``merge`` when ``merge_ops`` is None, either way
        a left fold ``((s0 . s1) . s2) ...``.  The reference merges with
        ``psum``/``pmax``/``pmin`` or an all-gather fold; a fixed order
        gives the same bits on any run."""
        if self.merge_ops is None:
            return reduce(self.merge, states)
        return _fold_leafwise(self._merge_ops_tree(states[0]), states)


def _fold_leafwise(ops, states: list):
    """Left fold of same-shaped states, each leaf with its combinator."""
    return tree_map(lambda op, *leaves: reduce(
        lambda a, b: _combine_leaf(op, a, b), leaves), ops, *states)


def _on_device(tree, dev: torch.device):
    """A state tree's tensors on ``dev`` (the merge device)."""
    return tree_map(lambda v: v.to(dev) if isinstance(v, torch.Tensor)
                    else v, tree)


class FusedAggregate(Aggregate):
    """Shared-scan combinator: N aggregates, ONE data pass.  The fused
    state is the tuple of member states; every member sees the same block
    and mask and keeps its own combinators.  ``aggs`` may be a sequence
    (tuple results) or a mapping (dict results)."""

    merge_ops = None  # member-wise delegation; never consulted

    def __init__(self, aggs):
        if isinstance(aggs, Mapping):
            self.names: tuple[str, ...] | None = tuple(aggs)
            self.aggs: tuple[Aggregate, ...] = tuple(aggs[k]
                                                     for k in self.names)
        else:
            self.names = None
            self.aggs = tuple(aggs)
        if not self.aggs:
            raise ValueError("FusedAggregate needs at least one aggregate")

    def init(self, block):
        return tuple(a.init(block) for a in self.aggs)

    def transition(self, state, block, mask):
        return tuple(a.transition(s, block, mask)
                     for a, s in zip(self.aggs, state))

    def merge(self, a, b):
        return tuple(agg.merge(sa, sb)
                     for agg, sa, sb in zip(self.aggs, a, b))

    def mesh_merge(self, states):
        return tuple(a.mesh_merge([s[i] for s in states])
                     for i, a in enumerate(self.aggs))

    def segment_ops(self, state):
        ops = tuple(a.segment_ops(s) for a, s in zip(self.aggs, state))
        if any(o is None for o in ops):
            return None  # one generic-merge member poisons the fused pass
        return ops

    # A single-member fusion forwards its member's kernel hook, so the
    # fused wrapper does not hide the fast path.
    @property
    def segment_kernel(self):
        return self.aggs[0].segment_kernel if len(self.aggs) == 1 else None

    @property
    def kernel_impl(self):
        return self.aggs[0].kernel_impl if len(self.aggs) == 1 else None

    @property
    def cost_class(self):
        return self.aggs[0].cost_class if len(self.aggs) == 1 else "generic"

    def segment_kernel_args(self, columns, valid, block_gids, num_groups):
        return self.aggs[0].segment_kernel_args(columns, valid, block_gids,
                                                num_groups)

    def segment_kernel_fold(self, columns, valid, block_gids, num_groups,
                            impl):
        return (self.aggs[0].segment_kernel_fold(
            columns, valid, block_gids, num_groups, impl),)

    def _named(self, outs):
        return dict(zip(self.names, outs)) if self.names is not None \
            else outs

    def final(self, state):
        return self._named(tuple(a.final(s)
                                 for a, s in zip(self.aggs, state)))

    def final_grouped(self, states):
        return self._named(tuple(a.final_grouped(s)
                                 for a, s in zip(self.aggs, states)))


def run_many(aggs, table: Table, *, block_size: int | None = None,
             mask: torch.Tensor | None = None, jit: bool = True,
             engine: str = "auto", finalize: bool = True,
             trace_kind: str = "scan") -> Any:
    """Execute several aggregates over ``table`` in ONE shared scan.
    ``engine="auto"`` picks the sharded engine when the table is
    distributed, the local one otherwise; ``"local"``/``"sharded"`` force
    one (the planner's choice is what runs).  Returns a dict when
    ``aggs`` is a mapping, else a tuple.  ``finalize=False`` returns the
    raw fused fold state.  ``jit`` is the reference's: either value runs
    the eager fold, the un-jitted answer."""
    if engine == "auto":
        engine = "sharded" if table.mesh is not None else "local"
    fused = FusedAggregate(aggs)
    if engine == "sharded":
        return run_sharded(fused, table, block_size=block_size, mask=mask,
                           finalize=finalize, trace_kind=trace_kind)
    if engine != "local":
        raise ValueError(f"unknown engine {engine!r} "
                         "(use 'auto', 'local' or 'sharded')")
    return run_local(fused, table, block_size=block_size, mask=mask,
                     finalize=finalize, trace_kind=trace_kind)


def _combine_leaf(op: str, a, b):
    if op == MERGE_SUM:
        return a + b
    if op == MERGE_MAX:
        return torch.maximum(a, b)
    if op == MERGE_MIN:
        return torch.minimum(a, b)
    raise ValueError(f"unknown merge op {op!r}")


# ---------------------------------------------------------------------------
# Local blocked fold.
# ---------------------------------------------------------------------------

def _pad_rows(v: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])


def _blocked_fold(agg: Aggregate, columns: Columns,
                  mask: torch.Tensor | None, block_size: int | None) -> Any:
    """Fold ``transition`` over row blocks of ``columns``; the ragged tail
    is padded with masked rows, as in the reference."""
    n = next(iter(columns.values())).shape[0]
    dev = next(iter(columns.values())).device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    state = agg.init(columns)
    if block_size is None or block_size >= n:
        return agg.transition(state, columns, mask)

    bs = block_size
    nb = -(-n // bs)
    pad = nb * bs - n
    if pad:
        columns = {k: _pad_rows(v, pad) for k, v in columns.items()}
        mask = _pad_rows(mask, pad)
    for b in range(nb):
        rows = slice(b * bs, (b + 1) * bs)
        state = agg.transition(state, {k: v[rows] for k, v in
                                       columns.items()}, mask[rows])
    return state


def run_local(agg: Aggregate, table: Table, *, block_size: int | None = None,
              mask: torch.Tensor | None = None, jit: bool = True,
              finalize: bool = True, trace_kind: str = "scan") -> Any:
    """Execute an aggregate over one table.  ``finalize=False`` returns
    the raw fold state; ``trace_kind`` labels the recorded event.
    ``jit=True`` and ``jit=False`` both run the eager fold (PyTorch has
    no compiled program to skip)."""
    _record(trace_kind, engine="local", rows=table.n_rows)
    with span("fold"):
        state = _blocked_fold(agg, dict(table.columns), mask, block_size)
    if not finalize:
        return state
    with span("final"):
        return agg.final(state)


# ---------------------------------------------------------------------------
# Sharded execution (the Greenplum segment model).
# ---------------------------------------------------------------------------

def sharded_fold(agg: Aggregate, columns: Columns, mask, block_size,
                 mesh, row_axes) -> Any:
    """The two phases of a sharded pass, unfinalized: every segment's
    blocked fold over its rows and mask (its kernel launches on them),
    then :meth:`Aggregate.mesh_merge` on the first segment's device."""
    n = next(iter(columns.values())).shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool,
                          device=next(iter(columns.values())).device)
    states = []
    for part in _sh.segment_views(mesh, row_axes,
                                  dict(columns, __mask__=mask)):
        m = part.pop("__mask__")
        states.append(_blocked_fold(agg, part, m, block_size))
    home = mesh.segments(row_axes)[0]
    return agg.mesh_merge([_on_device(s, home) for s in states])


def run_sharded(agg: Aggregate, table: Table, *, mesh=None, row_axes=None,
                block_size: int | None = None,
                mask: torch.Tensor | None = None, jit: bool = True,
                finalize: bool = True, trace_kind: str = "scan") -> Any:
    """Execute an aggregate across the segments of ``mesh`` (the table's
    when None): each segment folds its rows (transition), the states
    merge in segment order (second-phase aggregation), and ``final``
    runs once on the merged state: the paper's Figure-4 engine.
    ``mask`` is a base row filter in table row order, split with the
    rows.  Without a mesh it is :func:`run_local`, as in the reference.
    Records one ``scan`` event with ``engine="sharded"``, the segment
    count and the rows."""
    mesh, row_axes = table_mesh("run_sharded", mesh, row_axes, table)
    if mesh is None:
        return run_local(agg, table, block_size=block_size, mask=mask,
                         finalize=finalize, trace_kind=trace_kind)
    _record(trace_kind, engine="sharded", rows=table.n_rows,
            segs=_sh.mesh_segments(mesh, row_axes))
    with span("fold"):
        state = sharded_fold(agg, dict(table.columns), mask, block_size,
                             mesh, row_axes)
    if not finalize:
        return state
    with span("final"):
        return agg.final(state)


# ---------------------------------------------------------------------------
# Streaming / out-of-core execution.
# ---------------------------------------------------------------------------

class _HostFeed:
    """The CPU's blocks: each column converted as the reference stores it.
    A fold on the CPU ends before the engine asks for the next block, so
    a block may share memory with the producer's buffer."""

    def put(self, block: Columns) -> dict:
        return {k: as_column(v, "cpu") for k, v in block.items()}

    def take(self, cols: dict) -> dict:
        return cols

    def release(self, cols: dict) -> None:
        pass

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bool)


class _Upload:
    """One block on its way to the card: its device columns, the event
    recorded after their copies, and whether the copies read the
    caller's own (pinned) memory."""

    __slots__ = ("cols", "event", "reads_caller")

    def __init__(self, cols, event, reads_caller):
        self.cols, self.event, self.reads_caller = cols, event, reads_caller


class _CardFeed:
    """Moves a stream's blocks to the card, on a copy stream of its own.

    * A CUDA tensor on the engine's device is folded as it is.
    * A contiguous pinned CPU tensor already in its stored dtype is
      copied straight out of the caller's memory, so the host waits for
      that copy before the producer runs again (:meth:`release`).
    * Anything else (numpy arrays, pageable or strided tensors, 64-bit
      columns, sequences) is converted into one of two pinned staging
      buffers per column, which the engine owns; a buffer is refilled
      only after its last copy has completed.

    Every device block is allocated on the copy stream and
    ``record_stream``-ed on the compute stream, so the allocator keeps
    its memory until the fold that reads it has run."""

    def __init__(self, device: torch.device):
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.staging: dict[str, list] = {}   # column -> two [buf, event]
        self.turn = 0
        self._ones = torch.ones((0,), dtype=torch.bool, device=device)

    def _stage(self, name: str, t: torch.Tensor, dtype) -> torch.Tensor:
        slots = self.staging.setdefault(name, [[None, None], [None, None]])
        slot = slots[self.turn]
        if slot[1] is not None:
            slot[1].synchronize()   # its previous copy has left the buffer
        buf = slot[0]
        if buf is None or buf.dtype != dtype or buf.numel() < t.numel():
            buf = slot[0] = torch.empty((t.numel(),), dtype=dtype,
                                        pin_memory=True)
        out = buf[:t.numel()].view(t.shape)
        out.copy_(t)
        return out

    def put(self, block: Columns) -> _Upload:
        cols, srcs, staged, reads_caller = {}, {}, [], False
        for name, v in block.items():
            t = host_tensor(v)
            dt = stored_dtype(t.dtype)
            if t.device.type == "cuda":   # as it is on the engine's card
                cols[name] = t.to(device=self.device, dtype=dt)
            elif t.dtype == dt and t.is_contiguous() and t.is_pinned():
                srcs[name] = t
                reads_caller = True
            else:
                srcs[name] = self._stage(name, t, dt)
                staged.append(name)
        event = torch.cuda.Event()
        with torch.cuda.stream(self.copy):
            for name, src in srcs.items():
                d = src.to(self.device, non_blocking=True)
                d.record_stream(self.compute)
                cols[name] = d
            event.record(self.copy)
        for name in staged:
            self.staging[name][self.turn][1] = event
        self.turn ^= 1
        _n_rows(cols)
        return _Upload(cols, event, reads_caller)

    def take(self, up: _Upload) -> dict:
        self.compute.wait_event(up.event)
        return up.cols

    def release(self, up: _Upload) -> None:
        if up.reads_caller:
            up.event.synchronize()

    def ones(self, n: int) -> torch.Tensor:
        if self._ones.shape[0] < n:
            self._ones = torch.ones((n,), dtype=torch.bool,
                                    device=self.device)
        return self._ones[:n]


def run_stream(agg: Aggregate, blocks: Iterable[Columns], *,
               device=None) -> Any:
    """Fold an aggregate over a host-side stream of row blocks (column
    dicts of numpy arrays, CPU tensors, pinned or not, or tensors on the
    card), with the fold state kept on ``device``: the card unless
    ``device="cpu"``.  Every column is stored as :func:`as_column` stores
    it; the first block seeds the state through ``init`` and
    ``transition``, every block folds under an all-true mask, and
    ``final`` runs once at the end.  One ``scan`` event
    (``engine="stream"``).

    On the card the copy of block i + 1 runs on a copy stream of its own
    while block i folds on the caller's current stream; the host waits
    only where a copy reads memory the engine does not own, before it
    asks the producer for the next block, and where a staging buffer is
    refilled.  Only the state, the block being folded and the next block
    are on the device at once.  The reference's per-aggregate program
    memo (``_stream_jit``) has no counterpart: PyTorch runs eagerly."""
    dev = resolve_device(device)
    it = iter(blocks)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("run_stream: empty block stream — at least one "
                         "block is required to seed the fold state") from None
    _record("scan", engine="stream")
    with span("fold"):
        feed = _CardFeed(dev) if dev.type == "cuda" else _HostFeed()
        up = feed.put(first)
        state = None
        while up is not None:
            cols = feed.take(up)
            n = next(iter(cols.values())).shape[0]
            if state is None:
                state = agg.init(cols)
            # enqueued before the producer runs again: a producer that
            # reuses a buffer on the card writes it after this fold in
            # stream order
            state = agg.transition(state, cols, feed.ones(n))
            del cols
            feed.release(up)
            nxt = next(it, None)
            up = None if nxt is None else feed.put(nxt)
            del nxt
    with span("final"):
        return agg.final(state)


# ---------------------------------------------------------------------------
# GROUP BY execution — the partitioned grouped-scan core.
# ---------------------------------------------------------------------------

# Default row-block size for the segment path.
_SEGMENT_BLOCK = 4096


def _scatter_leaf(op: str, acc: torch.Tensor, g: int, val: torch.Tensor):
    """Segment-merge one block state into group ``g``'s slot of ``acc``
    with the leaf's combinator.  Updates in place: the accumulators are
    fresh tensors owned by the fold."""
    acc[g] = _combine_leaf(op, acc[g], val)
    return acc


def probe_segment_ops(agg: Aggregate, columns: Columns):
    """Merge-combinator tree of ``agg`` over ``columns``' schema, or None
    when the aggregate is not segment-reducible.  Runs ``init`` on
    ``meta`` tensors, so no data is touched."""
    spec = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in columns.items()}
    return agg.segment_ops(agg.init(spec))


def segment_block_size(n_rows: int, num_groups: int,
                       block_size: int | None = None) -> int:
    """Block size of the group-aligned layout: near the average segment,
    power of two, clamped to [64, _SEGMENT_BLOCK].  An explicit
    ``block_size`` wins; an ACTIVE measured calibration's best block for
    this shape bucket beats the heuristic
    (:mod:`repro_torch.core.calibration`)."""
    if block_size is not None:
        return max(1, int(block_size))
    cal = _calibration.current()
    if cal is not None:
        b = cal.grouped_block_size(n_rows, num_groups)
        if b:
            return max(1, int(b))
    avg = max(1, -(-n_rows // max(1, num_groups)))
    return max(64, min(_SEGMENT_BLOCK, 1 << (avg - 1).bit_length()))


def segment_block_update(agg: Aggregate, ops, blk: Columns,
                         bm: torch.Tensor, g: int, acc) -> Any:
    """Fold ONE group-aligned block into the stacked per-group
    accumulators: the aggregate's block transition from init, merged into
    group ``g``'s slot leaf-wise.  Blocks whose id lies outside ``[0, G)``
    are dropped."""
    if not 0 <= g < tree_leaves(acc)[0].shape[0]:
        return acc  # sentinel block: the reference's scatter drops it
    bstate = agg.transition(agg.init(blk), blk, bm)
    return tree_map(lambda op, al, bl: _scatter_leaf(op, al, g, bl),
                    ops, acc, bstate)


def segment_fold(agg: Aggregate, ops, columns: Columns,
                 valid: torch.Tensor, block_gids: torch.Tensor,
                 num_groups: int, *, kernel_impl: str | None = None) -> Any:
    """Fold EVERY group's state in ONE pass over the group-aligned layout
    of :meth:`GroupedView.aligned_blocks`: the real block transition per
    block, segment-merged into ``(num_groups, ...)`` accumulators with
    each leaf's combinator (``ops``).  Empty groups keep their init.

    ``kernel_impl`` engages the aggregate's registered segment kernel,
    which computes the fold-from-zero state stack that is then merged
    with the per-group inits.  (The reference's group-parameterized form,
    which its grouped fits use, waits for the slice that ports them.)"""
    inits = tree_map(lambda z: z[None].repeat(num_groups, *([1] * z.dim())),
                     agg.init(columns))
    nb = block_gids.shape[0]
    if nb == 0:
        return inits
    if kernel_impl is not None and getattr(agg, "segment_kernel", None):
        kstates = agg.segment_kernel_fold(columns, valid, block_gids,
                                          num_groups, kernel_impl)
        return tree_map(_combine_leaf, ops, inits, kstates)
    n2 = next(iter(columns.values())).shape[0]
    bs = n2 // nb
    acc = inits
    for b, g in enumerate(block_gids.tolist()):
        rows = slice(b * bs, (b + 1) * bs)
        blk = {k: v[rows] for k, v in columns.items()}
        acc = segment_block_update(agg, ops, blk, valid[rows], g, acc)
    return acc


def _resolve_segment_kernel(agg: Aggregate, columns, valid, bgids,
                            num_groups: int) -> str | None:
    """Which implementation of the aggregate's registered segment kernel
    runs for ONE grouped execution (``"ref"``/``"cuda"``), or None for
    the generic segment fold.  A forced ``"cuda"`` the tensors cannot
    take fails here; the resolved impl is recorded once per execution."""
    name = getattr(agg, "segment_kernel", None)
    impl = getattr(agg, "kernel_impl", None)
    if name is None or impl is None:
        return None
    args, kwargs = agg.segment_kernel_args(columns, valid, bgids, num_groups)
    resolved = _kernels.get(name).resolve(impl, *args, **kwargs)
    _record("kernel", engine=resolved, name=name, requested=impl)
    return resolved


def _segment_fold_members(agg: Aggregate, ops, columns: Columns,
                          valid: torch.Tensor, bgids: torch.Tensor,
                          num_groups: int) -> Any:
    """The segment fold of one grouped execution over one group-aligned
    layout.  A fused aggregate of several members runs each member's
    segment kernel where it has one, and folds the others together block
    by block; any other aggregate folds through its own kernel, or
    generically without one."""
    members = agg.aggs if isinstance(agg, FusedAggregate) else ()
    if len(members) < 2:
        impl = _resolve_segment_kernel(agg, columns, valid, bgids,
                                       num_groups)
        return segment_fold(agg, ops, columns, valid, bgids, num_groups,
                            kernel_impl=impl)
    impls = [_resolve_segment_kernel(a, columns, valid, bgids, num_groups)
             for a in members]
    states = [None] * len(members)
    rest = [i for i, impl in enumerate(impls) if impl is None]
    if rest:
        folded = segment_fold(FusedAggregate([members[i] for i in rest]),
                              tuple(ops[i] for i in rest), columns, valid,
                              bgids, num_groups)
        for i, st in zip(rest, folded):
            states[i] = st
    for i, impl in enumerate(impls):
        if impl is not None:
            states[i] = segment_fold(members[i], ops[i], columns, valid,
                                     bgids, num_groups, kernel_impl=impl)
    return tuple(states)


def merge_group_states(agg: Aggregate, ops, states: list) -> Any:
    """Merge the per-segment ``(G, ...)`` state stacks of a sharded
    grouped pass (segment order, one device): a leaf-wise left fold with
    the combinators ``ops`` when the aggregate declares them, else every
    group's states folded with the aggregate's own ``merge``."""
    if ops is not None:
        return _fold_leafwise(ops, states)
    g = tree_leaves(states[0])[0].shape[0]
    return tree_stack([reduce(agg.merge, [tree_index(s, i) for s in states])
                       for i in range(g)])


def run_grouped(agg: Aggregate, table, group_col: str | None = None,
                num_groups: int | None = None, *,
                block_size: int | None = None,
                mask: torch.Tensor | None = None, method: str = "auto",
                mesh=None, row_axes=None, jit: bool = True,
                finalize: bool = True, trace_kind: str = "scan") -> Any:
    """Grouped aggregation (``SELECT ..., agg(...) GROUP BY g``).

    ``table`` is a :class:`Table` grouped by ``group_col``, or a prebuilt
    :class:`GroupedView`.  ``method="segment"`` folds the group-aligned
    blocks in one pass; ``"masked"`` folds the full table once per group
    (O(G·n)), the fallback for generic-merge aggregates; ``"auto"`` picks
    segment whenever the aggregate supports it.  ``mask`` is a base row
    filter in the original row order.  ``finalize=False`` returns the
    stacked ``(G, ...)`` fold states.  ``jit`` either value (eager).

    ``mesh`` (the table's when None) runs MADlib's two-phase GROUP BY
    across its segments: the segment path gives each segment a chunk of
    whole group-aligned blocks, on which it launches the aggregate's
    segment kernel, and the per-segment stacks merge in segment order;
    the masked path folds each segment's rows once per group (rows padded
    to divide the segments, the padding masked out) and merges the same
    way, with the aggregate's own ``merge`` when it has no leaf-wise
    combinators."""
    with span("fold"):
        states = _grouped_fold(agg, table, group_col, num_groups,
                               block_size, mask, method, mesh, row_axes,
                               trace_kind)
    if not finalize:
        return states
    with span("final"):
        return agg.final_grouped(states)


def _grouped_fold(agg: Aggregate, table, group_col, num_groups, block_size,
                  mask, method, mesh, row_axes, trace_kind):
    """:func:`run_grouped`'s fold: the stacked ``(G, ...)`` states."""
    view = table if isinstance(table, GroupedView) else None
    base_tbl = view.table if view is not None else table
    mesh, row_axes = table_mesh("run_grouped", mesh, row_axes, base_tbl)
    if view is not None:
        if num_groups is not None and num_groups != view.num_groups:
            raise ValueError(f"run_grouped: num_groups={num_groups} "
                             f"disagrees with the view's {view.num_groups}")
        num_groups = view.num_groups
        data = dict(view.table.columns)
    else:
        if group_col is None:
            raise ValueError("run_grouped: group_col is required when "
                             "grouping a Table (or pass a GroupedView)")
        if num_groups is None:
            num_groups = int(table[group_col].to(torch.int32).max()) + 1
        data = {k: v for k, v in table.columns.items() if k != group_col}
    G = num_groups

    if method in ("auto", "segment"):
        ops = probe_segment_ops(agg, data)
    elif mesh is not None:
        # forced masked on a mesh: ops only choose the cross-segment
        # merge, so an aggregate that cannot be probed merges generically
        try:
            ops = probe_segment_ops(agg, data)
        except Exception:
            ops = None
    else:
        ops = None
    if method == "auto":
        method = "segment" if ops is not None else "masked"
    _record(trace_kind, engine=f"grouped-{method}", sharded=mesh is not None,
            groups=G)

    if method == "segment":
        if ops is None:
            raise ValueError(
                "run_grouped: method='segment' needs leaf-wise merge "
                "combinators (agg.segment_ops() returned None); use "
                "method='masked' for generic-merge aggregates")
        if view is None:
            view = table.group_by(group_col, G)
        pmask = None if mask is None else view.permute(mask)
        bs = segment_block_size(view.n_rows, G, block_size)
        if mesh is None:
            cols_a, valid_a, bgids = view.aligned_blocks(bs, pmask)
            return _segment_fold_members(agg, ops, cols_a, valid_a, bgids, G)
        cols_a, valid_a, bgids = view.sharded_blocks(mesh, row_axes, bs,
                                                     pmask)
        chunks = _sh.segment_views(mesh, row_axes,
                                   dict(cols_a, __valid__=valid_a))
        gid_chunks = _sh.segment_views(mesh, row_axes, {"b": bgids})
        states = []
        for part, gpart in zip(chunks, gid_chunks):
            valid = part.pop("__valid__")
            states.append(_segment_fold_members(agg, ops, part, valid,
                                                gpart["b"], G))
        return _merge_segments(agg, ops, states, mesh, row_axes)

    if method != "masked":
        raise ValueError(f"unknown method {method!r} "
                         "(use 'auto', 'segment' or 'masked')")
    if view is not None:
        gids = view.gids
        base = None if mask is None else view.permute(mask)
    else:
        gids = table[group_col].to(torch.int32)
        base = mask
    if base is None:
        base = torch.ones(gids.shape, dtype=torch.bool, device=gids.device)
    if mesh is not None:
        return _run_grouped_masked_sharded(
            agg, ops, data, gids, base, G, block_size, mesh, row_axes)
    return tree_stack([_blocked_fold(agg, data, (gids == g) & base,
                                     block_size) for g in range(G)])


def _merge_segments(agg, ops, states: list, mesh, row_axes):
    """:func:`merge_group_states` on the first segment's device."""
    home = mesh.segments(row_axes)[0]
    return merge_group_states(agg, ops,
                              [_on_device(s, home) for s in states])


def _run_grouped_masked_sharded(agg, ops, data, gids, base, G, block_size,
                                mesh, row_axes):
    """The sharded masked path: rows padded (gid -1, invalid) to divide
    the segment count, every segment folds its rows once per group under
    the group's mask, and the ``(G, ...)`` stacks merge in segment order
    (leaf-wise where ``ops`` is known, else with ``agg.merge``)."""
    segs = _sh.mesh_segments(mesh, row_axes)
    n = gids.shape[0]
    pad = -n % segs
    if pad:
        data = {k: _pad_rows(v, pad) for k, v in data.items()}
        gids = torch.cat([gids, gids.new_full((pad,), -1)])
        base = _pad_rows(base, pad)
    states = []
    for part in _sh.segment_views(mesh, row_axes,
                                  dict(data, __gid__=gids, __valid__=base)):
        g_s, v_s = part.pop("__gid__"), part.pop("__valid__")
        states.append(tree_stack([
            _blocked_fold(agg, part, (g_s == g) & v_s, block_size)
            for g in range(G)]))
    return _merge_segments(agg, ops, states, mesh, row_axes)
