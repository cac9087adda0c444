"""Unified iterative executor: ONE driver loop for every multipass method.

The port's counterpart of the reference ``core/iterative.py``.
MADlib's §3.1.2 driver pattern is a state-resident outer
loop around a bulk UDA inner pass::

    state_0 = init ;  repeat:  agg_out = ONE shared scan (a UDA pass)
                               state   = update(state, agg_out)   # driver
                               m       = metric(...)              # scalar
              until m < tol or max_iters

The **task contract** is :class:`IterativeTask`:

* ``init_state(columns)``   — driver-side model state (small, on the device)
* ``make_aggregate(state)`` — the per-iteration UDA pass, any
  :class:`~repro_torch.core.aggregates.Aggregate`
* ``update(state, agg_out)``— the driver-side step (solve, renormalize, …)
* ``metric(prev, new, agg_out)`` — scalar convergence criterion (< tol stops)
* ``finalize(state, agg_out)``   — shape the last state/pass into the result
* ``trace_record(state, agg_out, m)`` — small per-iteration record

Tasks whose iteration is not a single pure scan (two-pass k-means)
override :meth:`IterativeTask.iteration` and call the supplied
``run_pass`` runner as many times as their dataflow needs.

:func:`fit` runs a task on one table, :func:`fit_stream` on a stream of
host-side row blocks that every round folds afresh through
:func:`~repro_torch.core.aggregates.run_stream`, and :func:`fit_grouped`
fits one model per group (``GROUP BY``), on the group-aligned segment
layout or the masked fallback.  PyTorch runs eagerly, so every engine is
a host loop that pulls the metric once per round.  ``mode="compiled"``
is accepted and folds through :class:`PassRunner` (no scan event per
round) where ``mode="host"`` calls the recorded ``run_local`` engine;
neither fuses the loop on the device yet (a CUDA-graph body is later
work).  ``tol=None`` runs exactly ``max_iters`` rounds.  ``jit=True``
and ``jit=False`` both run that loop: it is the reference's un-jitted
answer.

On a mesh (the table's, or ``mesh=``), :func:`fit` runs the sharded
engine.  One process drives every segment, so where the reference runs
the loop inside one ``shard_map`` program with a replicated carry, the
port runs one host loop whose every pass folds each segment's rows and
merges the states in segment order (:class:`PassRunner` with a mesh).
A task whose carry is per segment (SGD, which reads rows through
``run_pass.columns``) overrides :meth:`IterativeTask.mesh_epilogue`:
its loop then runs once per segment on that segment's rows, in segment
order, and ``mesh_epilogue`` merges the final states.
:func:`fit_grouped` on a mesh cuts the group-aligned blocks into one
whole-block chunk per segment and merges each group's per-segment folds
in segment order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import sharding as _sh
from ..tree import tree_index, tree_leaves, tree_map, tree_stack
from .aggregates import (
    Aggregate, _blocked_fold, _combine_leaf, _on_device, probe_segment_ops,
    run_local, run_sharded, run_stream, segment_block_size, sharded_fold,
)
from .table import Columns, Table, as_column, table_mesh
from .trace import record as _record


def relative_change(prev, new) -> torch.Tensor:
    """Default convergence metric: ||new - prev|| / (||prev|| + eps)."""
    dn = sum(torch.sum((n - p) ** 2)
             for p, n in zip(tree_leaves(prev), tree_leaves(new)))
    pn = sum(torch.sum(p ** 2) for p in tree_leaves(prev))
    return torch.sqrt(dn) / (torch.sqrt(pn) + 1e-12)


# ---------------------------------------------------------------------------
# Pass runners — how one UDA pass executes.
# ---------------------------------------------------------------------------

class PassRunner:
    """Executes ONE shared scan: the blocked fold of the aggregate over
    ``columns`` under ``mask``, then its ``final``.  ``columns``/``mask``
    are exposed to tasks that are not pure folds (SGD epochs gather
    their minibatches from them).  With ``mesh`` the pass is sharded:
    each segment of ``row_axes`` (default ``("data",)``) folds its rows
    and the states merge in segment order before ``final``, where the
    reference's runner merges with collectives inside ``shard_map``."""

    def __init__(self, columns: Columns, mask=None,
                 block_size: int | None = None, row_axes=(), mesh=None):
        if mesh is not None:
            _sh.check_mesh(mesh, "PassRunner")
        self.columns = columns
        self.mask = mask
        self.block_size = block_size
        self.mesh = mesh
        self.row_axes = tuple(row_axes or ("data",))

    def __call__(self, agg: Aggregate):
        if self.mesh is None:
            return agg.final(_blocked_fold(agg, self.columns, self.mask,
                                           self.block_size))
        return agg.final(sharded_fold(agg, self.columns, self.mask,
                                      self.block_size, self.mesh,
                                      self.row_axes))


class _EagerRunner:
    """Host-mode runner: one recorded ``run_local`` engine call per
    pass, ``run_sharded`` on a mesh."""

    def __init__(self, table: Table, mask=None, block_size: int | None = None,
                 mesh=None, row_axes=("data",)):
        self.table = table
        self.columns = dict(table.columns)
        self.mask = mask
        self.block_size = block_size
        self.mesh = mesh
        self.row_axes = row_axes

    def __call__(self, agg: Aggregate):
        if self.mesh is not None:
            return run_sharded(agg, self.table, mesh=self.mesh,
                               row_axes=self.row_axes,
                               block_size=self.block_size, mask=self.mask)
        return run_local(agg, self.table, block_size=self.block_size,
                         mask=self.mask)


class _StreamRunner:
    """Each pass re-folds a fresh block stream; the state stays on
    ``device``."""

    columns = None
    mask = None

    def __init__(self, blocks_factory: Callable[[], Iterable[Columns]],
                 device: torch.device):
        self.blocks_factory = blocks_factory
        self.device = device

    def __call__(self, agg: Aggregate):
        return run_stream(agg, self.blocks_factory(), device=self.device)


# ---------------------------------------------------------------------------
# The task protocol.
# ---------------------------------------------------------------------------

class IterativeTask:
    """Base class for iterative fits (see module docstring for the contract).

    Subclasses implement ``init_state`` / ``make_aggregate`` / ``update``
    (and usually ``metric`` / ``finalize``); tasks whose iteration is not a
    single scan override :meth:`iteration`.
    """

    def init_state(self, columns: Columns) -> Any:
        raise NotImplementedError

    def make_aggregate(self, state) -> Aggregate:
        raise NotImplementedError

    def update(self, state, agg_out) -> Any:
        raise NotImplementedError

    def metric(self, prev_state, new_state, agg_out) -> torch.Tensor:
        return relative_change(prev_state, new_state)

    def finalize(self, state, agg_out) -> Any:
        return state

    def trace_record(self, state, agg_out, metric) -> Any:
        return metric

    def mesh_epilogue(self, states: list) -> Any:
        """Sharded-engine hook: the final state from the per-segment final
        states, in segment order.  A task that overrides it has a carry
        per segment (:func:`fit` runs its loop once per segment, on that
        segment's rows) and merges here, as one-shot model averaging
        does; the default is the replicated carry of a pure-UDA task,
        which every segment holds alike."""
        return states[0]

    def iteration(self, state, run_pass) -> tuple[Any, Any, torch.Tensor]:
        """One driver round: (new_state, agg_out, metric).  Override for
        multi-statement iterations; call ``run_pass(aggregate)`` once per
        data pass your dataflow needs."""
        out = run_pass(self.make_aggregate(state))
        new = self.update(state, out)
        return new, out, self.metric(state, new, out)


@dataclasses.dataclass
class FitResult:
    """Outcome of an iterative fit.

    ``state`` is the final driver state, ``result`` is
    ``task.finalize(state, last agg_out)``.  ``trace`` is the tree of
    stacked per-iteration :meth:`IterativeTask.trace_record` values
    (leading axis = iterations actually run; for grouped fits the group
    axis leads).  ``n_iters``/``converged`` are scalars — per-group numpy
    vectors for :func:`fit_grouped`.  ``stats`` carries engine
    diagnostics (grouped fits record the layout, per-round active-row
    counts and total row blocks scanned); None for engines that report
    nothing.
    """

    state: Any
    result: Any
    n_iters: Any
    converged: Any
    trace: Any
    stats: Any = None


def _as_state(tree, device: torch.device):
    """A task's state tree (tensors, numpy arrays, numbers) as tensors on
    ``device``, in the dtypes the task chose."""
    return tree_map(lambda v: torch.as_tensor(v, device=device), tree)


def _warm_state(tree, device: torch.device):
    """A caller's warm start as tensors on ``device``, each leaf stored as
    :func:`as_column` stores caller data (the reference's
    ``jnp.asarray``)."""
    return tree_map(lambda v: as_column(v, device), tree)


# ---------------------------------------------------------------------------
# The controller.
# ---------------------------------------------------------------------------

def fit(task: IterativeTask, table: Table, *, max_iters: int = 100,
        tol: float | None = 1e-6, engine: str = "auto",
        mode: str = "compiled", block_size: int | None = None,
        mask: torch.Tensor | None = None, warm_start: Any = None,
        mesh=None, row_axes=None, jit: bool = True) -> FitResult:
    """Execute an :class:`IterativeTask` to convergence on one engine.

    ``engine``: "auto" (sharded iff a mesh is given or the table is
    distributed), "local" or "sharded" (local without a mesh, as in the
    reference).  ``mode``: "compiled" folds through :class:`PassRunner`,
    "host" through the recorded ``run_local`` / ``run_sharded``; both
    are one host loop that pulls the metric once per round (there is no
    fused device loop yet).  ``tol=None`` runs exactly ``max_iters``
    rounds.  ``warm_start`` seeds the driver state (skips
    ``task.init_state``).  ``jit`` either value: the same loop."""
    if engine not in ("auto", "local", "sharded"):
        raise ValueError(f"unknown engine {engine!r} (use 'auto', 'local' "
                         "or 'sharded'; streaming goes through fit_stream)")
    if mode not in ("host", "compiled"):
        raise ValueError(f"unknown mode {mode!r}")
    mesh, row_axes = table_mesh("fit", mesh, row_axes, table)
    if engine == "auto" or mesh is None:
        engine = "sharded" if mesh is not None else "local"
    columns = dict(table.columns)
    state0 = _warm_state(warm_start, table.device) \
        if warm_start is not None \
        else _as_state(task.init_state(columns), table.device)
    _record("fit", engine=engine, mode=mode)
    if engine == "local":
        runner = _EagerRunner(table, mask, block_size) if mode == "host" \
            else PassRunner(columns, mask, block_size)
        return _host_loop(task, runner, state0, max_iters, tol)
    if type(task).mesh_epilogue is not IterativeTask.mesh_epilogue:
        return _per_segment_fit(task, columns, mask, block_size, state0,
                                max_iters, tol, mesh, row_axes)
    runner = _EagerRunner(table, mask, block_size, mesh, row_axes) \
        if mode == "host" else PassRunner(columns, mask, block_size,
                                          row_axes, mesh)
    return _host_loop(task, runner, state0, max_iters, tol)


def _per_segment_fit(task, columns, mask, block_size, state0, max_iters,
                     tol, mesh, row_axes) -> FitResult:
    """A per-segment carry on a mesh: the task's loop once per segment,
    in segment order, over that segment's rows and mask, then
    ``task.mesh_epilogue`` of the final states (on the first segment's
    device).  Rounds, convergence and trace are the first segment's."""
    if mask is not None:
        columns = dict(columns, __mask__=mask)
    runs = []
    for part in _sh.segment_views(mesh, row_axes, columns):
        m = part.pop("__mask__", None)
        runs.append(_run_loop(task, PassRunner(part, m, block_size),
                              state0, max_iters, tol))
    home = mesh.segments(row_axes)[0]
    state = task.mesh_epilogue([_on_device(r[0], home) for r in runs])
    _, aux, n, converged, trace = runs[0]
    return FitResult(state, task.finalize(state, aux), n, converged, trace)


def fit_stream(task: IterativeTask,
               blocks_factory: Callable[[], Iterable[Columns]], *,
               max_iters: int = 100, tol: float | None = 1e-6,
               warm_start: Any = None, device=None) -> FitResult:
    """Out-of-core iteration: every round streams the blocks of a fresh
    ``blocks_factory()`` through
    :func:`~repro_torch.core.aggregates.run_stream`, with the state on
    ``device`` (the card unless ``device="cpu"``), so only one block at a
    time, and the next in flight, is on the device.  The driver state is
    ``warm_start``, or ``task.init_state`` of the first block of a fresh
    stream."""
    dev = resolve_device(device)
    if warm_start is not None:
        state0 = _warm_state(warm_start, dev)
    else:
        try:
            first = next(iter(blocks_factory()))
        except StopIteration:
            raise ValueError("fit_stream: blocks_factory() produced no "
                             "blocks — at least one block is required to "
                             "shape the driver state") from None
        state0 = _as_state(task.init_state(
            {k: as_column(v, dev) for k, v in first.items()}), dev)
    _record("fit", engine="stream")
    return _host_loop(task, _StreamRunner(blocks_factory, dev), state0,
                      max_iters, tol)


def _run_loop(task, runner, state0, max_iters, tol) -> tuple:
    """The paper-faithful driver: one engine call per pass, one scalar
    (the metric) pulled to the host per round.  Returns ``(state, last
    agg_out, rounds, converged, trace)``."""
    state = state0
    aux = None
    recs = []
    converged = False
    n = 0
    for n in range(1, max_iters + 1):
        state, aux, m = task.iteration(state, runner)
        recs.append(task.trace_record(state, aux, m))
        if tol is not None and float(m) < tol:
            converged = True
            break
    return state, aux, n, converged, tree_stack(recs) if recs else None


def _host_loop(task, runner, state0, max_iters, tol) -> FitResult:
    state, aux, n, converged, trace = _run_loop(task, runner, state0,
                                                max_iters, tol)
    return FitResult(state, task.finalize(state, aux), n, converged, trace)


# ---------------------------------------------------------------------------
# GROUP BY model fitting — one model per group, shared scans.
# ---------------------------------------------------------------------------

def fit_grouped(task: IterativeTask, table: Table, key_col: str,
                num_groups: int | None = None, *, max_iters: int = 100,
                tol: float | None = 1e-6, block_size: int | None = None,
                mask: torch.Tensor | None = None, warm_start: Any = None,
                layout: str = "auto", mesh=None, row_axes=None,
                jit: bool = True) -> FitResult:
    """Fit one model per group of ``key_col`` — MADlib's ``GROUP BY``
    model fitting, for every registered task.

    Two layouts share the controller:

    * ``layout="segment"`` — rows are permuted into group-aligned blocks
      once (:meth:`Table.group_by` + ``aligned_blocks``; the blocks of a
      group are contiguous), and every round folds each still-ACTIVE
      group's block range with one transition of that group's aggregate,
      merged into its init with the leaf combinators.  Per-round cost is
      O(active rows).  Requires the default single-scan ``iteration`` and
      leaf-wise merge combinators.
    * ``layout="masked"`` — the fallback (multi-statement ``iteration``
      overrides, generic-merge aggregates): every active group runs the
      task's pass over the full table under its group mask (O(G·n)).

    ``layout="auto"`` picks segment whenever the task supports it.
    Converged groups are frozen under both layouts; empty groups keep
    their init and still run ``final``, ``update`` and ``metric``.
    Returns a :class:`FitResult` whose ``state``/``result``/``trace``
    carry a leading group axis, whose ``n_iters``/``converged`` are
    per-group numpy vectors, and whose ``stats`` records the layout plus
    (segment) the per-round active-row counts and total blocks scanned.
    ``warm_start``, when given, must already be stacked per group.
    ``jit`` either value: the same loop.

    ``mesh`` (the table's when None) runs the segment layout sharded: the
    group-aligned blocks split into one whole-block chunk per segment
    (:meth:`~repro_torch.core.table.GroupedView.sharded_blocks`), a
    round folds each active group's blocks in every segment that holds
    some (one transition per segment and group), and the group's
    per-segment states merge in segment order before the driver update.
    The masked layout ignores ``mesh``, as the reference's does."""
    mesh, row_axes = table_mesh("fit_grouped", mesh, row_axes, table)
    cols = dict(table.columns)
    gids = cols.pop(key_col).to(torch.int32)
    if num_groups is None:
        num_groups = int(gids.max()) + 1
    G = num_groups
    if warm_start is not None:
        warm = _warm_state(warm_start, table.device)
        states0 = [tree_index(warm, g) for g in range(G)]
    else:
        s0 = _as_state(task.init_state(cols), table.device)
        states0 = [s0] * G

    if layout == "auto":
        layout = "segment" if _segment_task_ok(task, states0, cols) \
            else "masked"
    _record("fit", engine=f"grouped-{layout}", sharded=mesh is not None,
            groups=G)
    if layout == "segment":
        return _fit_grouped_segment(task, table, key_col, G, states0,
                                    max_iters, tol, block_size, mask,
                                    mesh, row_axes)
    if layout != "masked":
        raise ValueError(f"unknown layout {layout!r} "
                         "(use 'auto', 'segment' or 'masked')")
    return _fit_grouped_masked(task, cols, gids, G, states0, max_iters,
                               tol, block_size, mask)


def _segment_task_ok(task: IterativeTask, states0, cols) -> bool:
    """Segment layout needs the default single-scan iteration (multi-
    statement rounds drive the pass runner themselves) and an aggregate
    with leaf-wise merge combinators."""
    if type(task).iteration is not IterativeTask.iteration:
        return False
    try:
        agg = task.make_aggregate(states0[0])
        return probe_segment_ops(agg, cols) is not None
    except Exception:
        # as in the reference: an aggregate that cannot be built or probed
        # here goes to the masked layout, which surfaces the real error
        return False


def _grouped_loop(task, G, states0, max_iters, tol, device, round_fn,
                  on_round=None):
    """The frozen-group driver shared by both layouts.  ``round_fn(g,
    state)`` runs one round of group ``g``: ``(new, agg_out, metric)``;
    ``on_round(active)`` (optional) sees each round's active group ids
    first.  Returns the per-group lists and the round count."""
    eff_tol = np.inf if tol is None else tol
    states = list(states0)
    aux: list = [None] * G
    recs: list[list] = [[] for _ in range(G)]
    m_vec = np.full((G,), np.inf, np.float32)
    it_vec = np.zeros((G,), np.int32)
    rounds = 0
    while rounds < max_iters and bool((m_vec >= eff_tol).any()):
        act = np.nonzero(m_vec >= eff_tol)[0]
        if on_round is not None:
            on_round(act)
        ms = []
        for g in act:
            new, out, m = round_fn(int(g), states[g])
            states[g], aux[g] = new, out
            recs[g].append(task.trace_record(new, out, m))
            ms.append(torch.as_tensor(m, dtype=torch.float32,
                                      device=device))
        if tol is not None:  # counted mode keeps every group active
            # the one host pull of the round: every active group's metric
            m_vec[act] = torch.stack(ms).cpu().numpy()
        it_vec[act] += 1
        rounds += 1
    return states, aux, recs, m_vec, it_vec, rounds


def _grouped_result(task, G, tol, states, aux, recs, m_vec, it_vec,
                    stats) -> FitResult:
    n_max = int(it_vec.max()) if G else 0
    trace = None
    if n_max:
        # per-group traces, zero past each group's last round, truncated
        # to the longest-running group
        rec0 = recs[int(np.argmax(it_vec))][0]
        rows = [[recs[g][i] if i < it_vec[g]
                 else tree_map(torch.zeros_like, rec0)
                 for i in range(n_max)] for g in range(G)]
        trace = tree_stack([tree_stack(r) for r in rows])
    results = tree_stack([task.finalize(s, a) for s, a in zip(states, aux)])
    converged = np.zeros((G,), bool) if tol is None else m_vec < tol
    return FitResult(tree_stack(states), results, it_vec, converged, trace,
                     stats)


def _fit_grouped_masked(task, cols, gids, G, states0, max_iters, tol,
                        block_size, mask):
    """Masked fallback: every active group folds the full table per
    round."""
    base = mask if mask is not None \
        else torch.ones(gids.shape, dtype=torch.bool, device=gids.device)

    def round_fn(g, state):
        runner = PassRunner(cols, (gids == g) & base, block_size)
        return task.iteration(state, runner)

    out = _grouped_loop(task, G, states0, max_iters, tol, gids.device,
                        round_fn)
    return _grouped_result(task, G, tol, *out[:5], {"layout": "masked"})


def _block_pieces(nblk, start, per: int) -> list[list]:
    """Each group's blocks cut at the segment chunks of ``per`` blocks:
    ``[(segment, first block in the chunk, past its last), ...]`` in
    segment order."""
    pieces = []
    for g in range(len(nblk)):
        lo, hi, out = int(start[g]), int(start[g] + nblk[g]), []
        while lo < hi:
            s = lo // per
            stop = min(hi, (s + 1) * per)
            out.append((s, lo - s * per, stop - s * per))
            lo = stop
        pieces.append(out)
    return pieces


def _fit_grouped_segment(task, table, key_col, G, states0, max_iters, tol,
                         block_size, mask, mesh=None, row_axes=("data",)):
    """Partitioned layout: per round, one transition per still-active
    group over its contiguous range of group-aligned blocks (one per
    segment that holds some of them, on a mesh, merged in segment
    order).  Equal to the reference's block-by-block fold under the
    leaf-wise merge that this layout requires (bitwise on dyadic
    data)."""
    if type(task).iteration is not IterativeTask.iteration:
        raise ValueError("fit_grouped: layout='segment' requires the "
                         "default single-scan iteration(); multi-statement "
                         "tasks need layout='masked'")
    view = table.group_by(key_col, G)
    n = view.n_rows
    ops = probe_segment_ops(task.make_aggregate(states0[0]),
                            dict(view.table.columns))
    if ops is None:
        raise ValueError("fit_grouped: layout='segment' needs leaf-wise "
                         "merge combinators; use layout='masked'")

    # Group-aligned blocked layout, built once; the blocks of group g are
    # blocks [start[g], start[g] + nblk[g]).
    pmask = None if mask is None else view.permute(mask)
    bs = segment_block_size(n, G, block_size)
    if mesh is None:
        cols, valid, bgids = view.aligned_blocks(bs, pmask)
    else:
        cols, valid, bgids = view.sharded_blocks(mesh, row_axes, bs, pmask)
    bg = bgids.cpu().numpy()
    nblk = np.bincount(bg[bg < G], minlength=G)[:G].astype(np.int64)
    start = np.concatenate([[0], np.cumsum(nblk)])[:-1]
    if mesh is not None:
        # each segment's chunk of whole blocks, cut (views, or copies to
        # a segment's own device) once for the whole fit
        chunks = _sh.segment_views(mesh, row_axes,
                                   dict(cols, __valid__=valid))
        chunk_valid = [c.pop("__valid__") for c in chunks]
        pieces = _block_pieces(nblk, start,
                               len(bg) // _sh.mesh_segments(mesh, row_axes))
        home = mesh.segments(row_axes)[0]
    counts = view.counts.cpu().numpy().astype(np.int64)
    active_rows: list[int] = []
    blocks = [0]

    def on_round(act):
        # the round's statistics follow from the active set alone
        active_rows.append(int(counts[act].sum()))
        blocks[0] += int(nblk[act].sum())

    def fold(agg, part, vm, lo, hi):
        rows = slice(lo * bs, hi * bs)
        blk = {k: v[rows] for k, v in part.items()}
        return agg.transition(agg.init(blk), blk, vm[rows])

    def round_fn(g, state):
        agg = task.make_aggregate(state)
        merged = agg.init(cols)
        if mesh is None:
            bstates = [fold(agg, cols, valid, int(start[g]),
                            int(start[g] + nblk[g]))] if nblk[g] else []
        else:
            bstates = [_on_device(fold(agg, chunks[s], chunk_valid[s], lo,
                                       hi), home)
                       for s, lo, hi in pieces[g]]
        for bstate in bstates:
            merged = tree_map(_combine_leaf, ops, merged, bstate)
        out = agg.final(merged)
        new = task.update(state, out)
        return new, out, task.metric(state, new, out)

    out = _grouped_loop(task, G, states0, max_iters, tol, valid.device,
                        round_fn, on_round)
    rounds = out[5]
    stats = {
        "layout": "segment",
        "sharded": mesh is not None,
        "block_size": bs,
        "rounds": rounds,
        "blocks": blocks[0],
        "blocks_full_scan": rounds * int(nblk.sum()),
        "active_rows": np.asarray(active_rows, np.int32),
    }
    return _grouped_result(task, G, tol, *out[:5], stats)
