"""Device-side sort-merge equi-join: star-schema GROUP BY without
materializing the joined table.

The port's counterpart of the reference ``core/join.py``.  The canonical
in-database workload is a fact table joined to a small dimension and
aggregated by a dimension attribute::

    SELECT dim.attr, agg(fact.cols...)
    FROM fact JOIN dim ON fact.fk = dim.key
    GROUP BY dim.attr

A :class:`Join` is resolved to exactly ONE new column, a fact-aligned
``int32`` group-id vector, and everything downstream is the unchanged
grouped core:

* the dimension side pays ONE memoized stable sort of its key column
  (:meth:`Table.sort_permutation`, shared with any GROUP BY over the
  same key);
* fact foreign keys are resolved on the device by ``torch.searchsorted``
  (``side="left"``) against the sorted dimension keys; the matched row's
  ``attr`` value IS the group id, so duplicate attribute values collapse
  into one group as SQL's ``GROUP BY dim.attr`` does;
* dangling foreign keys follow ``on_missing=``: ``"error"`` raises with
  the dangling count, ``"drop"`` assigns the sentinel id ``-1``, which
  :meth:`Table.group_by` keeps outside every segment;
* duplicate dimension KEYS are always rejected (an equi-join against a
  non-unique key is a fan-out, not a dimension lookup).

Resolution is memoized per ``(fact, dim, fact_key, dim_key, attr_col,
on_missing)`` and stamped with BOTH tables' versions, so every joined
statement over one star triple shares one resolution and, through the
shared joined table, one fact-side partitioning sort.  The memo holds
its tables by ``weakref``: a finalizer drops a collected table's
entries (and the joined columns they hold) before its id can be reused.
One lock guards the memo's lookups and fills and the dimension's sort
memo, since two drains of different fact tables may resolve against one
dimension at once; the fact-side match runs outside it, under a lock of
its spec alone, so resolutions of unrelated tables overlap.

Over a distributed fact table the dimension's sorted keys and attributes
are replicated to each segment's device and every segment resolves its
own rows' foreign keys there (the fact keys stay row-split); the joined
table keeps the fact's mesh, so its grouped pass runs sharded.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref

import torch

from ..distributed import sharding as _sh
from .table import Table
from .trace import record

__all__ = ["Join", "JoinResolution", "JOIN_GID_COL"]

# The resolved group-id column spliced onto the fact table; internal to
# the join layer (methods hand a Join to the plan layer).
JOIN_GID_COL = "__join_gid__"

_ON_MISSING = ("error", "drop")


@dataclasses.dataclass(frozen=True)
class JoinResolution:
    """Outcome of resolving a :class:`Join`: the fact table extended with
    the fact-aligned group-id column (``table[gid_col]``), ready for
    ``group_by(gid_col, num_groups)``.  ``dangling`` counts fact rows
    whose foreign key matched no dimension row (non-zero only under
    ``on_missing="drop"``)."""

    table: Table
    gid_col: str
    num_groups: int
    dangling: int


@dataclasses.dataclass(eq=False)
class Join:
    """Logical equi-join spec: ``fact JOIN dim ON fact[fact_key] ==
    dim[dim_key]``, grouping by the dimension attribute ``attr_col`` (an
    integer column on ``dim``).  Cheap to construct; :meth:`resolve` does
    the work, memoized across Join instances with equal spec keys."""

    fact: Table
    dim: Table
    fact_key: str
    dim_key: str
    attr_col: str
    on_missing: str = "error"   # "error" | "drop"

    def __post_init__(self):
        if self.on_missing not in _ON_MISSING:
            raise ValueError(
                f"Join: on_missing={self.on_missing!r} — expected one of "
                f"{_ON_MISSING} (an implicit policy for dangling foreign "
                f"keys would silently change results)")
        for table, col, side in ((self.fact, self.fact_key, "fact"),
                                 (self.dim, self.dim_key, "dim"),
                                 (self.dim, self.attr_col, "dim")):
            if col not in table.columns:
                raise KeyError(
                    f"Join: column {col!r} not on the {side} table "
                    f"(has {sorted(table.columns)})")

    # -- identity ----------------------------------------------------------
    def spec_key(self) -> tuple:
        """Fusion/memo identity (tables by object identity, like every
        plan-layer fusion key)."""
        return (id(self.fact), id(self.dim), self.fact_key, self.dim_key,
                self.attr_col, self.on_missing)

    def attr_groups(self) -> int:
        """Group count of the join's GROUP BY: ``max(dim.attr) + 1`` (0
        for an empty dimension); safe at plan and explain time."""
        if self.dim.n_rows == 0:
            return 0
        return int(self.dim[self.attr_col].to(torch.int32).max()) + 1

    # -- resolution --------------------------------------------------------
    def resolve(self) -> JoinResolution:
        """Sort-merge key resolution, memoized on both tables' versions.
        A memo miss records one ``kind="join"`` trace event; hits are
        silent."""
        key = self.spec_key()
        with _LOCK:
            _watch(self.fact)
            _watch(self.dim)
            spec_lock = _SPEC_LOCKS.setdefault(key, threading.Lock())
        with spec_lock:
            fact_v, dim_v = self.fact.version, self.dim.version
            with _LOCK:
                hit = _RESOLUTIONS.get(key)
                if hit is not None and hit.fact() is self.fact \
                        and hit.dim() is self.dim \
                        and (hit.fact_version, hit.dim_version) \
                        == (fact_v, dim_v):
                    return hit.resolution
                # the dimension's sort memo (the group_by memo's sort, if
                # anyone grouped the dimension by this key already)
                ordered = (self.dim.sort_permutation(self.dim_key)
                           if self.dim.n_rows else None)
            res = self._resolve_uncached(ordered)
            with _LOCK:
                if len(_RESOLUTIONS) >= _RESOLUTIONS_MAX:
                    _RESOLUTIONS.pop(next(iter(_RESOLUTIONS)), None)
                _RESOLUTIONS[key] = _Memo(
                    weakref.ref(self.fact), weakref.ref(self.dim), fact_v,
                    dim_v, res)
            return res

    def _resolve_uncached(self, ordered) -> JoinResolution:
        n_fact, n_dim = self.fact.n_rows, self.dim.n_rows
        record("join", fact=id(self.fact), dim=id(self.dim),
               fact_rows=n_fact, dim_rows=n_dim,
               on=f"{self.fact_key}={self.dim_key}", attr=self.attr_col)
        fk = self.fact[self.fact_key]
        if n_dim == 0:
            if self.on_missing == "error":
                raise ValueError(
                    f"Join: empty dimension — every foreign key of "
                    f"{self.fact_key!r} is dangling ({n_fact} rows); "
                    "use on_missing='drop' to aggregate over no groups")
            gids = torch.full((n_fact,), -1, dtype=torch.int32,
                              device=fk.device)
            return self._finish(gids, num_groups=0, dangling=n_fact)

        sorted_keys, perm = ordered
        if n_dim > 1 and bool((sorted_keys[1:] == sorted_keys[:-1]).any()):
            raise ValueError(
                f"Join: duplicate keys in dim[{self.dim_key!r}] — an "
                "equi-join against a non-unique dimension key is a "
                "fan-out, not a dimension lookup; deduplicate the "
                "dimension first")
        sorted_attr = self.dim[self.attr_col][perm.long()].to(torch.int32)
        num_groups = int(sorted_attr.max()) + 1

        # searchsorted wants one dtype: the common one, as jnp promotes
        common = torch.promote_types(sorted_keys.dtype, fk.dtype)
        keys = sorted_keys.to(common).contiguous()
        fkc = fk.to(common).contiguous()
        attr = sorted_attr
        if self.fact.mesh is not None:
            # the broadcast side of the star: the dimension on every
            # segment's device, each segment matching its own fact rows
            mesh, axes = self.fact.mesh, self.fact.row_axes or ("data",)
            keys_on = _sh.replicate(mesh, keys, axes)
            attr_on = _sh.replicate(mesh, sorted_attr, axes)
            home = fkc.device
            parts = [self._match(keys_on[p["fk"].device],
                                 attr_on[p["fk"].device], p["fk"], n_dim)
                     for p in _sh.segment_views(mesh, axes, {"fk": fkc})]
            matched = torch.cat([m.to(home) for m, _ in parts])
            gids = torch.cat([g.to(home) for _, g in parts])
        else:
            matched, gids = self._match(keys, attr, fkc, n_dim)
        dangling = int((~matched).sum())
        if dangling and self.on_missing == "error":
            raise ValueError(
                f"Join: {dangling} of {n_fact} fact rows have foreign "
                f"keys ({self.fact_key!r}) matching no dim[{self.dim_key!r}] "
                "row; fix the data or pass on_missing='drop' to exclude "
                "them from every group")
        return self._finish(gids, num_groups=num_groups, dangling=dangling)

    @staticmethod
    def _match(keys, attr, fk, n_dim: int):
        """``(matched, gids)`` of foreign keys ``fk`` against the sorted
        dimension ``keys``/``attr`` on one device; unmatched rows get
        gid -1."""
        pos = torch.searchsorted(keys, fk, side="left").clamp_(0, n_dim - 1)
        matched = keys[pos] == fk
        gid = attr[pos]
        return matched, torch.where(matched, gid, torch.full_like(gid, -1))

    def _finish(self, gids: torch.Tensor, *, num_groups: int,
                dangling: int) -> JoinResolution:
        # a FRESH table (empty memos): the joined table's own
        # partitioning sort is shared by every statement that reaches it
        # through the resolution memo
        joined = self.fact.with_column(JOIN_GID_COL, gids)
        return JoinResolution(joined, JOIN_GID_COL, num_groups, dangling)


@dataclasses.dataclass(frozen=True)
class _Memo:
    fact: weakref.ref
    dim: weakref.ref
    fact_version: int
    dim_version: int
    resolution: JoinResolution


# spec key -> _Memo; module-level (Joins are throwaway specs), bounded
# FIFO.  _LOCK guards the memo, the per-spec locks, the finalizers and
# the dimension sort a resolution fills.
_RESOLUTIONS: dict[tuple, _Memo] = {}
_RESOLUTIONS_MAX = 64
_SPEC_LOCKS: dict[tuple, threading.Lock] = {}
_WATCHED: dict[int, weakref.finalize] = {}
_LOCK = threading.RLock()


def _watch(table: Table) -> None:
    """Register the finalizer that purges ``table``'s memo entries.
    Caller holds ``_LOCK``."""
    tid = id(table)
    if tid not in _WATCHED:
        fin = weakref.finalize(table, _table_died, tid)
        fin.atexit = False
        _WATCHED[tid] = fin


def _table_died(tid: int) -> None:
    """Finalizer of a watched table (it may run on any thread): drop
    every entry keyed by its id before the id is recycled."""
    with _LOCK:
        _WATCHED.pop(tid, None)
        for memo in (_RESOLUTIONS, _SPEC_LOCKS):
            for key in [k for k in memo if tid in k[:2]]:
                memo.pop(key, None)
