"""Table: the port's counterpart of the reference ``core/table.py``.

A :class:`Table` is a dict of equal-length *columns* (tensors whose
leading axis is the row axis) on one device.  Columns may be
multi-dimensional: a ``DOUBLE PRECISION[]`` feature column is an
``(n_rows, d)`` tensor, as the paper stores feature vectors in §4.1.
Computation runs where the table's tensors live; :meth:`from_columns`
puts them on the card unless the caller passes ``device="cpu"``.
Caller data is stored as the reference stores it (:func:`as_column`:
64-bit floats and ints narrowed to 32 bits, as JAX does with 64-bit
types off), and :meth:`Table.blocks` cuts a table into row blocks for
the stream engine.

The memo and versioning contracts are the reference's: one stable sort
per ``(table, key)`` (:meth:`Table.sort_permutation`), a ``group_by``
memo stamped with the table version, ``append`` bumping the version and
``invalidate`` bumping version and epoch.

A distributed table (:meth:`Table.distribute`, Greenplum's ``DISTRIBUTED
BY``) carries a :class:`~repro_torch.distributed.sharding.Mesh` and the
``row_axes`` its rows split over.  Its columns stay one tensor each, in
global row order, on the mesh's first segment device; segment ``s`` of
``p`` owns rows ``[s n / p, (s + 1) n / p)``, and the sharded engines
hand each segment its rows as views (copies where a segment runs on
another device).  Every table derived from a distributed one keeps its
mesh; :meth:`GroupedView.sharded_blocks` cuts the group-aligned layout
into whole-block chunks, one per segment.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import sharding as _sh
from .trace import record

Columns = Mapping[str, torch.Tensor]


def table_mesh(what: str, mesh, row_axes, table) -> tuple:
    """``(mesh, row_axes)`` of a statement: its own ``mesh`` or else the
    table's, and its ``row_axes`` or else the table's or ``("data",)``
    (the reference's defaulting).  A mesh that is not a
    :class:`~repro_torch.distributed.sharding.Mesh` raises
    ``TypeError``."""
    if mesh is None and table is not None:
        mesh = table.mesh
    if mesh is not None:
        _sh.check_mesh(mesh, what)
    axes = row_axes or (table.row_axes if table is not None else None)
    return mesh, tuple(axes or ("data",))


def _n_rows(columns: Columns) -> int:
    sizes = {k: v.shape[0] for k, v in columns.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"ragged table: column row counts differ: {sizes}")
    return next(iter(sizes.values()))


# 64-bit types as the reference stores them: JAX with 64-bit types off
# keeps float64 as float32, int64 as int32 (the low 32 bits) and
# complex128 as complex64.  Every other dtype is kept, uint64 included
# (the reference keeps its low 32 bits as uint32; the port's hashes read
# the same low 32 bits, see ``kernels/sketch_hash.as_u32``).
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
_INT32 = (-2 ** 31, 2 ** 31 - 1)


def stored_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a column of ``dtype`` is stored in (:func:`as_column`)."""
    return _NARROW.get(dtype, dtype)


def host_tensor(v) -> torch.Tensor:
    """``v`` as a tensor without narrowing: tensors as they are, numpy
    arrays and scalars shared where numpy allows, Python numbers and
    sequences as ``torch.as_tensor`` makes them (ints beyond int32 raise
    ``OverflowError``, as the reference's ``jnp.asarray`` does)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (np.ndarray, np.generic)):
        v = np.ascontiguousarray(v)
        return torch.from_numpy(v if v.flags.writeable else v.copy())
    t = torch.as_tensor(v)
    if t.dtype == torch.int64 and t.numel() and (
            int(t.min()) < _INT32[0] or int(t.max()) > _INT32[1]):
        raise OverflowError(f"Python int {int(t.abs().max())} out of "
                            "bounds for int32")
    return t


def as_column(v, device) -> torch.Tensor:
    """``v`` (a tensor, numpy array, Python number or sequence) on
    ``device`` in the dtype the reference's ``jnp.asarray`` gives it with
    64-bit types off: float64 -> float32, int64 -> int32 wrapping to the
    low 32 bits, complex128 -> complex64, Python ints and floats -> int32
    and float32; every other dtype unchanged.  The one conversion of
    every entry point that takes caller data."""
    t = host_tensor(v)
    return t.to(device=device, dtype=stored_dtype(t.dtype))


@dataclasses.dataclass(eq=False)
class Table:
    """Named columns sharing a leading row axis, on one device.
    ``mesh``/``row_axes`` record how rows are distributed (None and
    ``()`` for a local table); :meth:`distribute` sets them."""

    columns: dict[str, torch.Tensor]
    mesh: Any = None
    row_axes: Any = None
    # group_by memo: (key_col, num_groups) -> (version, GroupedView);
    # sort memo: key_col -> (version, (sorted_keys, perm)).  Entries are
    # stamped with the version they were built at, so every lookup
    # observes staleness.  Derived tables start with empty memos.
    _gb_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _sort_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # ``_version`` bumps on every mutation (append or invalidate),
    # ``_epoch`` only on invalidate: a fold state pinned at (v, e, r rows)
    # may be brought current by folding rows [r:] iff the epoch is e.
    _version: int = dataclasses.field(default=0, repr=False)
    _epoch: int = dataclasses.field(default=0, repr=False)
    # hooks ``hook(table)`` run after every version bump
    _mutation_hooks: list = dataclasses.field(default_factory=list,
                                              repr=False)

    def __post_init__(self):
        if self.mesh is not None:
            _sh.check_mesh(self.mesh, "Table")
        self.row_axes = tuple(self.row_axes or ())

    # -- construction ------------------------------------------------------
    @classmethod
    def from_columns(cls, columns, device=None) -> "Table":
        """Columns (tensors, numpy arrays or sequences) placed on
        ``device``: the card when ``None``, which raises without one."""
        dev = resolve_device(device)
        cols = {k: as_column(v, dev) for k, v in columns.items()}
        _n_rows(cols)
        return cls(cols)

    def distribute(self, mesh, row_axes=("data",)) -> "Table":
        """Split rows over ``row_axes`` of ``mesh`` (Greenplum's
        ``DISTRIBUTED BY``): the columns move to the mesh's first segment
        device, and segment ``s`` of ``p`` owns rows ``[s n / p, (s + 1)
        n / p)``.  Rows must divide the segment count; pad first with
        :meth:`pad_to`."""
        _sh.check_mesh(mesh, "Table.distribute")
        row_axes = tuple(row_axes)
        return Table(_sh.distribute_rows(mesh, row_axes, dict(self.columns)),
                     mesh, row_axes)

    # -- basic relational ops ----------------------------------------------
    @property
    def n_rows(self) -> int:
        return _n_rows(self.columns)

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(sorted(self.columns))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def select(self, *names: str) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.mesh,
                     self.row_axes)

    def _place_rows(self, columns: dict) -> dict:
        """Fresh columns of a table that keeps this one's distribution:
        as they are on a local table; on a distributed one, checked to
        divide the segment count and placed as :meth:`distribute`
        places them."""
        if self.mesh is None:
            return columns
        return _sh.distribute_rows(self.mesh, self.row_axes or ("data",),
                                   columns)

    def with_column(self, name: str, values) -> "Table":
        cols = dict(self.columns)
        cols[name] = as_column(values, self.device)
        _n_rows(cols)
        return Table(self._place_rows(cols), self.mesh, self.row_axes)

    def map_rows(self, fn: Callable[[Columns], Columns]) -> "Table":
        """Row-wise projection (a SELECT of expressions): ``fn`` maps the
        column dict to a new one of the same row count."""
        cols = {k: as_column(v, self.device)
                for k, v in dict(fn(self.columns)).items()}
        _n_rows(cols)
        return Table(self._place_rows(cols), self.mesh, self.row_axes)

    def pad_to(self, n: int, fill: float = 0.0
               ) -> tuple["Table", torch.Tensor]:
        """Pad to ``n`` rows with ``fill`` (cast to each column's dtype);
        returns the padded table and its bool validity mask (the first
        ``n_rows`` rows)."""
        cur = self.n_rows
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than n_rows={cur}")
        cols = {k: torch.cat([v, v.new_full((n - cur,) + tuple(v.shape[1:]),
                                            fill)])
                for k, v in self.columns.items()}
        mask = torch.arange(n, device=self.device) < cur
        if self.mesh is not None:
            placed = self._place_rows(dict(cols, __valid__=mask))
            mask = placed.pop("__valid__")
            cols = placed
        return Table(cols, self.mesh, self.row_axes), mask

    def blocks(self, block_size: int) -> Iterator["Table"]:
        """Row blocks of ``block_size`` consecutive rows (the last one
        ragged) as tables on this table's device: the stream engine's
        input, as ``dict(block.columns)``."""
        n = self.n_rows
        for start in range(0, n, block_size):
            stop = min(start + block_size, n)
            yield Table({k: v[start:stop] for k, v in self.columns.items()},
                        self.mesh, self.row_axes)

    # -- versioning --------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotonic mutation counter, bumped by :meth:`append` and
        :meth:`invalidate`."""
        return self._version

    @property
    def epoch(self) -> int:
        """Bumped only by :meth:`invalidate`: while it is unchanged the
        row prefix seen at any earlier version is intact."""
        return self._epoch

    def append(self, columns: Columns) -> "Table":
        """Append rows in place and bump :attr:`version` (not the epoch).
        ``columns`` must carry exactly this table's columns with matching
        dtypes and trailing shapes.  Returns ``self``."""
        new = {k: as_column(v, self.device) for k, v in columns.items()}
        if set(new) != set(self.columns):
            raise ValueError(
                f"append columns {sorted(new)} != table columns "
                f"{sorted(self.columns)}")
        _n_rows(new)
        cols = {}
        for k, old in self.columns.items():
            v = new[k]
            if v.dtype != old.dtype:
                raise ValueError(
                    f"append column {k!r}: dtype {v.dtype} != {old.dtype}")
            if v.shape[1:] != old.shape[1:]:
                raise ValueError(
                    f"append column {k!r}: trailing shape "
                    f"{tuple(v.shape[1:])} != {tuple(old.shape[1:])}")
            cols[k] = torch.cat([old, v], dim=0)
        cols = self._place_rows(cols)
        self.columns.clear()
        self.columns.update(cols)
        self._version += 1
        self._notify_mutation()
        return self

    def invalidate(self) -> None:
        """Declare arbitrary in-place mutation: drop the memos and bump
        both :attr:`version` and :attr:`epoch`."""
        self._gb_cache.clear()
        self._sort_cache.clear()
        self._version += 1
        self._epoch += 1
        self._notify_mutation()

    def on_mutation(self, hook: Callable[["Table"], None]) -> None:
        """Register ``hook(table)`` to run after every version bump."""
        self._mutation_hooks.append(hook)

    def remove_mutation_hook(self, hook: Callable[["Table"], None]) -> None:
        """Deregister a :meth:`on_mutation` hook (no-op if absent)."""
        if hook in self._mutation_hooks:
            self._mutation_hooks.remove(hook)

    def _notify_mutation(self) -> None:
        for hook in list(self._mutation_hooks):
            hook(self)

    # -- partitioning ------------------------------------------------------
    def sort_permutation(self, key_col: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Memoized stable sort of one column: ``(sorted_keys, perm)``
        with ``sorted_keys == self[key_col][perm]`` and ``perm`` int32.
        A miss records one ``kind="sort"`` event; a hit records none."""
        hit = self._sort_cache.get(key_col)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        record("sort", key_col=key_col, n_rows=self.n_rows, table=id(self))
        keys = self.columns[key_col]
        sorted_keys, perm = torch.sort(keys, stable=True)
        out = (sorted_keys, perm.to(torch.int32))
        self._sort_cache[key_col] = (self._version, out)
        return out

    def group_by(self, key_col: str, num_groups: int | None = None
                 ) -> "GroupedView":
        """Partition rows by an integer group-id column (sort once, scan
        many), memoized per ``(key_col, num_groups)`` and stamped with the
        table version.  Out-of-range ids keep their rows in the permuted
        table but outside every segment."""
        view = self.cached_group_by(key_col, num_groups)
        if view is not None:
            return view
        view = self._group_by_uncached(key_col, num_groups)
        self._gb_cache[(key_col, num_groups)] = (self._version, view)
        self._gb_cache[(key_col, view.num_groups)] = (self._version, view)
        return view

    def cached_group_by(self, key_col: str, num_groups: int | None = None
                        ) -> "GroupedView | None":
        """The memoized view if it was built at the current version, else
        ``None``.  Never sorts."""
        hit = self._gb_cache.get((key_col, num_groups))
        if hit is None or hit[0] != self._version:
            return None
        return hit[1]

    def _group_by_uncached(self, key_col: str, num_groups: int | None
                           ) -> "GroupedView":
        sorted_keys, perm = self.sort_permutation(key_col)
        sorted_gids = sorted_keys.to(torch.int32)
        if num_groups is None:
            num_groups = int(sorted_gids.max()) + 1
        offsets = torch.searchsorted(
            sorted_gids, torch.arange(num_groups + 1, dtype=torch.int32,
                                      device=sorted_gids.device),
            out_int32=True)
        idx = perm.long()
        data = {k: v[idx] for k, v in self.columns.items() if k != key_col}
        return GroupedView(Table(data, self.mesh, self.row_axes),
                           sorted_gids, perm, num_groups,
                           torch.diff(offsets), offsets)


@dataclasses.dataclass(eq=False)
class GroupedView:
    """Partitioned ``GROUP BY`` layout of a :class:`Table`: data columns
    (group-id column stripped) permuted so group ``g`` occupies rows
    ``offsets[g]:offsets[g + 1]``."""

    table: Table
    gids: torch.Tensor         # (n,) int32, sorted ascending
    perm: torch.Tensor         # (n,) int32, partitioned position -> row
    num_groups: int
    counts: torch.Tensor       # (G,) int32 rows per group
    offsets: torch.Tensor      # (G + 1,) int32 segment boundaries

    @property
    def n_rows(self) -> int:
        return self.table.n_rows

    def select(self, *names: str) -> "GroupedView":
        """Subset of data columns sharing this view's partitioning."""
        return GroupedView(self.table.select(*names), self.gids, self.perm,
                           self.num_groups, self.counts, self.offsets)

    def permute(self, rows) -> torch.Tensor:
        """Bring a row-aligned tensor (a base mask) into partitioned
        order."""
        rows = as_column(rows, self.perm.device)
        return rows[self.perm.long()]

    def aligned_blocks(self, block_size: int, base_mask=None, *,
                       pad_blocks_to: int | None = None):
        """Group-aligned blocked layout: every group's segment zero-padded
        to whole ``block_size`` row blocks, so each block holds rows of
        exactly one group.

        Returns ``(columns, valid, block_gids)``: columns with leading
        axis ``n_blocks * block_size``, a bool mask over real (and
        base-mask-passing) rows, and each block's int32 group id.  Empty
        groups get no blocks; ``pad_blocks_to`` rounds the block count up
        to a multiple with sentinel blocks (gid ``num_groups``, every row
        invalid).  The index build runs on the host, as in the
        reference; only the index tensors move to the device."""
        bs = int(block_size)
        dev = self.gids.device
        counts = self.counts.cpu().numpy().astype(np.int64)
        starts = self.offsets.cpu().numpy().astype(np.int64)[:-1]
        bpg = -(-counts // bs)  # blocks per group (0 for empty groups)
        bg_np = np.repeat(np.arange(self.num_groups), bpg).astype(np.int32)
        ppg = bpg * bs          # padded rows per group
        n2 = int(ppg.sum())
        if n2 == 0:
            # no real blocks: still honour pad_blocks_to with sentinel
            # blocks, constructed (the table may have 0 rows)
            pad = int(pad_blocks_to) if pad_blocks_to else 0
            cols = {k: torch.zeros((pad * bs,) + tuple(v.shape[1:]),
                                   dtype=v.dtype, device=dev)
                    for k, v in self.table.columns.items()}
            return (cols, torch.zeros((pad * bs,), dtype=torch.bool,
                                      device=dev),
                    torch.full((pad,), self.num_groups, dtype=torch.int32,
                               device=dev))
        grp = np.repeat(np.arange(self.num_groups), ppg)
        out_start = np.concatenate([[0], np.cumsum(ppg)])[:-1]
        local = np.arange(n2) - out_start[grp]
        valid_np = local < counts[grp]
        src_np = np.where(valid_np, starts[grp] + local, 0)
        if pad_blocks_to:
            extra = -len(bg_np) % int(pad_blocks_to)
            if extra:
                bg_np = np.concatenate(
                    [bg_np, np.full(extra, self.num_groups, np.int32)])
                src_np = np.concatenate(
                    [src_np, np.zeros(extra * bs, np.int64)])
                valid_np = np.concatenate(
                    [valid_np, np.zeros(extra * bs, bool)])
        src = torch.from_numpy(src_np.astype(np.int64)).to(dev)
        cols = {k: v[src] for k, v in self.table.columns.items()}
        valid = torch.from_numpy(valid_np).to(dev)
        if base_mask is not None:
            valid = valid & as_column(base_mask, dev)[src]
        return cols, valid, torch.from_numpy(bg_np).to(dev)

    def sharded_blocks(self, mesh, row_axes=("data",),
                       block_size: int = 4096, base_mask=None):
        """:meth:`aligned_blocks` for the segments of ``mesh``: the block
        count padded to a multiple of the segment count (sentinel
        blocks), so segment ``s`` of ``p`` owns the contiguous whole-block
        chunk ``s`` of the rows, the valid mask and the block ids, the
        MADlib two-phase layout.  Placed as :meth:`Table.distribute`
        places columns."""
        _sh.check_mesh(mesh, "GroupedView.sharded_blocks")
        row_axes = tuple(row_axes)
        segs = _sh.mesh_segments(mesh, row_axes)
        cols, valid, bgids = self.aligned_blocks(block_size, base_mask,
                                                 pad_blocks_to=segs)
        placed = _sh.distribute_rows(mesh, row_axes,
                                     dict(cols, __valid__=valid))
        valid = placed.pop("__valid__")
        bgids = _sh.distribute_rows(mesh, row_axes, {"b": bgids})["b"]
        return placed, valid, bgids


def synthetic_regression_table(seed: int, n_rows: int, n_vars: int,
                               noise: float = 0.1,
                               dtype: Any = torch.float32, device=None
                               ) -> tuple[Table, torch.Tensor]:
    """The paper's linregr benchmark data, y = <b, x> + eps (§4.4), made
    on ``device`` (the card unless ``device="cpu"``) from an explicit
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    x = torch.randn((n_rows, n_vars), generator=gen, dtype=dtype,
                    device=dev)
    b = torch.randn((n_vars,), generator=gen, dtype=dtype, device=dev)
    eps = torch.randn((n_rows,), generator=gen, dtype=dtype, device=dev)
    y = x @ b + noise * eps
    return Table({"x": x, "y": y}), b


def _generator(seed, device: torch.device) -> torch.Generator:
    """``seed`` as a generator on ``device``: an int seeds a new one, a
    ``torch.Generator`` is used as given."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def synthetic_classification_table(seed, n_rows: int, n_vars: int,
                                   dtype: Any = torch.float32, device=None
                                   ) -> tuple[Table, torch.Tensor]:
    """Logistic data, Pr[y = 1 | x] = sigmoid(<b, x>) (§4.2), made on
    ``device`` (the card unless ``device="cpu"``) from an explicit seed or
    ``torch.Generator`` (on that device)."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    x = torch.randn((n_rows, n_vars), generator=gen, dtype=dtype,
                    device=dev)
    b = torch.randn((n_vars,), generator=gen, dtype=dtype, device=dev)
    p = torch.sigmoid(x @ b)
    u = torch.rand((n_rows,), generator=gen, dtype=dtype, device=dev)
    y = (u < p).to(dtype)
    return Table({"x": x, "y": y}), b
