"""Row sharding of a table over a single-controller mesh of segments.

The port's counterpart of the rows half of the reference
``distributed/sharding.py``.  The reference places a ``DISTRIBUTED BY``
table with a ``NamedSharding`` and runs one ``shard_map`` program over
the mesh; here one process drives every segment:

* a :class:`Mesh` names its axes and holds a ``torch.device`` per
  position, and one device may appear at several positions (Greenplum
  runs several segments on one host, so one card can hold the paper's
  24 segments);
* a distributed table keeps one tensor per column, in global row order,
  on the mesh's first segment device; segment ``s`` of ``p`` owns rows
  ``[s n / p, (s + 1) n / p)``, the split ``P(row_axes)`` makes;
* :func:`segment_views` hands each segment its rows: a view where the
  segment's device holds the column, a copy (recorded as a
  ``kind="copy"`` trace event) where it does not.

Merges across segments are left folds in segment order (the engines in
``core/aggregates.py``), never a collective whose order is not fixed.

The LM half maps the model's logical axis names onto mesh axes
(:data:`DEFAULT_RULES`, :func:`to_pspec`) and describes a tensor's
placement as a :class:`NamedSharding` of a :class:`PartitionSpec`: one
global tensor on the mesh's first device, and the slice of it that each
mesh position owns (:meth:`NamedSharding.index`).  Code that the
reference runs under ``shard_map`` loops over the positions in order
(``decode``, ``ep_a2a``, ``pipeline``, ``compression`` and the sharded
train step).  :func:`constrain` checks the logical spec and returns its
tensor: a global tensor already holds what the partitioned program
computes, so a forward under :func:`activation_sharding` is bitwise the
unsharded one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Sequence

import numpy as np
import torch


def record(kind: str, **detail) -> None:
    """``core.trace.record``, imported at the call: ``core`` imports this
    module, and a model module may import it first."""
    from ..core.trace import record as _record
    _record(kind, **detail)


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current card, and a CUDA device without a card raises as
    ``resolve_device`` does."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; build the mesh from "
                "devices=[\"cpu\"] * n to run the plain PyTorch versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an object array of ``torch.device`` (one per mesh
    position).  ``shape`` maps each axis name to its size, as the
    reference's ``jax.sharding.Mesh.shape`` does, so the planner's cost
    functions take either mesh."""

    def __init__(self, devices, axis_names: Sequence[str]):
        names = tuple(axis_names)
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"Mesh: {src.ndim}-d devices for axes {names}")
        arr = np.empty(src.size, dtype=object)
        arr[:] = [as_device(d) for d in src.reshape(-1)]
        self.devices = arr.reshape(src.shape)
        self.axis_names = names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def segments(self, row_axes: Sequence[str] = ("data",)
                 ) -> list[torch.device]:
        """The devices of the segments that rows split over: positions
        along ``row_axes`` in row-major order (the first axis named
        slowest), the other axes at position 0 (rows are replicated
        along them)."""
        row_axes = tuple(row_axes)
        unknown = [a for a in row_axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"Mesh: row axes {unknown} not in "
                             f"{self.axis_names}")
        order = list(row_axes) + [a for a in self.axis_names
                                  if a not in row_axes]
        arr = np.transpose(self.devices,
                           [self.axis_names.index(a) for a in order])
        lead = int(np.prod([self.shape[a] for a in row_axes]))
        arr = arr.reshape((lead, -1)) if arr.size else arr.reshape((0, 1))
        return list(arr[:, 0])


def check_mesh(mesh, what: str) -> "Mesh":
    """``mesh`` if it is a :class:`Mesh`; anything else raises
    ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh must be a repro_torch Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return mesh


def mesh_segments(mesh: Mesh | None, row_axes=("data",)) -> int:
    """How many segments rows split over: 1 without a mesh; ``row_axes``
    None means ``("data",)``."""
    if mesh is None:
        return 1
    axes = tuple(row_axes or ("data",))
    return int(np.prod([mesh.shape[a] for a in axes]))


def row_sharding(mesh: Mesh, row_axes=("data",), n_rows: int = 0
                 ) -> list[tuple[torch.device, int, int]]:
    """Each segment's ``(device, start, stop)``: equal contiguous row
    ranges in segment order.  ``n_rows`` must divide the segment count
    (pad first, :meth:`~repro_torch.core.table.Table.pad_to`)."""
    devs = mesh.segments(row_axes)
    p = len(devs)
    if n_rows % p:
        raise ValueError(f"n_rows={n_rows} not divisible by {p} segments; "
                         "pad first")
    step = n_rows // p
    return [(d, s * step, (s + 1) * step) for s, d in enumerate(devs)]


def distribute_rows(mesh: Mesh, row_axes, columns: dict) -> dict:
    """The columns of a distributed table: each on the mesh's first
    segment device, in global row order.  Row counts must divide the
    segment count."""
    first = mesh.segments(row_axes)[0]
    for v in columns.values():
        row_sharding(mesh, row_axes, v.shape[0])
    return {k: v.to(first) for k, v in columns.items()}


def replicate(mesh: Mesh, tensor: torch.Tensor, row_axes=("data",)
              ) -> dict[torch.device, torch.Tensor]:
    """``tensor`` on every device a segment of ``mesh`` runs on (the
    broadcast side of a star join, ``core/join.py``): the tensor itself
    where it already lives, one copy per other device."""
    out: dict[torch.device, torch.Tensor] = {}
    for d in mesh.segments(row_axes):
        if d not in out:
            out[d] = tensor if tensor.device == d else tensor.to(d)
    return out


def segment_views(mesh: Mesh, row_axes, tensors: dict) -> list[dict]:
    """Each segment's rows of ``tensors`` (a dict of row-leading tensors
    of one row count): a view where the segment's device holds the
    tensor, else a copy to that device, recorded as one ``kind="copy"``
    trace event per segment."""
    n = next(iter(tensors.values())).shape[0]
    out = []
    for s, (dev, a, b) in enumerate(row_sharding(mesh, row_axes, n)):
        part, moved = {}, 0
        for k, v in tensors.items():
            piece = v[a:b]
            if piece.device != dev:
                piece = piece.to(dev)
                moved += piece.numel() * piece.element_size()
            part[k] = piece
        if moved:
            record("copy", segment=s, device=str(dev), bytes=moved)
        out.append(part)
    return out


# ---------------------------------------------------------------------------
# The LM half: logical axes -> mesh axes
# ---------------------------------------------------------------------------

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "tensor": "model",
    "vocab": "model",
    "expert": "model",
    "layers": None,
}

_ctx = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dimension splits over their product,
    the first named axis slowest).  A one-name tuple is that name and an
    empty one is None, as JAX canonicalises them."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _canonical(entry):
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


def row_pspec(row_axes=("data",), ndim: int = 1) -> PartitionSpec:
    """The spec that splits the leading (row) axis over ``row_axes`` and
    replicates the rest (the reference's in_spec of a row-leading array);
    :func:`row_sharding` gives its row ranges."""
    return PartitionSpec(tuple(row_axes), *([None] * (ndim - 1)))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`: the tensor stays one
    global tensor, and the position ``pos`` (one index per mesh axis)
    owns the slice :meth:`index` gives, on ``mesh.devices[pos]``."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        unknown = [a for e in self.spec for a in _names(e)
                   if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"NamedSharding: axes {unknown} not in "
                             f"{mesh.axis_names}")

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def positions(self) -> list[tuple[int, ...]]:
        """Every mesh position, in row-major order."""
        return list(np.ndindex(*self.mesh.devices.shape))

    def device(self, pos: tuple[int, ...]) -> torch.device:
        return self.mesh.devices[tuple(pos)]

    def index(self, pos: tuple[int, ...], shape) -> tuple[slice, ...]:
        """The slices of a tensor of ``shape`` that position ``pos``
        owns: dimension d splits into :meth:`parts` equal ranges, and
        ``pos`` takes the range its coordinates on the dimension's axes
        number (row-major over the named axes)."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"NamedSharding: spec {self.spec} has more "
                             f"entries than the shape {shape}")
        out = []
        for d, n in enumerate(shape):
            names = _names(self.spec[d]) if d < len(self.spec) else ()
            if not names:
                out.append(slice(0, n))
                continue
            sizes = [self.mesh.shape[a] for a in names]
            coords = [pos[self.mesh.axis_names.index(a)] for a in names]
            k = int(np.ravel_multi_index(coords, sizes))
            p = int(np.prod(sizes))
            if n % p:
                raise ValueError(f"NamedSharding: dimension {d} of {shape} "
                                 f"does not split into {p} parts")
            out.append(slice(k * n // p, (k + 1) * n // p))
        return tuple(out)

    def check(self, shape, device=None, what: str = "NamedSharding"
              ) -> None:
        """Raise ``ValueError`` unless a tensor of ``shape`` splits into
        every position's slice and, where ``device`` is given, lives on
        the mesh's first position: one controller keeps the global tensor
        there."""
        for pos in self.positions():
            self.index(pos, shape)
        home = self.mesh.devices.flat[0]
        if device is not None and torch.device(device) != home:
            raise ValueError(f"{what}: on {device}, its sharding's global "
                             f"tensor on {home}")


def _mesh_axes(mesh: Mesh) -> set[str]:
    return set(mesh.axis_names)


def to_pspec(logical: tuple, mesh: Mesh, rules: dict | None = None
             ) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec valid on
    ``mesh``: each name through ``rules``, keeping only the mesh axes
    that ``mesh`` has."""
    rules = rules or DEFAULT_RULES
    axes = _mesh_axes(mesh)
    out = []
    for name in logical:
        m = None if name is None else rules.get(name)
        if m is None:
            out.append(None)
        elif isinstance(m, tuple):
            kept = tuple(a for a in m if a in axes)
            out.append(kept if kept else None)
        else:
            out.append(m if m in axes else None)
    return PartitionSpec(*out)


def _divisible(dim: int, spec_entry, mesh: Mesh) -> bool:
    if spec_entry is None:
        return True
    total = int(np.prod([mesh.shape[a] for a in _names(spec_entry)]))
    return dim % total == 0


def _fit(spec: PartitionSpec, shape, mesh: Mesh) -> PartitionSpec:
    """``spec`` with every entry whose dimension does not divide its mesh
    extent replaced by None (replicated)."""
    return PartitionSpec(*(
        None if e is not None and i < len(shape)
        and not _divisible(shape[i], e, mesh) else e
        for i, e in enumerate(spec)))


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(
        a is None or isinstance(a, str) for a in t)


def _map_axes(fn, axes, *trees):
    """``fn(logical, leaf, ...)`` over an axes tree (dicts and lists whose
    leaves are tuples of logical names) and trees of the same structure."""
    if _is_axes(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], *(t[k] for t in trees))
                for k in axes}
    if isinstance(axes, (list, tuple)):
        return type(axes)(_map_axes(fn, a, *(t[i] for t in trees))
                          for i, a in enumerate(axes))
    raise TypeError(f"_map_axes: unexpected node {type(axes).__name__}")


def param_sharding(axes_tree, mesh: Mesh, params_tree,
                   rules: dict | None = None):
    """An axes tree (tuples of logical names) and the parameters it
    describes -> a tree of :class:`NamedSharding`.

    A mesh axis appears at most once per spec: the first logical
    dimension that maps to it wins (MoE's "expert" takes the model axis
    and the per-expert "tensor" dimensions stay replicated).  A dimension
    that does not divide its mesh extent falls back to replicated (10
    heads on a 16-way tensor axis)."""

    def one(logical, leaf):
        spec = to_pspec(tuple(logical), mesh, rules)
        shape = tuple(leaf.shape)
        fixed, used = [], set()
        for i, e in enumerate(spec):
            names = _names(e)
            if any(n in used for n in names) or (
                    i < len(shape) and not _divisible(shape[i], e, mesh)):
                fixed.append(None)
            else:
                fixed.append(e)
                used.update(names)
        return NamedSharding(mesh, PartitionSpec(*fixed))

    return _map_axes(one, axes_tree, params_tree)


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, rules: dict | None = None):
    """Turn on :func:`constrain` and the mesh-aware blocks (the a2a MoE)
    inside model code."""
    check_mesh(mesh, "activation_sharding")
    prev = getattr(_ctx, "active", None)
    _ctx.active = (mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _ctx.active = prev


def get_active():
    """(mesh, rules) of the enclosing :func:`activation_sharding`, or
    None."""
    return getattr(_ctx, "active", None)


def constrain(x, logical: tuple):
    """The reference's contextual sharding constraint.  Outside
    :func:`activation_sharding` nothing is checked; inside, ``logical``
    maps to a spec on the live mesh (a dimension that does not divide
    falls back to replicated) and must fit ``x``'s rank.  Returns ``x``
    itself: one controller holds the global tensor, which already is
    what the partitioned program computes."""
    active = get_active()
    if active is None:
        return x
    mesh, rules = active
    spec = _fit(to_pspec(logical, mesh, rules), x.shape, mesh)
    if len(spec) > x.dim():
        raise ValueError(f"constrain: {len(spec)} logical axes for a "
                         f"tensor of rank {x.dim()}")
    return x


def batch_sharding(mesh: Mesh, tree, rules: dict | None = None,
                   logical_tree=None):
    """Shardings of a batch tree (leaves with a ``shape``).  The leading
    axis maps to "batch" unless ``logical_tree`` gives a leaf its own
    logical tuple (M-RoPE positions (3, B, S) take (None, "batch",
    None)); a dimension that does not divide falls back to replicated."""

    def one(leaf, logical=None):
        shape = tuple(leaf.shape)
        logical = logical or (("batch",) + (None,) * (len(shape) - 1))
        return NamedSharding(mesh, _fit(to_pspec(tuple(logical), mesh,
                                                 rules), shape, mesh))

    if logical_tree is None:
        if isinstance(tree, dict):
            return {k: batch_sharding(mesh, v, rules) for k, v in
                    tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(batch_sharding(mesh, v, rules) for v in tree)
        return one(tree)
    return _map_axes(lambda lg, leaf: one(leaf, tuple(lg)), logical_tree,
                    tree)


def axes_in_mesh(mesh: Mesh, axes) -> tuple[str, ...]:
    """The names of ``axes`` (a name, a tuple of names or None) that
    ``mesh`` has, in order."""
    return tuple(a for a in _names(axes) if a in mesh.axis_names)


def axis_extent(mesh: Mesh, axes) -> int:
    """The product of the sizes of ``axes`` on ``mesh`` (1 for none)."""
    return int(np.prod([mesh.shape[a] for a in _names(axes)]))


def split_range(n: int, parts: int, what: str) -> list[tuple[int, int]]:
    """``parts`` equal contiguous ranges of ``n``; raises where they are
    not equal, as ``shard_map`` does for an in_spec that does not
    divide."""
    if parts <= 0 or n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} equal "
                         "shards")
    step = n // parts
    return [(i * step, (i + 1) * step) for i in range(parts)]


def ordered_mean(xs: list):
    """The mean of ``xs``, summed left to right (a fixed merge order)."""
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc / len(xs)


def on_device(t: torch.Tensor, dev: torch.device, **detail) -> torch.Tensor:
    """``t`` where it is already on ``dev``, else a copy there recorded as
    a ``kind="copy"`` trace event."""
    if t.device == dev:
        return t
    out = t.to(dev)
    record("copy", device=str(dev), bytes=out.numel() * out.element_size(),
           **detail)
    return out
