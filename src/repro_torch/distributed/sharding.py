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
The LM half of the reference module (``to_pspec``, ``param_sharding``,
``activation_sharding``, ``constrain``, ``batch_sharding``) is ROADMAP
Queue 1 item 13b.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.trace import record


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
