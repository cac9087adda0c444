"""Operation counts of an eager PyTorch step: the port's counterpart of
the reference ``launch/hlo_analysis.py``.

The reference parses the compiled program's HLO text, builds its call
graph and multiplies each while-body by the trip count that
``tagged_scan`` registered, because XLA's ``cost_analysis`` counts a loop
body once.  Eager PyTorch has no compiled program to parse and
dispatches every iteration of every loop, so the port counts the
operations themselves as they are dispatched: :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten operation of the step it
wraps, on meta tensors (the dry run: shapes, nothing allocated) or on
the card.  It counts

* dot flops: 2 · prod(output) · prod(contracted) for ``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` and the convolutions (elementwise flops are not
  counted, as in the reference);
* bytes accessed: the inputs and outputs of each aten operation that is
  not a view or an uninitialised allocation.  This is an eager upper
  bound: XLA's count comes after fusion, which keeps an elementwise
  chain's intermediates out of memory;
* the kernels' own work, which the registry records for every call that
  launches a kernel or takes its shape path
  (:func:`repro_torch.kernels.registry.record_cost`): the kernels are
  opaque to the dispatcher;
* collectives by kind, raw and wire, with the reference's wire
  convention: all-reduce at 2 x its payload (a reduce-scatter and an
  all-gather on a ring), all-gather at its output, reduce-scatter,
  all-to-all and collective-permute at their input.  The functional
  collectives of ``torch.distributed`` are counted as dispatched;
  :meth:`OpCounter.add_collective` records the ones a caller derives
  (the dry run's closed form);
* the peak of live meta or CUDA storage bytes that the step allocates:
  each new output storage is added when it appears and taken off when it
  dies (``weakref.finalize``), so on meta the peak is what the card's
  allocator would hold at most for the step, beside the tensors that
  were alive before it.

Everything is attributed to the innermost
:func:`~repro_torch.launch.scan_registry.tag_scope` open on the thread
that dispatches it (a backward that autograd runs on its own thread
counts under the root scope).  :meth:`OpCounter.repeat` scales what is
counted inside it, so one traced iteration can stand for ``n``
identical ones.

Not applicable from the reference, with no HLO to read: the text parser
(``parse_computations``), the trip-count matcher (``_trip_count``,
``unknown_whiles``), the bf16-promotion detector (XLA:CPU's promoted
collectives) and ``FLASH_TAGS`` (the port's flash kernel reports its own
bytes through its cost).
"""

from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .scan_registry import current_scope

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives of torch.distributed, by op name
_C10D_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}

# allocations that read and write nothing
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype`` (the counterpart of
    the reference's ``shape_bytes`` over HLO shape text)."""
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    """2 · batch · C_out · C_in/groups · prod(filter) · prod(output
    positions); a transposed convolution sweeps its input positions."""
    positions = x_shape[2:] if transposed else out_shape[2:]
    c_out, c_in, *filt = w_shape
    return (2.0 * x_shape[0] * c_out * c_in * math.prod(filt)
            * math.prod(positions))


def _swap01(shape):
    return [shape[1], shape[0], *shape[2:]]


def dot_flops(func, args, out) -> float:
    """The dot flops of one aten operation (0 for anything that is not a
    product or a convolution)."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm):
        a, b = args[0], args[1]
        return 2.0 * math.prod(a.shape) * b.shape[-1]
    if packet in (aten.addmm, aten.baddbmm):
        a, b = args[1], args[2]
        return 2.0 * math.prod(a.shape) * b.shape[-1]
    if packet in (aten.convolution, aten._convolution):
        return _conv_flops(args[0].shape, args[1].shape, out.shape,
                           bool(args[6]))
    if packet is aten.convolution_backward:
        grad, x, w = args[0].shape, args[1].shape, args[2].shape
        transposed, mask = bool(args[7]), args[10]
        flops = 0.0
        if mask[0]:
            flops += _conv_flops(grad, w, x, not transposed)
        if mask[1]:
            flops += (_conv_flops(_swap01(grad), _swap01(x), _swap01(w),
                                  False) if transposed else
                      _conv_flops(_swap01(x), _swap01(grad), _swap01(w),
                                  False))
        return flops
    return 0.0


def _tensors(xs) -> list[torch.Tensor]:
    """The tensors among ``xs`` and inside its lists and tuples (an aten
    operation's arguments or results nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class OpCounter(TorchDispatchMode):
    """Counts what the wrapped code dispatches; read it with
    :func:`analyze`.  ``with OpCounter() as c: step(...)``."""

    def __init__(self):
        super().__init__()
        self.by_scope = defaultdict(lambda: defaultdict(float))
        self.kernels = defaultdict(lambda: defaultdict(float))
        self.coll_raw = defaultdict(float)
        self.coll_wire = defaultdict(float)
        self.coll_count = defaultdict(float)
        self.weight = 1.0
        self.live = 0
        self.peak = 0
        self._owned: dict[int, int] = {}

    # -- scaling -------------------------------------------------------------
    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times: one traced iteration of a
        loop whose ``n`` iterations are identical."""
        prev = self.weight
        self.weight = prev * n
        try:
            yield self
        finally:
            self.weight = prev

    # -- recording -----------------------------------------------------------
    def _add(self, key: str, value: float) -> None:
        self.by_scope[current_scope()][key] += self.weight * value

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel (from the registry)."""
        self._add("kernel_flops", flops)
        self._add("kernel_bytes", nbytes)
        k = self.kernels[name]
        k["calls"] += self.weight
        k["flops"] += self.weight * flops
        k["bytes"] += self.weight * nbytes

    def add_collective(self, kind: str, raw_bytes: float,
                       count: float = 1) -> None:
        """``count`` collectives of ``kind`` moving ``raw_bytes`` in all,
        at the reference's wire convention."""
        if kind not in COLLECTIVES:
            raise ValueError(f"add_collective: {kind!r} is not one of "
                             f"{COLLECTIVES}")
        wire = 2 * raw_bytes if kind == "all-reduce" else raw_bytes
        self.coll_raw[kind] += self.weight * raw_bytes
        self.coll_wire[kind] += self.weight * wire
        self.coll_count[kind] += self.weight * count

    def _track(self, outs, ins) -> None:
        seen = None
        for t in outs:
            if t.device.type not in ("meta", "cuda"):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._owned:
                continue
            if seen is None:
                seen = {i.untyped_storage()._cdata for i in ins}
            if key in seen:
                continue
            seen.add(key)
            n = st.nbytes()
            self._owned[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        kind = _C10D_KINDS.get(func.overloadpacket.__name__) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            src = outs if kind in ("all-reduce", "all-gather") else ins
            self.add_collective(kind, float(sum(map(_nbytes, src[:1]))))
        flops = dot_flops(func, args, out)
        if flops:
            self._add("dot_flops", flops)
        if not (func.is_view or func in _NO_BYTES):
            self._add("bytes", float(sum(map(_nbytes, ins))
                                     + sum(map(_nbytes, outs))))
        self._track(outs, ins)
        return out


def analyze(counter: OpCounter, registry: dict[str, int]) -> dict:
    """The counts of ``counter`` under the reference's keys where they mean
    the same thing: ``dot_flops`` (the aten products and the kernels'
    operations), ``bytes_accessed`` (the aten operations' and the
    kernels'), ``collective_raw_bytes``, ``collective_wire_bytes``,
    ``collective_counts``, ``total_wire_bytes`` and ``registry``; beside
    them ``kernel_flops``, ``kernels`` (calls, flops and bytes by name),
    ``peak_bytes`` (live storage) and ``by_scope``."""
    tot = defaultdict(float)
    for counts in counter.by_scope.values():
        for k, v in counts.items():
            tot[k] += v
    return {
        "dot_flops": tot["dot_flops"] + tot["kernel_flops"],
        "bytes_accessed": tot["bytes"] + tot["kernel_bytes"],
        "kernel_flops": tot["kernel_flops"],
        "collective_raw_bytes": dict(counter.coll_raw),
        "collective_wire_bytes": dict(counter.coll_wire),
        "collective_counts": dict(counter.coll_count),
        "total_wire_bytes": float(sum(counter.coll_wire.values())),
        "registry": dict(registry),
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
        "peak_bytes": counter.peak,
        "by_scope": {s: dict(v) for s, v in counter.by_scope.items()},
    }
