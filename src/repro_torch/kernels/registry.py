"""Kernel dispatch registry: one policy for every call site.

Counterpart of the reference package's ``kernels/registry.py``.  Each
entry pairs a plain PyTorch version (``ref``) with the wrapper of a CUDA
kernel written for the H100 (``cuda``) and the work of one call
(``cost(*args, **kwargs) -> (operations, bytes)``).  Call sites say
``dispatch("xtx", x, y, impl=...)``; :func:`register` adds a kernel.

Dispatch policy (``impl``):

* ``"auto"`` launches the kernel on CUDA tensors, runs the plain version
  on CPU tensors and takes the kernel's shape path on meta tensors.
  This is what ``use_kernel=True`` means.
* ``"ref"`` forces the plain version on CPU or CUDA tensors; on meta
  tensors it raises (a meta tensor never reaches a plain version).
* ``"cuda"`` forces the kernel; on CPU tensors it raises.

Where the work runs is decided by :func:`repro_torch.device.kernel_route`,
which the kernel wrappers ask too: through ``"auto"`` a CPU tensor goes
to the plain version here, and a direct call of a wrapper on a CPU
tensor does the same there.  The registry adds one rule of its own: a
forced ``"cuda"`` never runs the plain version.

The shape path is the dry run's: on meta tensors the call returns
outputs of the kernel's shapes and dtypes, launches nothing and runs no
plain version.  The built-in wrappers take meta tensors themselves (the
flash forward's autograd ``Function`` included, so its backward comes
through here again), and a registered kernel's ``cuda`` takes them the
same way; where it has no ``cuda``, a meta call raises.  On the card
and on meta alike the call's ``cost`` goes to the active op counter
(:class:`repro_torch.launch.op_analysis.OpCounter`), so the dry run and
the card count the same work.

There is no ``supports`` gate that degrades to ``ref`` on the card: a
kernel that cannot take a shape raises from its wrapper (ROADMAP port
rule 4), and :func:`register` refuses ``supports=``.  Every dispatch
records a ``kind="kernel"`` trace event carrying the resolved
implementation (``"ref"``, ``"cuda"`` or ``"meta"``), so tests assert
which one ran from the trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (_disable_current_modes,
                                          _get_current_dispatch_mode_stack)

from ..core.trace import record, span
from ..device import kernel_route
from .column_stats import ops as _cs_ops, ref as _cs_ref
from .countmin import ops as _cm_ops, ref as _cm_ref
from .flash_attention import ops as _fa_ops, ref as _fa_ref
from .kmeans_assign import ops as _km_ops, ref as _km_ref
from .segment_fold import ops as _sf_ops, ref as _sf_ref
from .xtx import ops as _xtx_ops, ref as _xtx_ref

IMPLS = ("auto", "ref", "cuda")


def _first_tensor(args) -> torch.Tensor:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
    raise ValueError("kernel dispatch: no tensor argument")


def _counters() -> list:
    """The ``record_kernel`` of every active op counter (a dispatch mode
    that has one).  The dispatch-mode stack is thread-local state that
    autograd carries into its worker threads, so a backward's kernels
    reach the counter of the step that runs it."""
    return [rec for mode in _get_current_dispatch_mode_stack()
            if (rec := getattr(mode, "record_kernel", None)) is not None]


def record_cost(name: str, flops: float, nbytes: float) -> None:
    """Hand one call's work to every active op counter."""
    for rec in _counters():
        rec(name, flops, nbytes)


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """A named kernel: its plain version, its CUDA wrapper (which also
    takes meta tensors, the shape path) and the work of a call."""

    name: str
    ref: Callable[..., Any]
    cuda: Callable[..., Any] | None = None
    cost: Callable[..., tuple[float, float]] | None = None

    def resolve(self, impl: str, *args, **kwargs) -> str:
        """Which implementation runs for this call: ``"ref"``, ``"cuda"``
        or ``"meta"``.  Reads only the arguments' device, so callers may
        resolve before the call."""
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if impl == "ref":
            if any(isinstance(a, torch.Tensor) and a.is_meta for a in args):
                raise ValueError(
                    f"kernel {self.name!r}: impl='ref' on meta tensors; a "
                    "meta tensor takes the kernel's shape path, never the "
                    "plain version")
            return "ref"
        t = _first_tensor(args)
        route = kernel_route(t, self.name)
        if route == "cpu":
            if impl == "auto":
                return "ref"
            raise ValueError(
                f"kernel {self.name!r}: impl='cuda' forced on tensors on "
                f"{t.device}; the CUDA kernel runs only on the card")
        return route


_REGISTRY: dict[str, KernelEntry] = {
    "xtx": KernelEntry("xtx", _xtx_ref.xtx_xty_ref, _xtx_ops.xtx_xty,
                       _xtx_ops.cost),
    "column_stats": KernelEntry(
        "column_stats", _cs_ref.column_stats_ref, _cs_ops.column_stats,
        _cs_ops.cost),
    "kmeans_assign": KernelEntry(
        "kmeans_assign", _km_ref.assign_and_reduce_ref,
        _km_ops.assign_and_reduce, _km_ops.cost),
    "segment_linregr": KernelEntry(
        "segment_linregr", _sf_ref.segment_linregr_ref,
        _sf_ops.segment_linregr, _sf_ops.segment_linregr_cost),
    "countmin": KernelEntry("countmin", _cm_ref.countmin_block_ref,
                            _cm_ops.countmin_block, _cm_ops.cost),
    "segment_countmin": KernelEntry(
        "segment_countmin", _sf_ref.segment_countmin_ref,
        _sf_ops.segment_countmin, _sf_ops.segment_countmin_cost),
    "segment_fm": KernelEntry("segment_fm", _sf_ref.segment_fm_ref,
                              _sf_ops.segment_fm, _sf_ops.segment_fm_cost),
    "flash_attention": KernelEntry(
        "flash_attention", _fa_ref.flash_attention_ref,
        _fa_ops.flash_attention, _fa_ops.cost),
    "flash_attention_bwd": KernelEntry(
        "flash_attention_bwd", _fa_ref.flash_attention_bwd_ref,
        _fa_ops.flash_attention_bwd, _fa_ops.bwd_cost),
}


def register(name: str, *, ref: Callable, cuda: Callable | None = None,
             cost: Callable | None = None, overwrite: bool = False,
             supports=None) -> KernelEntry:
    """Add kernel ``name``: it dispatches, traces (``kind="kernel"``),
    takes the shape path on meta tensors (through ``cuda``) and records
    ``cost`` like a built-in.  A name already registered raises
    ``ValueError`` unless ``overwrite``.  ``supports=`` raises: a
    kernel that cannot take a shape raises from its own wrapper (ROADMAP
    port rule 4)."""
    if supports is not None:
        raise ValueError(
            f"kernel {name!r}: register takes no supports=; a kernel that "
            "cannot take a shape raises from its wrapper, never degrades to "
            "ref on the card (ROADMAP port rule 4)")
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    entry = KernelEntry(name, ref, cuda, cost)
    _REGISTRY[name] = entry
    return entry


def get(name: str) -> KernelEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{available()}") from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def dispatch(name: str, *args, impl: str = "auto", _record: bool = True,
             **kwargs):
    """Run kernel ``name`` on ``args`` under the policy above.

    ``_record=False`` suppresses the trace event: engine paths that
    resolve before the call (and record there, once per physical
    execution) pass it so the inner call does not count twice.  The
    kernel's cost goes to the active op counter whenever the kernel (or
    its shape path) runs."""
    with span("dispatch"):
        entry = get(name)
        resolved = entry.resolve(impl, *args, **kwargs)
        if _record:
            record("kernel", engine=resolved, name=name, requested=impl)
        if resolved == "ref":
            return entry.ref(*args, **kwargs)
        if entry.cuda is None:
            raise ValueError(f"kernel {name!r} has no {resolved} "
                             "implementation")
        if entry.cost is not None and _counters():
            # a cost may read its data (segment_linregr's valid rows):
            # only under a counter, and with the counters off so that the
            # read is not counted as the step's work
            with _disable_current_modes():
                cost = entry.cost(*args, **kwargs)
            record_cost(name, *cost)
        return entry.cuda(*args, **kwargs)


def resolve_impl(use_kernel: bool | str) -> str | None:
    """Method-layer ``use_kernel`` flag -> dispatch impl (None = inline
    transition, no registry call)."""
    if use_kernel is False:
        return None
    if use_kernel is True:
        return "auto"
    if use_kernel in IMPLS:
        return use_kernel
    raise ValueError(f"use_kernel must be bool or one of {IMPLS}, "
                     f"got {use_kernel!r}")
