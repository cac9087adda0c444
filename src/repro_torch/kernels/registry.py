"""Kernel dispatch registry: one policy for every call site.

Counterpart of the reference package's ``kernels/registry.py``.  Each
entry pairs a plain PyTorch version (``ref``) with the wrapper of a CUDA
kernel written for the H100 (``cuda``).  Call sites say
``dispatch("xtx", x, y, impl=...)``.

Dispatch policy (``impl``):

* ``"auto"`` launches the kernel on CUDA tensors and runs the plain
  version on CPU tensors.  This is what ``use_kernel=True`` means.
* ``"ref"`` forces the plain version, wherever the tensors lie.
* ``"cuda"`` forces the kernel; on CPU tensors it raises.

Where the work runs is decided by :func:`repro_torch.device.runs_on_card`,
which the kernel wrappers ask too: through ``"auto"`` a CPU tensor goes
to the plain version here, and a direct call of a wrapper on a CPU
tensor does the same there.  The registry adds one rule of its own: a
forced ``"cuda"`` never runs the plain version.

There is no ``supports`` gate that degrades to ``ref`` on the card: a
kernel that cannot take a shape raises from its wrapper.  Every
dispatch records a ``kind="kernel"`` trace event carrying the resolved
implementation, so tests assert which one ran from the trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.trace import record
from ..device import runs_on_card
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


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """A named (ref, cuda) implementation pair."""

    name: str
    ref: Callable[..., Any]
    cuda: Callable[..., Any]

    def resolve(self, impl: str, *args, **kwargs) -> str:
        """Which implementation runs for this call: ``"ref"`` or
        ``"cuda"``.  Reads only the arguments' device, so callers may
        resolve before the call."""
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if impl == "ref":
            return "ref"
        t = _first_tensor(args)
        on_card = runs_on_card(t, self.name)
        if impl == "auto":
            return "cuda" if on_card else "ref"
        if not on_card:
            raise ValueError(
                f"kernel {self.name!r}: impl='cuda' forced on tensors on "
                f"{t.device}; the CUDA kernel runs only on the card")
        return "cuda"


_REGISTRY: dict[str, KernelEntry] = {
    "xtx": KernelEntry("xtx", _xtx_ref.xtx_xty_ref, _xtx_ops.xtx_xty),
    "kmeans_assign": KernelEntry(
        "kmeans_assign", _km_ref.assign_and_reduce_ref,
        _km_ops.assign_and_reduce),
    "segment_linregr": KernelEntry(
        "segment_linregr", _sf_ref.segment_linregr_ref,
        _sf_ops.segment_linregr),
    "countmin": KernelEntry("countmin", _cm_ref.countmin_block_ref,
                            _cm_ops.countmin_block),
    "segment_countmin": KernelEntry(
        "segment_countmin", _sf_ref.segment_countmin_ref,
        _sf_ops.segment_countmin),
    "segment_fm": KernelEntry("segment_fm", _sf_ref.segment_fm_ref,
                              _sf_ops.segment_fm),
    "flash_attention": KernelEntry(
        "flash_attention", _fa_ref.flash_attention_ref,
        _fa_ops.flash_attention),
    "flash_attention_bwd": KernelEntry(
        "flash_attention_bwd", _fa_ref.flash_attention_bwd_ref,
        _fa_ops.flash_attention_bwd),
}


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
    execution) pass it so the inner call does not count twice."""
    entry = get(name)
    resolved = entry.resolve(impl, *args, **kwargs)
    if _record:
        record("kernel", engine=resolved, name=name, requested=impl)
    fn = entry.ref if resolved == "ref" else entry.cuda
    return fn(*args, **kwargs)


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
