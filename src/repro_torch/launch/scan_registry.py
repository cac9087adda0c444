"""Tagged loops: the trip-count registry and the scopes that the op
counter attributes work to.

The port's counterpart of the reference ``launch/scan_registry.py``.
There, every ``lax.scan`` of the model stack goes through
``tagged_scan``, which names a scope that survives into the compiled
HLO and records the loop's trip count, because XLA's ``cost_analysis``
counts a loop body once.  Eager PyTorch dispatches every iteration, so
nothing here is counted once by mistake; the registry keeps the trip
counts for the dry run's report (and for the one loop that it traces
once and scales, the gradient accumulation), and :func:`tag_scope` names
the innermost loop that :class:`~repro_torch.launch.op_analysis.OpCounter`
attributes each operation to.

* :func:`tagged_scan` is ``lax.scan`` as a Python loop: the carry threads
  through, the ``ys`` stack along dimension 0, and ``reverse`` runs the
  loop backwards and stores the ``ys`` in input order.
* :func:`tag_scope` wraps a loop the port writes as a plain ``for``: it
  registers the trip count and opens the scope, and changes no
  arithmetic.

Both register ``f"{tag}_L{length}"``: the same call site traced at two
lengths registers two entries.  The registry and the scope stack are
thread-local, as the reference's registry is.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map

_local = threading.local()


def _reg() -> dict[str, int]:
    if not hasattr(_local, "registry"):
        _local.registry = {}
    return _local.registry


def _stack() -> list[str]:
    if not hasattr(_local, "scopes"):
        _local.scopes = []
    return _local.scopes


def clear_registry() -> None:
    _reg().clear()


def get_registry() -> dict[str, int]:
    return dict(_reg())


def current_scope() -> str:
    """The innermost open scope's qualified tag, or "" outside every
    scope."""
    stack = _stack()
    return stack[-1] if stack else ""


@contextlib.contextmanager
def tag_scope(tag: str, length: int):
    """Register ``f"{tag}_L{length}"`` with trip count ``length`` and open
    it as the innermost scope while the loop inside runs."""
    qualified = f"{tag}_L{int(length)}"
    _reg()[qualified] = int(length)
    stack = _stack()
    stack.append(qualified)
    try:
        yield qualified
    finally:
        stack.pop()


def tagged_scan(tag: str, f: Callable, init, xs=None, *, length=None,
                unroll: int = 1, reverse: bool = False):
    """``jax.lax.scan(f, init, xs, length, reverse=reverse)`` as a Python
    loop inside :func:`tag_scope`: ``f(carry, x) -> (carry, y)`` over the
    leading axis of ``xs`` (a tensor or a tree of them, or None with
    ``length``); returns ``(carry, ys)`` with the ``ys`` (a tree, or
    None) stacked along dimension 0 in input order.  ``unroll`` is the
    reference's argument and changes nothing here."""
    del unroll
    if length is None:
        length = tree_leaves(xs)[0].shape[0]
    length = int(length)
    order = range(length - 1, -1, -1) if reverse else range(length)
    carry, ys = init, [None] * length
    with tag_scope(tag, length):
        for i in order:
            x = None if xs is None else tree_map(lambda a: a[i], xs)
            carry, ys[i] = f(carry, x)
    if length == 0 or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *leaves: torch.stack(leaves), *ys)


def tagged(tag: str, length: int) -> Any:
    """:func:`tag_scope` where ``length`` > 0, else a scope that registers
    nothing (the reference tags a loop only when it runs)."""
    return tag_scope(tag, length) if length > 0 else contextlib.nullcontext()
