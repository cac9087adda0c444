"""State trees: the port's counterpart of ``jax.tree.map``.

Aggregate states are nested dicts, tuples and dataclasses whose leaves
are tensors (or, for merge-combinator trees, strings).  These helpers
walk that structure; anything that is not a dict, tuple, list or
dataclass instance is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_stack(trees: list) -> Any:
    """Stack a list of same-shaped trees along a new leading axis (the
    group axis that ``jax.vmap`` would have produced)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree, i) -> Any:
    """Leaf-wise ``x[i]`` over a stacked tree."""
    return tree_map(lambda x: x[i], tree)
