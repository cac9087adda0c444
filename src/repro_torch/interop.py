"""Carry tables and fold states between the reference package and the
port, as numpy arrays.

A fold state made by one package can be merged with a fold of further
rows made by the other: both hold OLS states as the same dict of
``xtx``, ``xty``, ``y_sum``, ``y_sq`` and ``n``, solo or stacked with a
leading group axis ``(G, ...)``.  Sketch states carry across the same
way, as int32 arrays: a Count-Min ``(depth, width)`` counter matrix or
an FM ``(num_hashes, bits)`` bitmap, or their ``(G, ...)`` stacks,
through the same :func:`state_from_numpy` and :func:`state_to_numpy`;
they merge with the aggregate's own combinator (sum, max) and stay
exact.  A fit's parameters need nothing more: the reference's k-means
centroids or IRLS coefficients, as numpy arrays, are the port's
``init_centroids`` and ``warm_start`` as they are, and a ``FitResult``
state goes back through :func:`state_to_numpy`.  An LM's parameters
carry across with :func:`model_params_from_numpy` and
:func:`model_params_to_numpy`: the reference's params pytree (its
layers stacked along a leading axis) against the port's per-layer
``nn.Module``.  Nothing here imports the reference package: the caller
converts its arrays with ``numpy.asarray``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.table import Table
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import Model
from .tree import tree_map


def table_from_numpy(columns: Mapping[str, Any], device=None) -> Table:
    """A port :class:`Table` from a mapping of column name -> array (a
    reference table's columns passed through ``numpy.asarray``)."""
    return Table.from_columns(
        {k: np.asarray(v) for k, v in columns.items()}, device=device)


def state_from_numpy(state, device=None):
    """A fold state tree of numpy arrays -> the same tree of tensors on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), state)


def state_to_numpy(state):
    """A fold state tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def _tensor(a) -> torch.Tensor:
    """numpy -> tensor; bfloat16 arrays (``ml_dtypes``) go through f32,
    which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _leaf(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def model_params_from_numpy(cfg: ModelConfig, tree, device=None) -> Model:
    """The reference's params pytree for ``cfg`` (numpy arrays: ``embed``,
    ``out_norm``, ``lm_head`` unless tied, ``periods["0"]`` with every
    layer stacked along a leading axis, and ``tail``) -> the port's
    :class:`Model` on ``device`` (the card unless ``device="cpu"``).
    Layer ``i`` is index ``i`` of the stacked arrays; layers past the
    stack come from ``tail``."""
    model = Model(cfg, device)
    stacked = tree["periods"]["0"]
    n_full = int(np.asarray(stacked["norm1"]).shape[0]) if stacked else 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.startswith("blocks."):
                p.copy_(_tensor(tree[name]))
                continue
            _, i, path = name.split(".", 2)
            i = int(i)
            a = (np.asarray(_leaf(stacked, path))[i] if i < n_full
                 else _leaf(tree["tail"][i - n_full], path))
            p.copy_(_tensor(a))
    return model


def model_params_to_numpy(model: Model) -> dict:
    """The inverse of :func:`model_params_from_numpy`: the reference's
    pytree layout, every layer stacked into ``periods["0"]`` and ``tail``
    empty.  bfloat16 parameters come out as f32 arrays (exact)."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: dict = {}
    layers: list[dict] = []
    for name, p in model.named_parameters():
        if not name.startswith("blocks."):
            out[name] = arr(p)
            continue
        _, i, path = name.split(".", 2)
        if int(i) == len(layers):
            layers.append({})
        node = layers[int(i)]
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr(p)
    out["periods"] = {"0": tree_map(lambda *xs: np.stack(xs), *layers)}
    out["tail"] = []
    return out
