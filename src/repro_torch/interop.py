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
:func:`model_params_to_numpy`: the reference's params pytree (the
layers of each position of the family's block pattern stacked along a
leading axis) against the port's per-layer ``nn.Module``, for every
family.  A training state carries across with
:func:`train_state_from_numpy` and :func:`train_state_to_numpy`: the
parameters as above, the AdamW moments in the same layout (f32), the
update count and the step.  Nothing here imports the reference package:
the caller converts its arrays with ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .core.table import Table
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import Model, period_pattern
from .optim import AdamWState
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


def _layer_slots(cfg: ModelConfig):
    """Where layer i sits in the reference's tree: ``(period, index)``
    for the ``n_full`` full periods of the family's pattern (length P:
    layer i is index i // P of ``periods[str(i % P)]``), then ``("tail",
    j)`` for the rest."""
    p = len(period_pattern(cfg))
    n_stacked = cfg.n_layers // p * p
    return [(str(i % p), i // p) if i < n_stacked else ("tail", i - n_stacked)
            for i in range(cfg.n_layers)]


def params_from_numpy(module: torch.nn.Module, tree) -> None:
    """Copy a nested dict of numpy arrays into ``module``'s parameters of
    the same dotted names, in place."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(_tensor(_leaf(tree, name)))


def model_params_from_numpy(cfg: ModelConfig, tree, device=None) -> Model:
    """The reference's params pytree for ``cfg`` (numpy arrays: ``embed``,
    ``out_norm``, ``lm_head`` unless tied, ``periods`` with each position
    of the family's block pattern stacked along a leading axis, and
    ``tail``) -> the port's :class:`Model` on ``device`` (the card unless
    ``device="cpu"``)."""
    model = Model(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters(recurse=False):
            p.copy_(_tensor(tree[name]))
    for blk, (where, j) in zip(model.blocks, _layer_slots(cfg)):
        if where == "tail":
            params_from_numpy(blk, tree["tail"][j])
        else:
            params_from_numpy(blk, tree_map(lambda a: np.asarray(a)[j],
                                            tree["periods"][where]))
    return model


def model_params_to_numpy(model: Model) -> dict:
    """The inverse of :func:`model_params_from_numpy`: the reference's
    pytree layout, each pattern position's full periods stacked into
    ``periods`` (``{}`` where there is no full period) and the rest in
    ``tail``.  bfloat16 parameters come out as f32 arrays (exact)."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: dict = {name: arr(p)
                 for name, p in model.named_parameters(recurse=False)}
    stacks: dict[str, list] = {
        str(i): [] for i in range(len(period_pattern(model.cfg)))}
    out["tail"] = []
    for blk, (where, _) in zip(model.blocks, _layer_slots(model.cfg)):
        layer: dict = {}
        for name, p in blk.named_parameters():
            node = layer
            *parents, leaf = name.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr(p)
        (out["tail"] if where == "tail" else stacks[where]).append(layer)
    out["periods"] = {k: tree_map(lambda *xs: np.stack(xs), *v) if v else {}
                      for k, v in stacks.items()}
    return out


def _f32_named(cfg: ModelConfig, tree, device) -> dict:
    """A params-shaped tree of the reference's layout -> f32 tensors keyed
    by the port's parameter names."""
    m = model_params_from_numpy(dataclasses.replace(cfg, dtype="float32"),
                                tree, device)
    return {k: p.detach() for k, p in m.named_parameters()}


def train_state_from_numpy(cfg: ModelConfig, params_tree, opt_tree, step,
                           device=None):
    """The reference's ``TrainState`` as numpy (``params``, ``opt`` =
    ``AdamWState(mu, nu, count)`` or the tuple ``(mu, nu, count)``,
    ``step``) -> the port's :class:`repro_torch.train.TrainState` on
    ``device`` (the card unless ``device="cpu"``), its parameters
    requiring a gradient."""
    from .train.trainer import TrainState
    dev = resolve_device(device)
    model = model_params_from_numpy(cfg, params_tree, dev)
    model.requires_grad_(True)
    mu, nu, count = opt_tree
    opt = AdamWState(_f32_named(cfg, mu, dev), _f32_named(cfg, nu, dev),
                     torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                                  device=dev))
    return TrainState(model, opt, torch.tensor(
        int(np.asarray(step)), dtype=torch.int32, device=dev))


def train_state_to_numpy(state) -> tuple:
    """The inverse of :func:`train_state_from_numpy`: ``(params, (mu, nu,
    count), step)`` in the reference's layout, bfloat16 parameters as f32
    arrays (exact), the count and step as int32 scalars."""
    model = state.model
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")

    def moments(named: dict) -> dict:
        m = Model(cfg32, model.embed.device)
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(named[k])
        return model_params_to_numpy(m)

    opt = state.opt
    return (model_params_to_numpy(model),
            (moments(opt.mu), moments(opt.nu),
             np.int32(opt.count.item())),
            np.int32(state.step.item()))
