"""Trainer: the LM train step as a MADlib SGD aggregate.

Counterpart of the reference package's ``train/trainer.py``, on one
card:

  transition — the gradient of one micro-batch's loss
               (``torch.autograd.grad`` of :func:`train_loss`)
  merge      — the sum of the micro-batches' gradients into f32
               accumulators, in micro-batch order (the reference's
               ``fold`` over ``grad_accum`` micro-batches)
  final      — clipping by the global norm, the learning-rate schedule
               and the AdamW update, in place

The model, the optimizer state and the step stay on the device; the
metrics (``loss``, ``grad_norm``, ``lr`` and the last micro-batch's
``nll`` and MoE terms) come back as 0-d device tensors, so a step never
waits for the host.

The sharded assembly keeps the reference's names.  :func:`jit_train_step`
compiles nothing: it runs the step under ``activation_sharding`` on a
single-controller mesh, cuts each micro-batch into the data shards of the
``batch`` axes, folds each shard's micro-batches as ``grad_accum`` does,
and merges the shards' gradient sums in shard order (a left fold in f32,
no collective and no float atomic) before clipping and AdamW.  The
shards are views of the batch and share the one model and its moments.
On one shard the step is the unsharded step, bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from ..distributed.sharding import (DEFAULT_RULES, P, NamedSharding,
                                    activation_sharding, axes_in_mesh,
                                    batch_sharding, check_mesh,
                                    ordered_mean, param_sharding)
from ..launch.scan_registry import tag_scope
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import AdamWState, adamw_init, adamw_update, \
    clip_by_global_norm, linear_warmup_cosine
from ..tree import tree_map


@dataclasses.dataclass
class TrainState:
    """The model (its parameters require a gradient), the AdamW state
    keyed by the model's parameter names, and the 0-d int32 step."""

    model: M.Model
    opt: AdamWState
    step: torch.Tensor

    def params(self) -> dict:
        return dict(self.model.named_parameters())


def init_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                     device=None) -> TrainState:
    """A model drawn by :func:`init_model` from ``generator`` on ``device``
    (the card unless ``device="cpu"``), with gradients turned on, zero
    moments and step 0."""
    model = M.init_model(cfg, generator=generator, device=device)
    model.requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters())),
                      torch.zeros((), dtype=torch.int32,
                                  device=model.embed.device))


def _split(batch: dict, n: int, what: str = "grad_accum") -> list[dict]:
    """``n`` micro-batches (or data shards) along the batch axis: the
    second axis of the M-RoPE positions (3, B, S), the first of
    everything else."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        if x.shape[axis] % n:
            raise ValueError(f"make_train_step: {k} has {x.shape[axis]} "
                             f"rows, not a multiple of {what} = {n}")
        for mb, part in zip(out, torch.chunk(x, n, dim=axis)):
            mb[k] = part
    return out


def make_train_step(cfg: ModelConfig, *, base_lr=3e-4, warmup=100,
                    total_steps=10_000, grad_clip=1.0, grad_accum: int = 1,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place.  With ``grad_accum`` > 1 the batch is cut
    into that many micro-batches; their gradients are summed into f32
    zeros in order and divided by ``grad_accum``, as is the loss, and the
    other metrics are the last micro-batch's.  With a ``mesh`` the step is
    :func:`jit_train_step`'s over it (``DEFAULT_RULES``).

    ``train_step.grads(state, batch) -> (loss, metrics, grads)`` is the
    step without its update; ``train_step.fold`` and ``train_step.final``
    are its two halves, which :func:`jit_train_step` reuses.

    ``repeat`` (of the step, ``grads`` and ``fold``) is the dry run's: a
    context-manager factory such as ``OpCounter.repeat``.  Where given,
    the fold runs the first micro-batch alone inside ``repeat(n)`` and
    stands it for all n, whose work is identical; the accumulators, the
    division and the update run once, as in the real step."""

    def transition(model, leaves, mb):
        total, metrics = M.train_loss(model, mb)
        # a leaf the loss does not reach (an encoder's unused token
        # embedding) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def fold(state: TrainState, micro: list[dict], repeat=None):
        """The transition over ``micro`` in order: (the losses' sum, the
        last micro-batch's metrics, the gradients' sum by name).  One
        micro-batch keeps its gradients as autograd gives them; more are
        summed into f32 zeros, inside the ``tagscan_grad_accum`` scope."""
        params = state.params()
        names, leaves = list(params), list(params.values())
        if len(micro) == 1:
            loss, metrics, g = transition(state.model, leaves, micro[0])
            return loss, metrics, dict(zip(names, g))
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
        run, scale = ((micro, contextlib.nullcontext()) if repeat is None
                      else (micro[:1], repeat(len(micro))))
        with tag_scope("tagscan_grad_accum", len(micro)), scale:
            for mb in run:
                lm, metrics, g = transition(state.model, leaves, mb)
                loss = loss + lm
                torch._foreach_add_(acc, list(g))
                del g
        return loss, metrics, dict(zip(names, acc))

    def grads(state: TrainState, batch: dict, repeat=None):
        micro = _split(batch, grad_accum) if grad_accum > 1 else [batch]
        loss, metrics, g = fold(state, micro, repeat)
        if grad_accum > 1:
            loss = loss / grad_accum
            torch._foreach_div_(list(g.values()), grad_accum)
        return loss, metrics, g

    def final(state: TrainState, grads: dict, loss, metrics: dict):
        """Clip, schedule and AdamW, in place; the step's metrics."""
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            lr = linear_warmup_cosine(state.step, base_lr=base_lr,
                                      warmup_steps=warmup,
                                      total_steps=total_steps)
            adamw_update(grads, state.opt, state.params(), lr=lr)
            state.step += 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    def train_step(state: TrainState, batch: dict, repeat=None):
        loss, metrics, g = grads(state, batch, repeat)
        return final(state, g, loss, metrics)

    train_step.grad_accum = grad_accum
    train_step.fold = fold
    train_step.grads = grads
    train_step.final = final
    if mesh is not None:
        return jit_train_step(train_step, None, None, None, mesh)
    return train_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(model, cache, token, pos) -> (logits, cache)``."""

    def serve_step(model, cache, token, pos):
        return M.decode_step(model, cache, token, pos)

    return serve_step


# ---------------------------------------------------------------------------
# The sharded assembly
# ---------------------------------------------------------------------------

def shardings_for_state(state: TrainState, axes, mesh, rules=None
                        ) -> TrainState:
    """The :class:`NamedSharding` of every leaf of ``state``: the
    parameters by ``axes`` (:func:`repro_torch.models.model.param_axes`),
    the f32 moments as their parameters, ``count`` and ``step``
    replicated.  Keyed as ``state`` is, so it is the ``shardings=`` tree
    of ``checkpoint.restore``."""
    p_sh = param_sharding(axes, mesh, state.params(), rules)
    rep = NamedSharding(mesh, P())
    return TrainState(p_sh, AdamWState(p_sh, dict(p_sh), rep), rep)


def _shards(batch: dict, n: int) -> list[dict]:
    """``n`` data shards of one micro-batch, along its batch axis."""
    return _split(batch, n, "data shards") if n > 1 else [batch]


def jit_train_step(train_step, state, axes, batch_spec, mesh, rules=None,
                   donate=True) -> Callable:
    """``train_step`` (from :func:`make_train_step`) over ``mesh``, under
    ``activation_sharding(mesh, rules)``.

    The batch's rows split as the reference's sharded step splits them:
    ``grad_accum`` micro-batches, each cut into the n data shards of the
    ``batch`` axes.  Shard s folds its pieces of the micro-batches in
    order (f32 sums past one), the shards' sums merge left to right in
    f32, and the loss and gradients are divided by n * grad_accum; the
    metrics are the shards' last micro-batch means.  On one data shard
    this is ``train_step`` itself.  ``state`` and ``axes``, when given,
    check that every leaf of ``state`` splits into its slices of
    ``shardings_for_state`` and holds the global tensor on the mesh's
    first device; ``batch_spec`` (a tree of arrays or tensors) checks
    its shapes against ``batch_sharding``.
    ``donate`` is the reference's argument: the port updates in place
    anyway.  Every data shard runs on the model's device; a mesh whose
    data shards lie on other devices raises (a model placed across cards
    is not ported).  The returned step carries ``grads`` and
    ``shard_grads`` (each shard's (loss sum, metrics, gradient sums))."""
    check_mesh(mesh, "jit_train_step")
    rules = rules or DEFAULT_RULES
    batch_axes = axes_in_mesh(mesh, rules.get("batch"))
    devs = mesh.segments(batch_axes)
    n = len(devs)
    ga = train_step.grad_accum
    if state is not None and axes is not None:
        tree_map(lambda sh, leaf: sh.check(leaf.shape, leaf.device,
                                           "jit_train_step: the state"),
                 shardings_for_state(state, axes, mesh, rules),
                 dataclasses.replace(state, model=state.params()))
    if batch_spec is not None:
        tree_map(lambda sh, leaf: sh.check(tuple(leaf.shape),
                                           what="jit_train_step: the batch"),
                 batch_sharding(mesh, batch_spec, rules), batch_spec)

    def check_devices(state):
        dev = state.step.device
        if any(d != dev for d in devs):
            raise ValueError(
                f"jit_train_step: data shards on {sorted(set(map(str, devs)))}"
                f" and the model on {dev}; every data shard runs on the "
                "model's device")

    def shard_pieces(state, batch):
        check_devices(state)
        micro = _split(batch, ga) if ga > 1 else [batch]
        pieces = [_shards(mb, n) for mb in micro]
        return [[p[s] for p in pieces] for s in range(n)]

    def shard_grads(state, batch):
        return [train_step.fold(state, mbs)
                for mbs in shard_pieces(state, batch)]

    def grads(state, batch):
        if n == 1:
            check_devices(state)
            return train_step.grads(state, batch)
        loss, metrics, acc = None, [], None
        for mbs in shard_pieces(state, batch):
            l_s, m_s, g_s = train_step.fold(state, mbs)
            metrics.append(m_s)
            if acc is None:
                loss = l_s
                acc = {k: g.to(torch.float32) for k, g in g_s.items()}
            else:
                loss = loss + l_s
                torch._foreach_add_(list(acc.values()), list(g_s.values()))
            del g_s
        count = n * ga
        torch._foreach_div_(list(acc.values()), count)
        return loss / count, {k: ordered_mean([m[k] for m in metrics])
                              for k in metrics[0]}, acc

    def sharded_grads(state, batch):
        with activation_sharding(mesh, rules):
            return grads(state, batch)

    def step(state, batch):
        with activation_sharding(mesh, rules):
            loss, metrics, g = grads(state, batch)
            return train_step.final(state, g, loss, metrics)

    step.grads = sharded_grads
    step.shard_grads = shard_grads
    return step
