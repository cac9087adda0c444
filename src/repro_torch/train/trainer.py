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
waits for the host.  The sharded assembly (``shardings_for_state``,
``jit_train_step``) is ROADMAP Queue 1 item 13b: a ``mesh`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.table import require_no_mesh
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import AdamWState, adamw_init, adamw_update, \
    clip_by_global_norm, linear_warmup_cosine


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


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` micro-batches along the batch axis: the second axis of the
    M-RoPE positions (3, B, S), the first of everything else."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        if x.shape[axis] % n:
            raise ValueError(f"make_train_step: {k} has {x.shape[axis]} "
                             f"rows, not a multiple of grad_accum = {n}")
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
    other metrics are the last micro-batch's."""
    require_no_mesh("make_train_step", mesh)

    def transition(model, leaves, mb):
        total, metrics = M.train_loss(model, mb)
        # a leaf the loss does not reach (an encoder's unused token
        # embedding) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: TrainState, batch: dict):
        params = state.params()
        names, leaves = list(params), list(params.values())
        if grad_accum == 1:
            loss, metrics, g = transition(state.model, leaves, batch)
            grads = dict(zip(names, g))
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for mb in _split(batch, grad_accum):
                lm, metrics, g = transition(state.model, leaves, mb)
                loss = loss + lm
                torch._foreach_add_(acc, list(g))
                del g
            loss = loss / grad_accum
            torch._foreach_div_(acc, grad_accum)
            grads = dict(zip(names, acc))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            lr = linear_warmup_cosine(state.step, base_lr=base_lr,
                                      warmup_steps=warmup,
                                      total_steps=total_steps)
            adamw_update(grads, state.opt, params, lr=lr)
            state.step += 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(model, cache, token, pos) -> (logits, cache)``."""

    def serve_step(model, cache, token, pos):
        return M.decode_step(model, cache, token, pos)

    return serve_step
