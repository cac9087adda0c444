"""The §5.1 Table-2 model zoo under ONE abstraction.

The port's counterpart of the reference ``methods/sgd_models.py``.
Every model is a ConvexProgram (sum-decomposable objective over table
rows) handed to the same SGD solver — the Wisconsin contribution's
thesis: "specify the model, not the algorithm".  ``sgd`` runs counted
iterations of ``SGDEpochTask`` under ``repro_torch.core.iterative``, so
every registry model inherits the executor with no per-model code.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.convex import ConvexProgram, parallel_sgd, sgd
from ..core.table import Table
from .crf import crf_program
from .logregr import logistic_program
from .svd import lowrank_program
from .svm import svm_program


def least_squares_program(mu: float = 0.0) -> ConvexProgram:
    """Σ (xᵀw − y)²"""

    def loss(params, block, mask):
        r = block["x"] @ params - block["y"]
        return torch.sum(r * r * mask.to(torch.float32))

    reg = (lambda p: 0.5 * mu * torch.sum(p ** 2)) if mu > 0 else None
    return ConvexProgram(loss=loss, regularizer=reg)


def lasso_program(mu: float = 0.1) -> ConvexProgram:
    """Σ (xᵀw − y)² + μ‖w‖₁ (subgradient of the L1 term).  |w| is written
    so that its subgradient at 0 is +1, the one ``jax.grad(jnp.abs)``
    takes there (``torch.abs`` takes 0): a fit from w = 0 steps alike."""

    def loss(params, block, mask):
        r = block["x"] @ params - block["y"]
        return torch.sum(r * r * mask.to(torch.float32))

    def l1(p):
        return mu * torch.sum(torch.where(p >= 0, p, -p))

    return ConvexProgram(loss=loss, regularizer=l1)


# name -> program factory
REGISTRY: dict[str, Callable] = {
    "least_squares": least_squares_program,
    "lasso": lasso_program,
    "logistic": logistic_program,
    "svm": svm_program,
    "recommendation": lowrank_program,
    "crf": crf_program,
}


def fit_sgd_model(name: str, table: Table, params0, *, epochs: int = 5,
                  stepsize: float = 0.1, batch: int = 128, seed=0,
                  **prog_kwargs):
    """Fit the registry's ``name`` model from ``params0`` by SGD with
    Robbins-Monro stepsizes; ``seed`` (an int or a ``torch.Generator`` on
    the table's device) drives the shuffles.  On a distributed table:
    :func:`~repro_torch.core.convex.parallel_sgd`."""
    solver = parallel_sgd if table.mesh is not None else sgd
    return solver(REGISTRY[name](**prog_kwargs), table, params0,
                  stepsize=stepsize, epochs=epochs, batch=batch, seed=seed)
