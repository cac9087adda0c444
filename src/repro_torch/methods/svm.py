"""Support vector machines (paper Table 1; Table 2 "Classification" row).

The port's counterpart of the reference ``methods/svm.py``.  Linear SVM
via the §5.1 convex abstraction: hinge loss Σ (1 − y·xᵀw)₊ with L2
regularization, solved by SGD (the paper's own SVM is SGD-based), plus a
deterministic subgradient descent path for reproducible tests.  No loop
lives here: both solvers run under the iterative executor through
:class:`~repro_torch.core.convex.ConvexProgram`.
"""

from __future__ import annotations

import torch

from ..core.convex import ConvexProgram, gradient_descent, parallel_sgd, sgd
from ..core.table import Table


def svm_program(mu: float = 1e-3) -> ConvexProgram:
    def loss(params, block, mask):
        sgn = 2.0 * block["y"] - 1.0          # {0,1} -> {-1,+1}
        margin = 1.0 - sgn * (block["x"] @ params)
        # torch.maximum splits the subgradient at a tie, as jnp.maximum does
        hinge = torch.maximum(torch.zeros_like(margin), margin)
        return torch.sum(hinge * mask.to(torch.float32))

    return ConvexProgram(
        loss=loss, regularizer=lambda p: 0.5 * mu * torch.sum(p ** 2))


def svm_fit(table: Table, *, mu: float = 1e-3, epochs: int = 10,
            stepsize: float = 0.1, batch: int = 128, seed=0,
            solver: str = "sgd") -> torch.Tensor:
    """Fit w from zero: ``solver="sgd"`` (``seed``, an int or a
    ``torch.Generator`` on the table's device, drives the shuffles) or
    ``"gd"`` (200 rounds of full-batch subgradient descent at
    ``stepsize / 100``).  SGD on a distributed table is
    :func:`~repro_torch.core.convex.parallel_sgd`."""
    d = table["x"].shape[-1]
    prog = svm_program(mu)
    w0 = torch.zeros((d,), device=table.device)
    if solver == "gd":
        w, _, _ = gradient_descent(prog, table, w0, stepsize=stepsize / 100,
                                   max_iters=200, tol=1e-5)
        return w
    solver = parallel_sgd if table.mesh is not None else sgd
    return solver(prog, table, w0, stepsize=stepsize, epochs=epochs,
                  batch=batch, seed=seed)


def svm_predict(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (x @ w > 0).to(torch.int32)
