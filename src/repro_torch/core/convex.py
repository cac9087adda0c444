"""The convex-optimization abstraction — MADlib §5.1 (Wisconsin layer).

The port's counterpart of the reference ``core/convex.py``.  A model is
a sum-decomposable objective ``f(w) = Σ_i f_i(w)`` where each table row
encodes one ``f_i``; solvers only see ``loss(params, block, mask)``.
Every Table-2 model (least squares, lasso, logistic regression, SVM,
low-rank recommendation, CRF labeling) plugs into this one abstraction.

Solvers:

* :func:`gradient_descent` — full-batch GD; the gradient is a
  user-defined aggregate (transition = block gradient, merge = sum);
* :func:`sgd` — stochastic gradient descent with Robbins-Monro stepsizes
  (Eq. 1 of the paper), one shuffled pass per epoch;
* :func:`parallel_sgd` — Zinkevich model averaging [47]: each segment
  of a mesh runs its epochs on its own rows, then the models are
  averaged once; without a mesh it is :func:`sgd`, as in the reference;
* :func:`newton` — Newton / IRLS steps with the Hessian accumulated by
  the same aggregate pattern;
* :func:`conjugate_gradient` — MADlib's CG support module.

Gradients and Hessians come from ``torch.func`` (``grad_and_value``,
``grad``, ``hessian``) where the reference calls ``jax.value_and_grad``,
``jax.grad`` and ``jax.hessian``.  GD, Newton and SGD run under the
iterative executor (:mod:`repro_torch.core.iterative`): GD and Newton as
single-pass tasks, SGD epochs as counted iterations of
:class:`SGDEpochTask`.  Randomness takes an integer ``seed`` or a
``torch.Generator`` where the reference takes a JAX key: the two
libraries' random streams differ, so SGD matches the reference only
where the shuffle cannot matter (one minibatch of the whole table).
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_leaves, tree_map
from .aggregates import MERGE_SUM, Aggregate
from .iterative import IterativeTask, fit
from .table import Columns, Table, _generator, table_mesh

LossFn = Callable[[Any, Columns, torch.Tensor], torch.Tensor]
# loss(params, block, mask) -> scalar SUM of f_i over unmasked rows.


@dataclasses.dataclass
class ConvexProgram:
    """A sum-decomposable objective. ``loss`` must return the *sum* (not
    mean) of per-row losses over the unmasked rows, so that gradients are
    additive across blocks (the UDA merge contract)."""

    loss: LossFn
    regularizer: Callable[[Any], torch.Tensor] | None = None  # added once

    def total_loss(self, params, block, mask):
        l = self.loss(params, block, mask)
        if self.regularizer is not None:
            l = l + self.regularizer(params)
        return l


# ---------------------------------------------------------------------------
# Gradient / Hessian accumulation as UDAs.
# ---------------------------------------------------------------------------

class GradientAggregate(Aggregate):
    """transition = add block gradient; merge = sum; final = (grad, loss, n)."""

    merge_ops = MERGE_SUM

    def __init__(self, program: ConvexProgram, params):
        self.program = program
        self.params = params

    def init(self, block):
        dev = tree_leaves(self.params)[0].device
        return {"grad": tree_map(torch.zeros_like, self.params),
                "loss": torch.zeros((), device=dev),
                "n": torch.zeros((), dtype=torch.int32, device=dev)}

    def transition(self, state, block, mask):
        grad, loss = torch.func.grad_and_value(self.program.loss)(
            self.params, block, mask)
        return {
            "grad": tree_map(torch.add, state["grad"], grad),
            "loss": state["loss"] + loss,
            "n": state["n"] + torch.sum(mask, dtype=torch.int32),
        }


class HessianAggregate(Aggregate):
    """Accumulates gradient and dense Hessian — valid for small parameter
    dimension (the paper's regression setting, where k ≤ a few hundred).
    ``torch.func.hessian`` (forward over reverse) holds one intermediate
    per parameter for every row of a block: bound it with the fit's
    ``block_size`` on large tables."""

    merge_ops = MERGE_SUM

    def __init__(self, program: ConvexProgram, params: torch.Tensor):
        if params.dim() != 1:
            raise ValueError("HessianAggregate expects a flat parameter vector")
        self.program = program
        self.params = params

    def init(self, block):
        d, dev = self.params.shape[0], self.params.device
        return {
            "grad": torch.zeros((d,), device=dev),
            "hess": torch.zeros((d, d), device=dev),
            "loss": torch.zeros((), device=dev),
            "n": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def transition(self, state, block, mask):
        grad, loss = torch.func.grad_and_value(self.program.loss)(
            self.params, block, mask)
        hess = torch.func.hessian(self.program.loss)(self.params, block, mask)
        return {
            "grad": state["grad"] + grad,
            "hess": state["hess"] + hess,
            "loss": state["loss"] + loss,
            "n": state["n"] + torch.sum(mask, dtype=torch.int32),
        }


# ---------------------------------------------------------------------------
# Solvers — every convergence loop below routes through the iterative
# executor; no solver owns a loop (CG, which scans no table, excepted).
# ---------------------------------------------------------------------------

def _trace_pairs(trace) -> list[tuple[float, float]]:
    """The executor's stacked ``(loss, metric)`` trace as host pairs,
    pulled in one copy."""
    return list(zip(*torch.stack(trace).tolist()))


class GradientDescentTask(IterativeTask):
    """Full-batch GD: the per-iteration pass is one GradientAggregate
    execution; the driver step is ``w ← w − α·∇f``."""

    def __init__(self, program: ConvexProgram, params0, stepsize: float,
                 tol: float):
        self.program = program
        self.params0 = params0
        self.stepsize = stepsize
        self.tol = tol

    def init_state(self, columns):
        return {"params": self.params0, "gnorm": np.float32(np.inf)}

    def make_aggregate(self, state):
        return GradientAggregate(self.program, state["params"])

    def update(self, state, out):
        params = state["params"]
        g = out["grad"]
        if self.program.regularizer is not None:
            g = tree_map(torch.add, g,
                         torch.func.grad(self.program.regularizer)(params))
        gnorm = torch.sqrt(sum(torch.sum(x ** 2) for x in tree_leaves(g)))
        # on convergence the pre-step params are the answer (no host sync)
        stepped = tree_map(
            lambda p, gg: torch.where(gnorm < self.tol, p,
                                      p - self.stepsize * gg), params, g)
        return {"params": stepped, "gnorm": gnorm}

    def metric(self, prev, new, out):
        return new["gnorm"]

    def trace_record(self, state, out, m):
        return (out["loss"], m)


def gradient_descent(program: ConvexProgram, table: Table, params0,
                     *, stepsize: float = 1e-3, max_iters: int = 100,
                     tol: float = 1e-6, block_size: int | None = None,
                     mode: str = "compiled"):
    """Full-batch GD; each round's gradient is one UDA execution.
    Returns ``(params, [(loss, gnorm), ...], converged)``."""
    res = fit(GradientDescentTask(program, params0, stepsize, tol), table,
              max_iters=max_iters, tol=tol, block_size=block_size, mode=mode)
    return res.state["params"], _trace_pairs(res.trace), res.converged


class NewtonTask(IterativeTask):
    """Newton / IRLS: Hessian + gradient accumulated by one UDA pass,
    driver step solves ``H δ = g``."""

    def __init__(self, program: ConvexProgram, params0: torch.Tensor,
                 ridge: float):
        self.program = program
        self.params0 = params0
        self.ridge = ridge

    def init_state(self, columns):
        return {"params": self.params0, "delta": np.float32(np.inf)}

    def make_aggregate(self, state):
        return HessianAggregate(self.program, state["params"])

    def update(self, state, out):
        params = state["params"]
        g, h = out["grad"], out["hess"]
        reg = self.program.regularizer
        if reg is not None:
            g = g + torch.func.grad(reg)(params)
            h = h + torch.func.hessian(reg)(params)
        h = h + self.ridge * torch.eye(h.shape[0], dtype=h.dtype,
                                       device=h.device)
        step = torch.linalg.solve(h, g)
        new = params - step
        delta = torch.linalg.norm(step) / (torch.linalg.norm(new) + 1e-12)
        return {"params": new, "delta": delta}

    def metric(self, prev, new, out):
        return new["delta"]

    def trace_record(self, state, out, m):
        return (out["loss"], m)


def newton(program: ConvexProgram, table: Table, params0: torch.Tensor, *,
           max_iters: int = 20, tol: float = 1e-8, ridge: float = 1e-6,
           block_size: int | None = None, mode: str = "compiled"):
    """Newton's method with UDA-accumulated gradient/Hessian (IRLS engine).
    Returns ``(params, [(loss, delta), ...], converged)``."""
    res = fit(NewtonTask(program, params0, ridge), table,
              max_iters=max_iters, tol=tol, block_size=block_size, mode=mode)
    return res.state["params"], _trace_pairs(res.trace), res.converged


class SGDEpochTask(IterativeTask):
    """One executor iteration = one SGD epoch (Bismarck's IGD): a shuffled
    pass over the rows, optionally with Robbins-Monro stepsizes (paper
    Eq. 1, ``anneal=True``).

    SGD is not a pure fold, so this task overrides :meth:`iteration` and
    reads rows through ``run_pass.columns``.  Each epoch takes a fresh
    permutation, drops the ``n mod batch`` tail rows and steps once per
    minibatch by the ``total_loss`` gradient over ``batch``, as the
    reference does.  The generator stays on the task (it is no tensor),
    made on the table's device; the state is ``params`` and ``epoch``.
    An epoch runs one ``torch.func.grad`` call per minibatch and pulls
    nothing to the host.

    On a mesh the carry is per segment: each segment runs its epochs on
    its own rows, drawing its permutations from the task's one generator
    in segment order, and :meth:`mesh_epilogue` averages the models once
    (the one-round mean-merge UDA of §5.1)."""

    def __init__(self, program: ConvexProgram, params0, stepsize: float,
                 batch: int, seed=0, anneal: bool = True):
        self.program = program
        self.params0 = params0
        self.stepsize = stepsize
        self.batch = batch
        self.seed = seed
        self.anneal = anneal
        self._gen = None

    def init_state(self, columns):
        return {"params": self.params0, "epoch": np.int32(0)}

    def iteration(self, state, run_pass):
        columns = run_pass.columns
        if columns is None:
            raise ValueError("SGDEpochTask needs row access; the stream "
                             "engine cannot shuffle minibatches")
        first = next(iter(columns.values()))
        n, dev = first.shape[0], first.device
        if self._gen is None:
            self._gen = _generator(self.seed, dev)
        nb = n // self.batch
        alpha = self.stepsize / (1.0 + state["epoch"].to(torch.float32)) \
            if self.anneal else torch.tensor(self.stepsize,
                                             dtype=torch.float32, device=dev)
        perm = torch.randperm(n, generator=self._gen, device=dev)[
            : nb * self.batch].reshape(nb, self.batch)
        gmask = run_pass.mask
        ones = torch.ones((self.batch,), dtype=torch.bool, device=dev)
        grad = torch.func.grad(self.program.total_loss)
        params = state["params"]
        for idx in perm:
            block = {k: v[idx] for k, v in columns.items()}
            g = grad(params, block, ones if gmask is None else gmask[idx])
            params = tree_map(lambda p, gg: p - alpha * gg / self.batch,
                              params, g)
        new = {"params": params, "epoch": state["epoch"] + 1}
        return new, torch.zeros((), device=dev), \
            torch.tensor(float("inf"), device=dev)

    def mesh_epilogue(self, states):
        # model averaging: the mean of the segments' models, summed in
        # segment order (the reference's pmean)
        n = len(states)
        params = tree_map(lambda *ps: reduce(torch.add, ps) / n,
                          *[s["params"] for s in states])
        return {**states[0], "params": params}


def sgd(program: ConvexProgram, table: Table, params0, *,
        stepsize: float = 1e-2, epochs: int = 1, batch: int = 64, seed=0,
        anneal: bool = True):
    """Single-shard SGD with Robbins-Monro annealing (paper Eq. 1).
    Epochs run as counted executor iterations; ``seed`` (an int or a
    ``torch.Generator`` on the table's device) drives the shuffles."""
    task = SGDEpochTask(program, params0, stepsize, batch, seed, anneal)
    res = fit(task, table, max_iters=epochs, tol=None, engine="local")
    return res.state["params"]


def parallel_sgd(program: ConvexProgram, table: Table, params0, *,
                 stepsize: float = 1e-2, epochs: int = 1, batch: int = 64,
                 mesh=None, row_axes=("data",), seed=0):
    """Zinkevich model-averaging SGD [47]: each segment of ``mesh`` (the
    table's when None) runs ``epochs`` epochs at a constant stepsize on
    its own rows, then the models are averaged once
    (:meth:`SGDEpochTask.mesh_epilogue`).  ``seed`` (an int or a
    ``torch.Generator``) is the statement's generator: the segments draw
    from it in segment order.  Without a mesh it is :func:`sgd`, as in
    the reference."""
    mesh, row_axes = table_mesh("parallel_sgd", mesh, row_axes, table)
    if mesh is None:
        return sgd(program, table, params0, stepsize=stepsize, epochs=epochs,
                   batch=batch, seed=seed)
    task = SGDEpochTask(program, params0, stepsize, batch, seed,
                        anneal=False)
    res = fit(task, table, max_iters=epochs, tol=None, engine="sharded",
              mesh=mesh, row_axes=row_axes)
    return res.state["params"]


def conjugate_gradient(matvec: Callable[[torch.Tensor], torch.Tensor],
                       b: torch.Tensor, x0: torch.Tensor | None = None, *,
                       tol: float = 1e-8, max_iters: int | None = None):
    """MADlib's conjugate-gradient support module: solve A x = b for SPD A
    given only ``matvec``.  Returns ``(x, residual norm, iterations)``.

    A host loop that pulls the residual ``rs`` once per iteration (the
    reference runs a device ``while_loop``; a device loop belongs to
    ROADMAP item 7).  The stopping test compares in f32, as the
    reference's does."""
    n = b.shape[0]
    max_iters = max_iters or 2 * n
    x = torch.zeros_like(b) if x0 is None else x0
    tol2 = float(np.float32(tol * tol))
    r = b - matvec(x)
    p = r
    rs = torch.vdot(r, r).real
    i = 0
    while i < max_iters and float(rs) > tol2:
        ap = matvec(p)
        alpha = rs / (torch.vdot(p, ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.vdot(r, r).real
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
        i += 1
    return x, torch.sqrt(rs), i
