"""Binary logistic regression — the paper's multipass example (§4.2).

The port's counterpart of the reference ``methods/logregr.py``.  Solver:
Newton's method as *iteratively reweighted least squares*,
``β ← (X^T D X)^{-1} X^T D z`` with ``D = diag(p(1-p))`` and
``z = Xβ + D^{-1}(y - p)``.  Each iteration is one UDA execution
(transition accumulates ``X^T D X`` and ``X^T D z``; merge = sum); the
outer loop is :class:`IRLSTask` under the unified iterative executor
(§3.1.2 driver pattern), which also fits one model per group
(:func:`logregr_grouped`).  The products are plain ``torch.matmul``
(no kernel: the reference leaves them to XLA too), in f32 without TF32.

:func:`logregr_stream` fits out of core, streaming the blocks of a fresh
block source every round.  The §5.1 SGD path (Table 2's "Logistic
Regression" row) is :func:`logistic_program` under
:mod:`repro_torch.core.convex`, fit by :func:`logregr_sgd`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.convex import ConvexProgram
from ..core.convex import parallel_sgd, sgd as sgd_solver
from ..core.iterative import IterativeTask
from ..core.plan import IterativeFit, execute
from ..core.table import Table


@dataclasses.dataclass
class LogregrResult:
    coef: torch.Tensor
    log_likelihood: torch.Tensor
    std_err: torch.Tensor
    z_stats: torch.Tensor
    p_values: torch.Tensor
    n_iters: int
    converged: bool


class IRLSAggregate(Aggregate):
    """One IRLS round: accumulate X^T D X, X^T D z, and the log-likelihood."""

    merge_ops = MERGE_SUM

    def __init__(self, beta: torch.Tensor):
        self.beta = beta

    def init(self, block):
        x = block["x"]
        d = x.shape[-1]

        def zeros(*shape):
            return torch.zeros(shape, dtype=x.dtype, device=x.device)

        return {"xdx": zeros(d, d), "xdz": zeros(d), "ll": zeros(),
                "n": zeros()}

    def transition(self, state, block, mask):
        x = block["x"]
        y = block["y"]
        m = mask.to(x.dtype)
        eta = x @ self.beta
        p = torch.sigmoid(eta)
        pq = torch.clamp(p * (1.0 - p), min=1e-10)
        w = pq * m                                  # D diagonal
        z = eta + (y - p) / pq
        xw = x * w[:, None]
        ll = torch.sum(m * (y * eta - torch.logaddexp(eta,
                                                      torch.zeros_like(eta))))
        return {
            "xdx": state["xdx"] + xw.T @ x,
            "xdz": state["xdz"] + xw.T @ z,
            "ll": state["ll"] + ll,
            "n": state["n"] + torch.sum(m),
        }


class IRLSTask(IterativeTask):
    """IRLS as an executor task: state = β; one pass = one IRLSAggregate;
    driver update = the weighted-least-squares solve; metric = relative
    coefficient change; finalize = Wald statistics from the last pass's
    Fisher information."""

    def __init__(self, ridge: float = 1e-8):
        self.ridge = ridge

    def init_state(self, columns):
        x = columns["x"]
        return {"beta": torch.zeros((x.shape[-1],), dtype=x.dtype,
                                    device=x.device)}

    def make_aggregate(self, state):
        return IRLSAggregate(state["beta"])

    def update(self, state, out):
        xdx = out["xdx"]
        eye = torch.eye(xdx.shape[0], dtype=xdx.dtype, device=xdx.device)
        beta = torch.linalg.solve(xdx + self.ridge * eye,
                                  out["xdz"][:, None])[:, 0]
        return {"beta": beta}

    def metric(self, prev, new, out):
        return torch.linalg.norm(new["beta"] - prev["beta"]) \
            / (torch.linalg.norm(prev["beta"]) + 1e-12)

    def finalize(self, state, out):
        # Wald statistics from the final Fisher information (X^T D X)^{-1}.
        beta = state["beta"]
        xdx = out["xdx"]
        eye = torch.eye(xdx.shape[0], dtype=xdx.dtype, device=xdx.device)
        cov = torch.linalg.inv(xdx + 1e-8 * eye)
        se = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
        z = beta / torch.clamp(se, min=1e-30)
        p = 2.0 * (1.0 - torch.special.ndtr(torch.abs(z)))
        return {"coef": beta, "ll": out["ll"], "se": se, "z": z, "p": p}


def _result(res) -> LogregrResult:
    f = res.result
    return LogregrResult(f["coef"], f["ll"], f["se"], f["z"], f["p"],
                         res.n_iters, res.converged)


def logregr(table: Table, *, x_col: str = "x", y_col: str = "y",
            max_iters: int = 30, tol: float = 1e-6,
            block_size: int | None = None, mode: str = "compiled",
            warm_start=None) -> LogregrResult:
    """``SELECT * FROM logregr('y', 'x', 'data')`` — IRLS under the
    unified executor.  ``warm_start`` is a starting β (tensor or numpy
    array, e.g. a reference package's coefficients)."""
    t = Table({"x": table[x_col], "y": table[y_col]}, table.mesh,
              table.row_axes)
    ws = None if warm_start is None else {"beta": warm_start}
    res = execute(IterativeFit(IRLSTask(), t, max_iters=max_iters, tol=tol,
                               block_size=block_size, mode=mode,
                               warm_start=ws, label="logregr"))
    return _result(res)


def logregr_stream(blocks_factory, *, max_iters: int = 30,
                   tol: float = 1e-6, device=None) -> LogregrResult:
    """Out-of-core IRLS: each iteration streams the blocks from a fresh
    ``blocks_factory()`` (dicts with "x"/"y") with the state on
    ``device`` (the card unless ``device="cpu"``)."""
    res = execute(IterativeFit(IRLSTask(), blocks=blocks_factory,
                               max_iters=max_iters, tol=tol,
                               label="logregr_stream", device=device))
    return _result(res)


def logregr_grouped(table: Table, key_col: str,
                    num_groups: int | None = None, *,
                    x_col: str = "x", y_col: str = "y",
                    max_iters: int = 30, tol: float = 1e-6,
                    block_size: int | None = None,
                    mesh=None) -> LogregrResult:
    """One logistic model per group, fit in shared scans
    (``SELECT g, (logregr(y, x)).* FROM data GROUP BY g``).  Every field
    of the result carries a leading group axis; ``n_iters``/``converged``
    are per-group vectors.  ``mesh`` (the table's when None) fits on the
    sharded segment layout."""
    t = Table({"x": table[x_col], "y": table[y_col],
               key_col: table[key_col]}, table.mesh, table.row_axes)
    res = execute(IterativeFit(IRLSTask(), t, group_col=key_col,
                               num_groups=num_groups, max_iters=max_iters,
                               tol=tol, block_size=block_size, mesh=mesh,
                               label="logregr_grouped"))
    return _result(res)


# ---------------------------------------------------------------------------
# §5.1 SGD path (Table 2 "Logistic Regression" row).
# ---------------------------------------------------------------------------

def logistic_program(mu: float = 0.0) -> ConvexProgram:
    """Σ log(1 + exp(-y·xᵀw)) with y ∈ {−1,+1} encoded from {0,1}."""

    def loss(params, block, mask):
        sgn = 2.0 * block["y"] - 1.0
        return torch.sum(torch.nn.functional.softplus(
            -sgn * (block["x"] @ params)) * mask.to(torch.float32))

    reg = (lambda p: 0.5 * mu * torch.sum(p ** 2)) if mu > 0 else None
    return ConvexProgram(loss=loss, regularizer=reg)


def logregr_sgd(table: Table, *, epochs: int = 5, stepsize: float = 0.5,
                batch: int = 128, seed=0, mu: float = 0.0) -> torch.Tensor:
    """Logistic regression by SGD from w = 0; ``seed`` (an int or a
    ``torch.Generator`` on the table's device) drives the shuffles.  On a
    distributed table: :func:`~repro_torch.core.convex.parallel_sgd`."""
    w0 = torch.zeros((table["x"].shape[-1],), device=table.device)
    solver = parallel_sgd if table.mesh is not None else sgd_solver
    return solver(logistic_program(mu), table, w0, stepsize=stepsize,
                  epochs=epochs, batch=batch, seed=seed)
