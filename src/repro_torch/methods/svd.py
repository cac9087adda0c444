"""SVD matrix factorization (paper Table 1), the scan half.

The port's counterpart of the reference ``methods/svd.py``.  Two
in-database algorithms over a row-distributed matrix table:

* :func:`svd_power`: subspace (block power) iteration; each round is
  one UDA computing ``A^T (A Q)`` over row blocks (two matmuls per block,
  merge = sum), then a thin QR on the driver (k x k scale work).
* :func:`svd_randomized`: the Halko range finder with the same
  aggregate on a random test matrix, then a small eigendecomposition.

An integer ``seed`` or a ``torch.Generator`` (on the table's device)
replaces the reference's ``key``.  ``torch.linalg.qr`` and ``eigh`` pick
their own signs, so results compare by singular values and subspaces,
not by vectors.  :func:`lowrank_program` and :func:`lowrank_sgd` are
Table 2's recommender: low-rank matrix factorization by SGD under
:mod:`repro_torch.core.convex`.
"""

from __future__ import annotations

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.convex import ConvexProgram, sgd
from ..core.plan import ScanAgg, execute
from ..core.table import Table, _generator


class AtAQAggregate(Aggregate):
    """Accumulate A^T (A Q) over row blocks."""

    merge_ops = MERGE_SUM

    def __init__(self, q: torch.Tensor):
        self.q = q

    def init(self, block):
        a = block["a"]
        return torch.zeros((a.shape[-1], self.q.shape[1]),
                           dtype=self.q.dtype, device=a.device)

    def transition(self, state, block, mask):
        a = block["a"] * mask[:, None].to(block["a"].dtype)
        return state + a.T @ (a @ self.q)


def _run(agg, table, block_size):
    return execute(ScanAgg(agg, table, block_size=block_size,
                           label="svd:AtAQ"))


def _ritz(q, z, k: int):
    """Rayleigh-Ritz on span(q): singular values and right vectors."""
    w, u = torch.linalg.eigh(q.T @ z)
    order = torch.argsort(-w)[:k]
    return torch.sqrt(torch.clamp(w[order], min=0.0)), q @ u[:, order]


def svd_power(table: Table, k: int, *, n_iters: int = 20, seed=0,
              a_col: str = "a", block_size: int | None = None):
    """Top-k SVD by block power iteration on A^T A (driver + UDA
    rounds).  Returns (singular values (k,), right vectors (d, k))."""
    t = Table({"a": table[a_col]}, table.mesh, table.row_axes)
    d, dev = t["a"].shape[-1], t.device
    gen = _generator(seed, dev)
    q, _ = torch.linalg.qr(torch.randn((d, k), generator=gen, device=dev))
    for _ in range(n_iters):
        q, _ = torch.linalg.qr(_run(AtAQAggregate(q), t, block_size))
    return _ritz(q, _run(AtAQAggregate(q), t, block_size), k)


def svd_randomized(table: Table, k: int, *, oversample: int = 8,
                   n_power_iters: int = 2, seed=0, a_col: str = "a",
                   block_size: int | None = None):
    """Randomized SVD (Halko): range finding, power sharpening and a
    small eigendecomposition.  Power iterations matter for flat
    spectra."""
    t = Table({"a": table[a_col]}, table.mesh, table.row_axes)
    d, dev = t["a"].shape[-1], t.device
    gen = _generator(seed, dev)
    omega = torch.randn((d, k + oversample), generator=gen, device=dev)
    q, _ = torch.linalg.qr(_run(AtAQAggregate(omega), t, block_size))
    for _ in range(n_power_iters):
        q, _ = torch.linalg.qr(_run(AtAQAggregate(q), t, block_size))
    return _ritz(q, _run(AtAQAggregate(q), t, block_size), k)


# ---------------------------------------------------------------------------
# Table 2 "Recommendation": low-rank matrix factorization by SGD.
# ---------------------------------------------------------------------------

def lowrank_program(n_rows: int, n_cols: int, rank: int, mu: float = 1e-2
                    ) -> ConvexProgram:
    """Σ (L_i · R_j − v)² over rating rows {i, j, v} (ids stored as
    floats, as the reference's table holds them), + μ/2 (‖L‖² + ‖R‖²)."""

    def loss(params, block, mask):
        l = params["L"][block["i"].to(torch.int64)]
        r = params["R"][block["j"].to(torch.int64)]
        pred = torch.sum(l * r, -1)
        return torch.sum(((pred - block["v"]) ** 2) * mask.to(torch.float32))

    def reg(params):
        return 0.5 * mu * (torch.sum(params["L"] ** 2)
                           + torch.sum(params["R"] ** 2))

    return ConvexProgram(loss=loss, regularizer=reg)


def lowrank_sgd(table: Table, n_rows: int, n_cols: int, rank: int, *,
                mu: float = 1e-5, epochs: int = 80, stepsize: float = 0.1,
                batch: int = 256, seed=0, init_scale: float = 0.5):
    """Fit ``{"L": (n_rows, rank), "R": (n_cols, rank)}``.  One
    ``torch.Generator`` (``seed``, an int or a generator on the table's
    device) draws L, then R, then the shuffles, where the reference
    splits its key three ways."""
    dev = table.device
    gen = _generator(seed, dev)
    # init away from the L=R=0 saddle; constant stepsize (annealing stalls
    # the plateau escape on this non-convex objective)
    params = {
        "L": init_scale * torch.randn((n_rows, rank), generator=gen,
                                      device=dev),
        "R": init_scale * torch.randn((n_cols, rank), generator=gen,
                                      device=dev),
    }
    prog = lowrank_program(n_rows, n_cols, rank, mu)
    return sgd(prog, table, params, stepsize=stepsize, epochs=epochs,
               batch=batch, seed=gen, anneal=False)
