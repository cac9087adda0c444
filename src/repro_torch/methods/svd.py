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
not by vectors.  ``lowrank_program`` and ``lowrank_sgd`` (the Table 2
recommender) need the convex solver layer and raise until it is ported.
"""

from __future__ import annotations

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
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
    t = Table({"a": table[a_col]})
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
    t = Table({"a": table[a_col]})
    d, dev = t["a"].shape[-1], t.device
    gen = _generator(seed, dev)
    omega = torch.randn((d, k + oversample), generator=gen, device=dev)
    q, _ = torch.linalg.qr(_run(AtAQAggregate(omega), t, block_size))
    for _ in range(n_power_iters):
        q, _ = torch.linalg.qr(_run(AtAQAggregate(q), t, block_size))
    return _ritz(q, _run(AtAQAggregate(q), t, block_size), k)


def _needs_convex(what: str):
    raise NotImplementedError(
        f"{what} needs the convex solver layer (core/convex.py), which is "
        "not ported to repro_torch yet (ROADMAP Queue 1 item 9)")


def lowrank_program(*args, **kwargs):
    _needs_convex("lowrank_program")


def lowrank_sgd(*args, **kwargs):
    _needs_convex("lowrank_sgd")
