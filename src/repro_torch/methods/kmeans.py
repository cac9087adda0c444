"""k-means clustering — the paper's large-state iteration example (§4.3).

The port's counterpart of the reference ``methods/kmeans.py``.  Both
execution variants are tasks under the unified iterative executor
(:mod:`repro_torch.core.iterative`):

* :class:`KMeansTask` (``variant="fused"``): assignment + barycenter +
  reassignment count fuse into ONE pass per round (the paper's footnote 1
  says standard SQL *cannot* express this); with ``use_kernel`` through
  the hand-written ``kmeans_assign`` CUDA kernel.
* :class:`KMeansTwoPassTask` (``variant="two_pass"``, paper-faithful): a
  Lloyd round is TWO passes — barycenters by the *stored* assignment
  column, then an UPDATE of that column counting reassignments.  The
  assignment column is driver state; blocks address it through a
  ``__row__`` index column.

Seeding: k-means++, each round's D² statistics in ONE fused scan (a sum
aggregate for the potential plus a Gumbel-max argmax aggregate that
samples the next seed ∝ D²).  The reference draws with ``jax.random``,
whose bits PyTorch cannot reproduce; here an explicit integer ``seed``
(or a ``torch.Generator``) takes the place of its ``key``, and every
row's uniform comes from a counter-based hash of ``(seed, round, row)``:
the pick does not depend on the block size, and the CPU and the card
choose the same seeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.iterative import IterativeTask
from ..core.plan import IterativeFit, execute
from ..core.session import Session
from ..core.table import Table, as_column
from ..kernels.registry import dispatch, resolve_impl
from ..kernels.sketch_hash import _U32, _fmix32


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n,d),(k,d) -> (n,k) squared distances via the matmul identity."""
    xx = torch.sum(x * x, -1, keepdim=True)
    cc = torch.sum(c * c, -1)
    return xx - 2.0 * (x @ c.T) + cc[None, :]


def _one_hot(assign: torch.Tensor, k: int, m: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.one_hot(assign.long(), k).to(m.dtype) \
        * m[:, None]


def _new_centroids(s, centroids):
    safe = torch.clamp(s["counts"][:, None], min=1.0)
    return torch.where(s["counts"][:, None] > 0, s["sums"] / safe, centroids)


class KMeansAggregate(Aggregate):
    """One fused Lloyd round as a UDA.

    Inter-iteration state = centroids (closed over, on the device);
    intra-iteration state = {sums, counts, sse, moved} — the paper's
    inter/intra split (§4.3.1).  ``moved`` counts rows whose assignment
    changed against ``prev_centroids``.  With ``use_kernel`` both
    assignments come from ``kmeans_assign`` (the previous one keeps only
    the kernel's ``assign``), so a near-tie row is assigned alike in both
    and does not count as moved once the centroids stop moving."""

    merge_ops = MERGE_SUM

    def __init__(self, centroids: torch.Tensor,
                 prev_centroids: torch.Tensor | None,
                 use_kernel: bool | str = False):
        self.centroids = centroids
        self.prev_centroids = prev_centroids
        self.kernel_impl = resolve_impl(use_kernel)

    def init(self, block):
        k, d = self.centroids.shape
        c = self.centroids

        def zeros(*shape):
            return torch.zeros(shape, dtype=c.dtype, device=c.device)

        return {"sums": zeros(k, d), "counts": zeros(k), "sse": zeros(),
                "moved": zeros()}

    def transition(self, state, block, mask):
        x = block["x"]
        m = mask.to(x.dtype)
        k = self.centroids.shape[0]
        if self.kernel_impl is not None:
            assign, mind, sums, counts = dispatch(
                "kmeans_assign", x, self.centroids, m,
                impl=self.kernel_impl)
        else:
            d2 = _sq_dists(x, self.centroids)
            assign = torch.argmin(d2, dim=-1)
            mind = torch.amin(d2, dim=-1)
            onehot = _one_hot(assign, k, m)
            sums = onehot.T @ x
            counts = torch.sum(onehot, dim=0)
        if self.prev_centroids is not None:
            if self.kernel_impl is not None:
                prev_assign = dispatch(
                    "kmeans_assign", x, self.prev_centroids, m,
                    impl=self.kernel_impl)[0]
            else:
                prev_assign = torch.argmin(
                    _sq_dists(x, self.prev_centroids), dim=-1)
            moved = torch.sum((prev_assign != assign).to(x.dtype) * m)
        else:
            moved = torch.zeros((), dtype=x.dtype, device=x.device)
        return {
            "sums": state["sums"] + sums,
            "counts": state["counts"] + counts,
            "sse": state["sse"] + torch.sum(mind * m),
            "moved": state["moved"] + moved,
        }

    def final(self, s):
        return {"centroids": _new_centroids(s, self.centroids),
                "sse": s["sse"], "moved": s["moved"], "counts": s["counts"]}


class KMeansStoredAssignAggregate(Aggregate):
    """Statement 1 of the two-pass round: barycenters by the STORED
    assignment column (the paper's "avoid half of the closest-centroid
    calculations").  The (n,) assignment lives in driver state; blocks
    address it through the ``__row__`` index column."""

    merge_ops = MERGE_SUM

    def __init__(self, centroids: torch.Tensor, assign: torch.Tensor):
        self.centroids = centroids
        self.assign = assign

    def init(self, block):
        k, d = self.centroids.shape
        c = self.centroids

        def zeros(*shape):
            return torch.zeros(shape, dtype=c.dtype, device=c.device)

        return {"sums": zeros(k, d), "counts": zeros(k), "sse": zeros()}

    def transition(self, state, block, mask):
        x = block["x"]
        m = mask.to(x.dtype)
        assign = self.assign[block["__row__"].long()].long()
        d2 = _sq_dists(x, self.centroids)
        mind = torch.take_along_dim(d2, assign[:, None], dim=1)[:, 0]
        onehot = _one_hot(assign, self.centroids.shape[0], m)
        return {
            "sums": state["sums"] + onehot.T @ x,
            "counts": state["counts"] + torch.sum(onehot, dim=0),
            "sse": state["sse"] + torch.sum(mind * m),
        }

    def final(self, s):
        return {"centroids": _new_centroids(s, self.centroids),
                "sse": s["sse"], "counts": s["counts"]}


class KMeansReassignAggregate(Aggregate):
    """Statement 2: ``UPDATE points SET centroid_id = closest(...)`` as a
    scatter-valued UDA plus the reassignment count.  Each row is owned by
    exactly one block, so the scattered column sum-merges."""

    merge_ops = MERGE_SUM

    def __init__(self, centroids: torch.Tensor, prev_assign: torch.Tensor):
        self.centroids = centroids
        self.prev_assign = prev_assign

    def init(self, block):
        dev = self.prev_assign.device
        return {"assign": torch.zeros(self.prev_assign.shape,
                                      dtype=torch.int32, device=dev),
                "moved": torch.zeros((), device=dev)}

    def transition(self, state, block, mask):
        rows = block["__row__"].long()
        assign = torch.argmin(_sq_dists(block["x"], self.centroids),
                              dim=-1).to(torch.int32)
        prev = self.prev_assign[rows]
        moved = torch.sum(((assign != prev) & mask).to(torch.float32))
        return {
            "assign": state["assign"].index_add(
                0, rows, assign * mask.to(torch.int32)),
            "moved": state["moved"] + moved,
        }


class KMeansTask(IterativeTask):
    """Fused Lloyd iteration: ONE shared scan per round."""

    def __init__(self, init_centroids, use_kernel: bool | str = False):
        self.init_centroids = init_centroids
        self.use_kernel = use_kernel

    def init_state(self, columns):
        x = columns["x"]
        c = as_column(self.init_centroids, x.device).to(x.dtype)
        return {"cents": c, "prev": c,
                "it": torch.zeros((), dtype=torch.int32, device=x.device)}

    def make_aggregate(self, state):
        return KMeansAggregate(state["cents"], state["prev"],
                               self.use_kernel)

    def update(self, state, out):
        return {"cents": out["centroids"], "prev": state["cents"],
                "it": state["it"] + 1}

    def metric(self, prev, new, out):
        # reassignment fraction; the first round has no meaningful count
        n = torch.clamp(torch.sum(out["counts"]), min=1.0)
        return torch.where(new["it"] <= 1,
                           torch.full_like(out["moved"], float("inf")),
                           out["moved"] / n)

    def trace_record(self, state, out, m):
        return out["sse"]


class KMeansTwoPassTask(IterativeTask):
    """Paper-faithful Lloyd iteration: two statements (= two data passes)
    per round, with the assignment column as driver state.  No
    ``use_kernel``: neither statement computes the fused assign and
    barycenter that ``kmeans_assign`` implements."""

    def __init__(self, init_centroids):
        self.init_centroids = init_centroids

    def init_state(self, columns):
        x = columns["x"]
        c = as_column(self.init_centroids, x.device).to(x.dtype)
        # statement 0: materialize the assignment column
        assign = torch.argmin(_sq_dists(x, c), dim=-1).to(torch.int32)
        return {"cents": c, "assign": assign,
                "it": torch.zeros((), dtype=torch.int32, device=x.device)}

    def iteration(self, state, run_pass):
        # statement 1 (data pass 1): barycenters by stored assignment
        out = run_pass(KMeansStoredAssignAggregate(state["cents"],
                                                   state["assign"]))
        # statement 2 (data pass 2): refresh assignments, count moves
        upd = run_pass(KMeansReassignAggregate(out["centroids"],
                                               state["assign"]))
        new = {"cents": out["centroids"], "assign": upd["assign"],
               "it": state["it"] + 1}
        n = torch.clamp(torch.sum(out["counts"]), min=1.0)
        m = torch.where(new["it"] <= 1,
                        torch.full_like(upd["moved"], float("inf")),
                        upd["moved"] / n)
        return new, {"sse": out["sse"], "counts": out["counts"]}, m

    def trace_record(self, state, out, m):
        return out["sse"]


@dataclasses.dataclass
class KMeansResult:
    centroids: torch.Tensor
    sse: float
    n_iters: int
    converged: bool
    sse_trace: list


# ---------------------------------------------------------------------------
# k-means++ seeding: one fused scan per pick.
# ---------------------------------------------------------------------------

def _seed_int(seed) -> int:
    """An integer seed, or one drawn from a ``torch.Generator``."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=seed,
                                 device=seed.device))
    return int(seed)


def _row_uniform(seed: int, rnd: int, rows: torch.Tensor) -> torch.Tensor:
    """A uniform in (0, 1) for every row, from a counter-based hash of
    ``(seed, round, row)``: ``fmix32`` in int64 masked to 32 bits (as the
    sketches hash), its top 24 bits centered, exact in f32."""
    s = seed & _U32
    h = _fmix32((rows.to(torch.int64) * 0x9E3779B1 + s) & _U32)
    h = _fmix32(h ^ ((rnd * 0x85EBCA77 + (seed >> 32) + 0x27D4EB2F) & _U32))
    return ((h >> 8).to(torch.float32) + 0.5) / float(1 << 24)


class SumD2Aggregate(Aggregate):
    """Normalizer Σ D² (the k-means++ "potential") of the running d2
    column."""

    merge_ops = MERGE_SUM

    def init(self, block):
        return torch.zeros((), device=block["d2"].device)

    def transition(self, state, block, mask):
        return state + torch.sum(block["d2"] * mask.to(torch.float32))


class GumbelPickAggregate(Aggregate):
    """Samples one row ∝ its ``d2`` column in a single scan via the
    Gumbel-max trick: argmax(log d2 + Gumbel) over rows.  The argmax
    state (score, winning row's x) uses a generic merge; the per-row
    uniforms are keyed by ``(seed, round, __row__)``."""

    merge_ops = None  # generic: compare-and-keep is not leaf-wise

    def __init__(self, seed: int, rnd: int, d: int):
        self.seed = seed
        self.rnd = rnd
        self.d = d

    def init(self, block):
        x = block["x"]
        return {"score": torch.full((), float("-inf"), device=x.device),
                "x": torch.zeros((self.d,), dtype=x.dtype, device=x.device)}

    def transition(self, state, block, mask):
        d2 = block["d2"]
        u = _row_uniform(self.seed, self.rnd, block["__row__"])
        gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-12, 1.0 - 1e-12)))
        score = torch.where(
            mask & (d2 > 0.0),
            torch.log(torch.clamp(d2, min=1e-30)) + gumbel,
            torch.full_like(d2, float("-inf")))
        i = torch.argmax(score)
        return self.merge(state, {"score": score[i], "x": block["x"][i]})

    def merge(self, a, b):
        take_b = b["score"] > a["score"]
        return {k: torch.where(take_b, b[k], a[k]) for k in a}


def kmeans_pp_seed(table: Table, k: int, seed=0, x_col: str = "x",
                   block_size: int | None = None) -> torch.Tensor:
    """k-means++ seeding in ONE fused scan per pick: the D² normalizer
    (potential) and the Gumbel-max sampler are two planned statements
    over the same round table, which the planner fuses into one pass; the
    running D² column is refreshed against only the newest center.
    ``seed`` is an int or a ``torch.Generator``; the first center is the
    row the same hash picks at round 0."""
    s = _seed_int(seed)
    x = table[x_col]
    n, d = x.shape
    rows = torch.arange(n, dtype=torch.int32, device=x.device)
    first = int(torch.argmax(_row_uniform(s, 0, rows)))
    cents = [x[first]]
    d2 = torch.sum((x - cents[0][None, :]) ** 2, -1)
    for r in range(1, k):
        t = Table({"x": x, "d2": d2, "__row__": rows}, table.mesh,
                  table.row_axes)
        sess = Session()
        z = sess.scan(SumD2Aggregate(), t, block_size=block_size,
                      label="kmeans++:potential")
        pick = sess.scan(GumbelPickAggregate(s, r, d), t,
                         block_size=block_size, label="kmeans++:pick")
        sess.run()
        # degenerate potential (all points on centers): fall back to row 0
        newc = torch.where(z.result() > 0.0, pick.result()["x"], x[0])
        cents.append(newc)
        d2 = torch.minimum(d2, torch.sum((x - newc[None, :]) ** 2, -1))
    return torch.stack(cents)


# ---------------------------------------------------------------------------
# Drivers.
# ---------------------------------------------------------------------------

def kmeans_fit(table: Table, k: int, *, seed=0, max_iters: int = 50,
               reassign_frac_tol: float = 0.0, variant: str = "fused",
               block_size: int | None = None, init_centroids=None,
               init: str = "kmeans++", use_kernel: bool | str = False,
               x_col: str = "x", mode: str = "compiled") -> KMeansResult:
    """Lloyd's algorithm under the unified executor (§3.1.2 pattern).

    ``init_centroids`` (tensor or numpy array) warm-starts the task;
    otherwise ``init`` picks the seeding ("kmeans++" = the fused
    one-scan-per-pick seeding, "random" = distinct uniform rows), drawn
    from ``seed`` (an int or a ``torch.Generator``, in place of the
    reference's ``key``).  Converges when the reassignment fraction drops
    to ``reassign_frac_tol`` (checked from round 2)."""
    if variant not in ("fused", "two_pass"):
        raise ValueError(f"unknown variant {variant!r}")
    t = Table({"x": table[x_col]}, table.mesh, table.row_axes)
    n = t.n_rows
    if init_centroids is not None:
        cents = as_column(init_centroids, t.device)
    elif init == "kmeans++":
        cents = kmeans_pp_seed(t, k, seed)
    elif init == "random":
        gen = torch.Generator()
        gen.manual_seed(_seed_int(seed))
        pick = torch.randperm(n, generator=gen)[:k]
        cents = t["x"][pick.to(t.device)]
    else:
        raise ValueError(f"unknown init {init!r}")

    if variant == "two_pass":
        t = t.with_column("__row__", torch.arange(n, dtype=torch.int32))
        task: IterativeTask = KMeansTwoPassTask(cents)
    else:
        task = KMeansTask(cents, use_kernel)
    # moved/n is an integer multiple of 1/n, so +0.5/n makes "< tol"
    # exactly the paper's "moved <= reassign_frac_tol * n"
    res = execute(IterativeFit(task, t, max_iters=max_iters,
                               tol=reassign_frac_tol + 0.5 / n,
                               block_size=block_size, mode=mode,
                               label="kmeans"))
    sse_trace = [float(v) for v in res.trace]
    return KMeansResult(res.state["cents"], sse_trace[-1], res.n_iters,
                        res.converged, sse_trace)


def kmeans_grouped(table: Table, key_col: str, k: int,
                   num_groups: int | None = None, *, init_centroids,
                   max_iters: int = 50, reassign_frac_tol: float = 0.0,
                   x_col: str = "x", use_kernel: bool | str = False,
                   mesh=None) -> KMeansResult:
    """One k-means model per group in shared scans (GROUP BY fitting).

    ``init_centroids`` is required — either one ``(k, d)`` seeding shared
    by every group or a stacked ``(G, k, d)`` per-group seeding.  Returns
    a :class:`KMeansResult` whose fields carry a leading group axis.
    ``use_kernel`` routes every group's transition through
    ``kmeans_assign``; ``mesh`` (the table's when None) runs the grouped
    Lloyd loop on the sharded segment layout."""
    t = Table({"x": table[x_col], key_col: table[key_col]}, table.mesh,
              table.row_axes)
    init_centroids = as_column(init_centroids, t.device)
    task = KMeansTask(init_centroids if init_centroids.dim() == 2
                      else init_centroids[0], use_kernel)
    warm = None
    if init_centroids.dim() == 3:
        warm = {"cents": init_centroids, "prev": init_centroids,
                "it": torch.zeros((init_centroids.shape[0],),
                                  dtype=torch.int32)}
    n = t.n_rows
    res = execute(IterativeFit(task, t, group_col=key_col,
                               num_groups=num_groups, max_iters=max_iters,
                               tol=reassign_frac_tol + 0.5 / n,
                               warm_start=warm, mesh=mesh,
                               label="kmeans_grouped"))
    if res.trace is not None:
        g = torch.arange(len(res.n_iters), device=res.trace.device)
        last = torch.as_tensor(np.asarray(res.n_iters) - 1,
                               device=res.trace.device)
        sse = res.trace[g, last]
    else:
        sse = res.trace
    return KMeansResult(res.state["cents"], sse, res.n_iters,
                        res.converged, res.trace)
