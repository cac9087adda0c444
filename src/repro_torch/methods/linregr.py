"""Ordinary least squares — the paper's single-pass UDA example (§4.1).

The port's counterpart of the reference ``methods/linregr.py``.  State:
``X^T X``, ``X^T y`` and the moments of ``y``; merge = sum; final = the
pseudo-inverse solve plus the statistics MADlib's linregr returns (R²,
standard errors, t statistics, p-values, condition number).  ``final``
takes an optional leading group axis, so a grouped fold finalizes in
one batched call.  :class:`LinregrTask` is OLS as a one-round executor
task, which is what buys it ``GROUP BY`` fitting through
:func:`~repro_torch.core.iterative.fit_grouped`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.iterative import IterativeTask
from ..core.join import Join
from ..core.plan import GroupedScanAgg, JoinedGroupedScanAgg, ScanAgg, execute
from ..core.table import Table
from ..kernels.registry import dispatch, resolve_impl


@dataclasses.dataclass
class LinregrResult:
    coef: torch.Tensor
    r2: torch.Tensor
    std_err: torch.Tensor
    t_stats: torch.Tensor
    p_values: torch.Tensor
    condition_no: torch.Tensor
    num_rows: torch.Tensor


class LinregrAggregate(Aggregate):
    """(init, transition, merge, final) for OLS.  ``use_kernel`` routes
    the X^T X update through the kernel registry: True = the CUDA kernel
    on the card, the plain version on the CPU; "cuda" / "ref" force one."""

    merge_ops = MERGE_SUM
    # grouped hot path: the whole segment fold as one kernel
    segment_kernel = "segment_linregr"
    cost_class = "xtx"                    # planner calibration bucket

    def __init__(self, use_kernel: bool | str = False):
        self.kernel_impl = resolve_impl(use_kernel)

    def cache_key(self):
        return ("linregr", self.kernel_impl)

    def segment_kernel_args(self, columns, valid, block_gids, num_groups):
        return ((columns["x"], columns["y"], valid, block_gids),
                {"num_groups": num_groups})

    def init(self, block):
        x = block["x"]
        d = x.shape[-1]

        def zeros(*shape, dtype=x.dtype):
            return torch.zeros(shape, dtype=dtype, device=x.device)

        return {"xtx": zeros(d, d), "xty": zeros(d), "y_sum": zeros(),
                "y_sq": zeros(), "n": zeros(dtype=torch.float32)}

    def transition(self, state, block, mask):
        x = block["x"] * mask[:, None].to(block["x"].dtype)
        y = block["y"] * mask.to(block["y"].dtype)
        if self.kernel_impl is not None:
            xtx, xty = dispatch("xtx", x, y, impl=self.kernel_impl)
        else:
            # the paper's v0.3 lesson: one rank-B update (k,B)@(B,k)
            xtx = x.T @ x
            xty = x.T @ y
        return {
            "xtx": state["xtx"] + xtx,
            "xty": state["xty"] + xty,
            "y_sum": state["y_sum"] + torch.sum(y),
            "y_sq": state["y_sq"] + torch.sum(y * y),
            "n": state["n"] + torch.sum(mask.to(torch.float32)),
        }

    def final(self, s):
        """Solve and summarise; every field may carry a leading group
        axis."""
        xtx, xty, n = s["xtx"], s["xty"], s["n"]
        d = xtx.shape[-1]
        # SymmetricPositiveDefiniteEigenDecomposition + pseudo-inverse
        # (Listing 2), via eigh.
        w, v = torch.linalg.eigh(xtx)
        wmax = w.abs().amax(dim=-1, keepdim=True)
        eps = torch.finfo(xtx.dtype).eps * d * wmax
        inv_w = torch.where(w > eps, 1.0 / w, torch.zeros_like(w))
        pinv = (v * inv_w[..., None, :]) @ v.mT
        coef = (pinv @ xty[..., None])[..., 0]
        cond = wmax[..., 0] / torch.clamp(w.abs().amin(dim=-1), min=1e-30)

        def dot(a, b):
            return (a * b).sum(dim=-1)

        sse = s["y_sq"] - 2.0 * dot(coef, xty) \
            + dot(coef, (xtx @ coef[..., None])[..., 0])
        tss = s["y_sq"] - (s["y_sum"] ** 2) / n
        r2 = 1.0 - sse / torch.clamp(tss, min=1e-30)
        dof = torch.clamp(n - d, min=1.0)
        sigma2 = sse / dof
        diag = torch.diagonal(pinv, dim1=-2, dim2=-1)
        std_err = torch.sqrt(torch.clamp(diag * sigma2[..., None], min=0.0))
        t = coef / torch.clamp(std_err, min=1e-30)
        p = 2.0 * (1.0 - torch.special.ndtr(t.abs()))
        return LinregrResult(coef, r2, std_err, t, p, cond, n)

    def final_grouped(self, states):
        return self.final(states)


class LinregrTask(IterativeTask):
    """OLS as a degenerate (single-pass, counted) executor task — which is
    exactly what buys it ``GROUP BY`` fitting via ``fit_grouped``: one
    transition per group and round on the segment layout, through
    ``xtx`` with ``use_kernel``."""

    def __init__(self, use_kernel: bool | str = False):
        self.use_kernel = use_kernel

    def init_state(self, columns):
        return torch.zeros(())  # stateless: everything lives in the pass

    def make_aggregate(self, state):
        return LinregrAggregate(use_kernel=self.use_kernel)

    def update(self, state, out):
        return state

    def finalize(self, state, out):
        return out


def linregr(table: Table, *, x_col: str = "x", y_col: str = "y",
            block_size: int | None = None, use_kernel: bool | str = False
            ) -> LinregrResult:
    """``SELECT (linregr(y, x)).* FROM data`` — one ``ScanAgg``
    statement through the planner."""
    return execute(ScanAgg(LinregrAggregate(use_kernel), table,
                           columns={"x": x_col, "y": y_col},
                           block_size=block_size, label="linregr"))


def linregr_grouped(table: Table, key_col: str,
                    num_groups: int | None = None, *, x_col: str = "x",
                    y_col: str = "y", block_size: int | None = None,
                    use_kernel: bool | str = False, mesh=None
                    ) -> LinregrResult:
    """``SELECT g, (linregr(y, x)).* FROM data GROUP BY g`` — one model
    per group in a shared scan; every result field has a leading group
    axis.  The partitioning sort is shared through the group_by memo.
    ``mesh`` (the table's when None) runs the scan on the sharded grouped
    engine."""
    return execute(GroupedScanAgg(
        LinregrAggregate(use_kernel), table, key_col, num_groups,
        columns={"x": x_col, "y": y_col}, block_size=block_size,
        mesh=mesh, label="linregr_grouped"))


def linregr_joined(fact: Table, dim: Table, *, fact_key: str,
                   dim_key: str, attr_col: str,
                   on_missing: str = "error",
                   num_groups: int | None = None, x_col: str = "x",
                   y_col: str = "y", block_size: int | None = None,
                   use_kernel: bool | str = False, mesh=None
                   ) -> LinregrResult:
    """``SELECT dim.attr, (linregr(y, x)).* FROM fact JOIN dim ON
    fact.fk = dim.key GROUP BY dim.attr`` — one model per dimension
    attribute, as ONE joined-grouped statement: the join resolves on the
    device against the memoized dimension key sort (the dimension's
    columns are never gathered onto fact rows) and the scan runs on the
    grouped core, through ``segment_linregr`` with ``use_kernel``.
    ``mesh`` (the fact table's when None) runs it sharded."""
    return execute(JoinedGroupedScanAgg(
        LinregrAggregate(use_kernel),
        Join(fact, dim, fact_key, dim_key, attr_col,
             on_missing=on_missing),
        num_groups, columns={"x": x_col, "y": y_col},
        block_size=block_size, mesh=mesh, label="linregr_joined"))
