"""Ordinary least squares as MADlib's ``linregr`` defines it: the
normal equations summed over the rows, solved through the pseudo-inverse
of ``X^T X`` (an eigendecomposition), with R², standard errors and the
row count.

The reference sums in float64 and solves in float64.  The control
(``tf32=True``) forms ``X^T X`` and ``X^T y`` with TF32 products summed
in float32, the other sums in float32, and solves in float32.
"""

from __future__ import annotations

from typing import Iterable

import torch

from .tf32 import gram


def moments(blocks: Iterable[dict], *, tf32: bool = False) -> dict:
    """The normal equations of the rows in ``blocks`` (dicts of ``x``
    (B, K) and ``y`` (B,) float32): ``xtx``, ``xty``, ``y_sum``, ``y_sq``
    and ``n``."""
    dt = torch.float32 if tf32 else torch.float64
    acc = None
    for blk in blocks:
        x, y = blk["x"], blk["y"]
        if acc is None:
            k = x.shape[1]
            acc = {"xtx": torch.zeros((k, k), dtype=dt, device=x.device),
                   "xty": torch.zeros((k,), dtype=dt, device=x.device),
                   "y_sum": torch.zeros((), dtype=dt, device=x.device),
                   "y_sq": torch.zeros((), dtype=dt, device=x.device),
                   "n": torch.zeros((), dtype=torch.float64,
                                    device=x.device)}
        acc["xtx"].add_(gram(x, x, tf32=tf32).to(dt))
        acc["xty"].add_(gram(x, y[:, None], tf32=tf32)[:, 0].to(dt))
        acc["y_sum"].add_(y.to(dt).sum())
        acc["y_sq"].add_((y.to(dt) * y.to(dt)).sum())
        acc["n"].add_(float(y.shape[0]))
    return acc


def solve(m: dict) -> dict:
    """``coef``, ``r2``, ``std_err`` and ``num_rows`` from the moments, in
    their dtype."""
    xtx, xty = m["xtx"], m["xty"]
    dt = xtx.dtype
    n = m["n"].to(dt)
    d = xtx.shape[-1]
    w, v = torch.linalg.eigh(xtx)
    wmax = w.abs().amax(dim=-1, keepdim=True)
    cut = torch.finfo(dt).eps * d * wmax
    inv_w = torch.where(w > cut, 1.0 / w, torch.zeros_like(w))
    pinv = (v * inv_w[..., None, :]) @ v.mT
    coef = (pinv @ xty[..., None])[..., 0]
    fitted = (coef * xty).sum(-1)
    quad = (coef * (xtx @ coef[..., None])[..., 0]).sum(-1)
    sse = m["y_sq"] - 2.0 * fitted + quad
    tss = m["y_sq"] - m["y_sum"] ** 2 / n
    r2 = 1.0 - sse / tss
    sigma2 = sse / torch.clamp(n - d, min=1.0)
    std_err = torch.sqrt(torch.clamp(
        torch.diagonal(pinv, dim1=-2, dim2=-1) * sigma2[..., None], min=0))
    return {"coef": coef, "r2": r2, "std_err": std_err, "num_rows": m["n"]}
