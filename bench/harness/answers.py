"""Helpers the statements share to read answers and measure gaps."""

from __future__ import annotations

import torch


def field(ans, name: str):
    """``ans.name`` of a program result, or ``ans[name]`` of a reference
    dict."""
    return ans[name] if isinstance(ans, dict) else getattr(ans, name)


def f64(t) -> torch.Tensor:
    return torch.as_tensor(t).double()


def max_abs(a, b) -> float:
    """The largest absolute difference, with the reference ``b`` moved to
    ``a``'s device."""
    a = f64(a)
    return float((a - f64(b).to(a.device)).abs().max())


def max_rel(a, b) -> float:
    """The largest ``|a / b - 1|``."""
    a = f64(a)
    b = f64(b).to(a.device)
    return float(((a - b).abs() / b.abs()).max())


def ols_gaps(ans, ref) -> dict:
    """An OLS answer against the reference's: the row count's gap, the
    worst coefficient's gap in units of its reference standard error, the
    worst standard error's relative gap, and R²'s absolute gap (each
    taken over groups too, where there are groups)."""
    se = f64(field(ref, "std_err"))
    coef = f64(field(ans, "coef"))
    return {
        "rows": max_abs(field(ans, "num_rows"), field(ref, "num_rows")),
        "coef": float(((coef - f64(field(ref, "coef")).to(coef.device)).abs()
                       / se.to(coef.device)).max()),
        "std_err": max_rel(field(ans, "std_err"), se),
        "r2": max_abs(field(ans, "r2"), field(ref, "r2")),
    }
