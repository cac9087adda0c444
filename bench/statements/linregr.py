"""``SELECT (linregr(y, x)).* FROM t``: MADlib's OLS over the whole
table, the statement of the paper's Fig. 4."""

from __future__ import annotations

from harness.answers import ols_gaps

# limits of the numbers that ``compare`` gives (PERF.md gives the readings
# each was set from)
LIMITS = {"rows": 0.0, "coef": 5e-3, "std_err": 1e-5, "r2": 1e-6}


def call(table, args: dict):
    from repro_torch.methods.linregr import linregr
    return linregr(table, use_kernel=args.get("use_kernel", False))


def reference(blocks, config: dict, args: dict, *, tf32: bool = False):
    from reference import ols
    return ols.solve(ols.moments(blocks, tf32=tf32))


def compare(ans, ref, args: dict) -> dict:
    return ols_gaps(ans, ref)
