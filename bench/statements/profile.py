"""MADlib's ``profile``: a summary row per numeric column (count, sum,
sum of squares, min, max, mean, std) and, with ``distinct_counts``, an
FM distinct count per integer column; one statement."""

from __future__ import annotations

from harness.answers import f64, max_abs, max_rel

# None: read and reported, not compared (PERF.md: the control does not
# separate it from the program)
LIMITS = {"rows": 0.0, "min_max": 0.0, "sum": 5e-5, "sum_int": None,
          "sumsq": None, "std": None, "estimate": 0.0}


def call(table, args: dict):
    from repro_torch.methods.profile import profile
    return profile(table,
                   distinct_counts=args.get("distinct_counts", False))


def _int_columns(config: dict) -> tuple:
    return tuple(name for name, spec in config["columns"].items()
                 if spec["dtype"].startswith("int") and "width" not in spec)


def reference(blocks, config: dict, args: dict, *, tf32: bool = False):
    from reference.profile import stats
    fm = _int_columns(config) if args.get("distinct_counts", False) else ()
    return stats(blocks, tf32=tf32, fm_columns=fm)


def compare(ans, ref, args: dict) -> dict:
    if set(ans) != set(ref):
        raise ValueError(f"profile columns {sorted(ans)} != {sorted(ref)}")
    out = {"rows": 0.0, "min_max": 0.0, "sum": 0.0, "sum_int": 0.0,
           "sumsq": 0.0, "std": 0.0}
    for name, r in ref.items():
        a = ans[name]
        scale = f64(r["sumsq"]).sqrt()
        gaps = {"rows": max_abs(a["count"], r["count"]),
                "min_max": max(max_abs(a["min"], r["min"]),
                               max_abs(a["max"], r["max"])),
                # float columns; integer ones, summed in float32 by the
                # program, apart
                ("sum_int" if r["integer"] else "sum"):
                    float(((f64(a["sum"]) - f64(r["sum"]).to(
                        a["sum"].device)).abs() / scale.to(a["sum"].device)
                    ).max()),
                "sumsq": max_rel(a["sumsq"], r["sumsq"]),
                "std": max_rel(a["std"], r["std"])}
        if "approx_distinct" in r:
            gaps["estimate"] = max_abs(a["approx_distinct"],
                                       r["approx_distinct"])
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
