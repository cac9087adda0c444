"""The plain reference against slow loops on tiny tables."""

from __future__ import annotations

import math
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from reference import ols, profile, sketches  # noqa: E402
from reference.sketch_hash import PRIMES  # noqa: E402
from reference.tf32 import gram, round_tf32  # noqa: E402

M32 = 0xFFFFFFFF


def _table(n=57, k=3, groups=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, k), generator=g)
    y = x @ torch.tensor([0.5, -1.0, 2.0][:k]) + torch.randn((n,), generator=g)
    return {"x": x, "y": y,
            "g": torch.randint(0, groups, (n,), generator=g,
                               dtype=torch.int32),
            "item": torch.randint(-5, 1000, (n,), generator=g,
                                  dtype=torch.int32)}


def _blocks(t, size=20):
    n = t["x"].shape[0]
    return [{k: v[i:i + size] for k, v in t.items()}
            for i in range(0, n, size)]


def _ols_loop(rows):
    k = len(rows[0][0])
    a = [[0.0] * k for _ in range(k)]
    b = [0.0] * k
    ys = yq = 0.0
    for xr, yv in rows:
        for i in range(k):
            b[i] += xr[i] * yv
            for j in range(k):
                a[i][j] += xr[i] * xr[j]
        ys += yv
        yq += yv * yv
    n = len(rows)
    coef = np.linalg.solve(np.array(a), np.array(b))
    sse = sum((yv - float(np.dot(coef, xr))) ** 2 for xr, yv in rows)
    tss = sum((yv - ys / n) ** 2 for _, yv in rows)
    se = np.sqrt(np.diag(np.linalg.inv(np.array(a))) * sse / (n - k))
    return coef, 1 - sse / tss, se, n


def test_ols_matches_a_loop():
    t = _table()
    got = ols.solve(ols.moments(_blocks(t)))
    rows = [(t["x"][i].double().tolist(), float(t["y"][i]))
            for i in range(t["x"].shape[0])]
    coef, r2, se, n = _ols_loop(rows)
    assert np.allclose(got["coef"].numpy(), coef, rtol=1e-10, atol=1e-12)
    assert math.isclose(float(got["r2"]), r2, rel_tol=1e-10)
    assert np.allclose(got["std_err"].numpy(), se, rtol=1e-9)
    assert float(got["num_rows"]) == n


def test_profile_matches_a_loop():
    t = _table()
    got = profile.stats(_blocks(t), fm_columns=("item",))
    for name, col in t.items():
        v = col.double().reshape(col.shape[0], -1)
        for j in range(v.shape[1]):
            vals = v[:, j].tolist()
            n = len(vals)
            s, sq = sum(vals), sum(a * a for a in vals)
            mean = s / n
            sd = math.sqrt(max(sq / n - mean * mean, 0.0))
            g = {k: (x.reshape(-1)[j] if torch.is_tensor(x) and x.dim()
                     else x) for k, x in got[name].items()}
            assert g["count"] == n
            assert math.isclose(float(g["sum"]), s, rel_tol=1e-12,
                                abs_tol=1e-12)
            assert math.isclose(float(g["sumsq"]), sq, rel_tol=1e-12)
            assert float(g["min"]) == min(vals)
            assert float(g["max"]) == max(vals)
            assert math.isclose(float(g["std"]), sd, rel_tol=1e-9)
    assert "approx_distinct" in got["item"]


def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _hash(item, d):
    x = item & M32
    p = PRIMES[d]
    return _fmix((x * p + p) & M32)


def test_fm_matches_a_loop():
    t = _table(n=300)
    maps = [[False] * 32 for _ in range(8)]
    for it in t["item"].tolist():
        for j in range(8):
            h = _hash(it, j)
            r = 31 if h == 0 else min((h & -h).bit_length() - 1, 31)
            maps[j][r] = True
    assert sketches.fm_bitmaps(t["item"]).tolist() == maps
    rs = [next((i for i in range(32) if not m[i]), 32) for m in maps]
    want = 2.0 ** (sum(rs) / 8) / sketches.FM_PHI
    assert math.isclose(float(sketches.fm_estimate(
        sketches.fm_bitmaps(t["item"]))), want, rel_tol=1e-6)


def _tf32_loop(v):
    b = struct.unpack("<I", struct.pack("<f", v))[0]
    low = b & 0x1FFF
    b &= ~0x1FFF & M32
    if low > 0x1000 or (low == 0x1000 and (b >> 13) & 1):
        b = (b + 0x2000) & M32
    return struct.unpack("<f", struct.pack("<I", b))[0]


@pytest.mark.parametrize("v", [1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                               1.0 + 2 ** -12, -3.14159, 1e-20, 65504.7])
def test_tf32_rounding_matches_a_loop(v):
    got = float(round_tf32(torch.tensor([v], dtype=torch.float32))[0])
    assert got == _tf32_loop(struct.unpack("<f", struct.pack("<f", v))[0])


def test_gram_reference_is_float64_and_control_is_not():
    t = _table()
    ref = gram(t["x"], t["x"], tf32=False)
    ctl = gram(t["x"], t["x"], tf32=True)
    assert ref.dtype == torch.float64 and ctl.dtype == torch.float32
    assert torch.allclose(ref, t["x"].double().T @ t["x"].double())
    assert not torch.equal(ctl.double(), ref)
