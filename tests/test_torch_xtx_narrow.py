"""The narrow xtx kernel's plan (``csrc/xtx_narrow.cu``), restated here.

``csrc/xtx_narrow.cu`` is the source of truth for which thread sums which
entry over which rows; ``ops.narrow_layout`` and ``ops.narrow_splits``
give its CTA and its row splits.  The tests below restate the kernel's
work division (the register triangle, or the micro-tiles of each row
group with y on the diagonal tiles), check that it writes every entry
(a, b), a <= b <= K, a < K, exactly once, that the splits cover every row
once with no f32 chain over 8,192 rows, and emulate the whole plan in
numpy f32 (chains in the kernel's row order, the kernel's trees, the
reduce's lanes and butterfly) against the plain version and the JAX
package's oracle, bit for bit on dyadic data.  On dyadic data every
order of summation is exact, so the emulation checks which rows and
entries the plan adds (coverage and routing), not the order it adds
them in: only the card tests hold the kernel's order.  ``ops.xtx_xty``
routes K <= ``K_NARROW`` to this kernel and wider K to the wide one.

The kernel itself runs only on the card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from repro.kernels.xtx import ref as jxtx_ref
from repro_torch.kernels.xtx import ops as xtx_ops, ref as xtx_ref
from strategies import Draw

K_NARROW = xtx_ops.K_NARROW


def _micro_of(i: int, c: int) -> tuple[int, int]:
    """Micro-tile i of the c x c block triangle, row major (the kernel's
    while loop)."""
    a = 0
    while i >= c - a:
        i -= c - a
        a += 1
    return a, a + i


def _thread_entries(k: int, lay: dict, i: int) -> list[tuple[int, int]]:
    """The entries (a, b) of a partial that thread i of group 0 writes:
    the whole triangle of [x | y] for the register triangle; for a
    micro-tile its 8 x 8 block of x's columns on or above the diagonal,
    and, on a diagonal tile, its 8 columns times y (column K)."""
    w = k + 1
    if lay["kind"] == "triangle":
        return [(a, b) for a in range(w) for b in range(a, w)]
    a, b = _micro_of(i, lay["blocks"])
    out = []
    for u in range(8):
        ga = 8 * a + u
        if ga >= k:
            continue
        if a == b:
            out.append((ga, k))
        out += [(ga, 8 * b + v) for v in range(8)
                if 8 * b + v < k and ga <= 8 * b + v]
    return out


def _chain_rows(k: int, rows_per_split: int) -> int:
    """The most rows one f32 accumulation chain of the kernel runs over:
    one group's rows of each chunk of a split."""
    lay = xtx_ops.narrow_layout(k)
    r = lay["rows_per_chunk"]
    return -(-rows_per_split // r) * (r // lay["groups"])


def _written(k: int) -> dict:
    lay = xtx_ops.narrow_layout(k)
    seen = {}
    for i in range(lay["micro"]):
        for e in _thread_entries(k, lay, i):
            seen[e] = seen.get(e, 0) + 1
    return seen


@pytest.mark.parametrize("k", range(1, K_NARROW + 1))
def test_narrow_plan_writes_each_entry_once(k):
    """For every K from 1 to K_NARROW, a group's threads (the register
    triangle, or one micro-tile each) hold each entry (a, b), a <= b <= K,
    exactly once; the reduce reads those with a < K.  The CTA fits: at
    most 256 threads, a whole number of rows per group a chunk, a stage
    ring and a fold scratch within the kernel's shared memory, an odd
    pitch for the triangle's scalar reads, a 16-byte one for the
    micro-tiles' float4 reads."""
    lay = xtx_ops.narrow_layout(k)
    w = k + 1
    seen = _written(k)
    want = {(a, b) for a in range(w) for b in range(a, w) if a < k}
    assert want <= set(seen) and all(seen[e] == 1 for e in want)
    assert set(seen) - want <= {(k, k)}          # y . y, never read
    assert lay["threads"] == lay["groups"] * lay["micro"] <= 256
    assert lay["rows_per_chunk"] % lay["groups"] == 0
    if lay["kind"] == "triangle":
        assert w <= 16 and lay["pitch"] % 2 == 1 and lay["pitch"] >= w
        assert 4 * lay["rows_per_chunk"] * lay["pitch"] * 4 <= 227 * 1024
    else:
        c = lay["blocks"]
        assert w > 16 and c == -(-k // 8) and lay["micro"] == c * (c + 1) // 2
        assert lay["pitch"] % 4 == 0 and lay["pitch"] >= 8 * c
        assert 3 * lay["rows_per_chunk"] * (lay["pitch"] + 1) <= 28672
        assert lay["groups"] // 2 * lay["micro"] * 72 <= 28672
        assert lay["rows_per_chunk"] // lay["groups"] in (4, 8, 16)


def test_narrow_layout_at_the_measured_widths():
    """K = 8 and 10 hold the triangle in registers (45 and 66 entries),
    two rows a thread a chunk; K = 80 takes 55 micro-tiles (10 blocks: a
    K divisible by 8 needs no block for y) in 4 row groups."""
    assert xtx_ops.narrow_layout(8) == {
        "kind": "triangle", "threads": 256, "groups": 256, "micro": 1,
        "blocks": 1, "rows_per_chunk": 512, "pitch": 9}
    assert xtx_ops.narrow_layout(10)["pitch"] == 11
    assert xtx_ops.narrow_layout(1)["rows_per_chunk"] == 2048
    lay = xtx_ops.narrow_layout(80)
    assert (lay["kind"], lay["blocks"], lay["micro"], lay["groups"],
            lay["threads"], lay["rows_per_chunk"]) == (
                "micro", 10, 55, 4, 220, 64)
    assert xtx_ops.narrow_layout(16)["micro"] == 3
    with pytest.raises(ValueError, match="too wide"):
        xtx_ops.narrow_layout(200)


@pytest.mark.parametrize("sms,ctas", [(1, 1), (2, 3), (132, 1), (132, 3)])
@pytest.mark.parametrize("k", [1, 3, 8, 15, 16, 40, 80, K_NARROW])
def test_narrow_splits_cover_every_row_once(k, sms, ctas):
    """Whole chunks a split, every row in exactly one split, whole waves
    of CTAs where the rows allow, and no f32 chain (one group's rows of a
    split) over 8,192 rows."""
    lay = xtx_ops.narrow_layout(k)
    r, per_group = lay["rows_per_chunk"], lay["rows_per_chunk"] // lay["groups"]
    wave = sms * ctas
    for n in [0, 1, 31, r - 1, r, r + 1, 4097, 100_003, 10_000_000,
              123_456_789]:
        splits, rows = xtx_ops.narrow_splits(n, k, sms, ctas)
        assert rows % r == 0 and splits >= 1
        assert (splits - 1) * rows < max(n, 1) <= splits * rows
        assert _chain_rows(k, rows) <= 8192
        # no more splits than the whole waves the chain cap asks for
        fewest = -(-(-(-max(n, 1) // r)) // (8192 // per_group))
        assert splits <= -(-fewest // wave) * wave


def test_narrow_splits_at_the_main_shapes():
    """10^7 rows on 132 SMs: at K = 8 three CTAs an SM give 391 splits of
    50 chunks of 512 rows (a chain of 100 rows); at K = 80 one wave of
    two CTAs an SM would make a group's chain 9,472 rows, so two waves
    give 528 splits of 296 chunks of 64 rows (a chain of 4,736 rows)."""
    assert xtx_ops.narrow_splits(10_000_000, 8, 132, 3) == (391, 25_600)
    assert _chain_rows(8, 25_600) == 100
    assert xtx_ops.narrow_splits(10_000_000, 80, 132, 2) == (528, 18_944)
    assert _chain_rows(80, 18_944) == 4_736


def _group_rows(lay: dict, r0: int, r1: int) -> list[np.ndarray]:
    """Each row group's rows of the split [r0, r1), in the order its f32
    chains add them: chunk by chunk; within a chunk thread t of the
    triangle takes t, t + 256, ...; group g of the micro-tiles g,
    g + groups, ..."""
    g_n, r = lay["groups"], lay["rows_per_chunk"]
    out = [[] for _ in range(g_n)]
    for c0 in range(r0, r1, r):
        for g in range(g_n):
            rows = c0 + np.arange(g, r, g_n)
            out[g].append(rows[rows < r1])
    return [np.concatenate(rs) if rs else np.zeros(0, np.int64)
            for rs in out]


def _emulate_narrow(x: np.ndarray, y: np.ndarray, sms: int, ctas: int):
    """The narrow kernel's plan in numpy f32: per split, each group's
    chain over its rows in order (an exact product and one rounding per
    row on dyadic data, where the kernel's FMA rounds once), the groups
    added as the kernel adds them (a butterfly over each warp's 32
    threads, then the 8 warps as a tree; or the fold of the upper half
    of the groups onto the lower), then per entry the reduce's 32 lanes
    (lane i the splits i, i + 32, ...) and their butterfly, mirrored."""
    n, k = x.shape
    w = k + 1
    lay = xtx_ops.narrow_layout(k)
    aug = np.concatenate([x, y[:, None]], axis=1).astype(np.float32)
    splits, rows_per = xtx_ops.narrow_splits(n, k, sms, ctas)
    parts = np.zeros((splits, w, w), np.float32)
    for s in range(splits):
        r0, r1 = s * rows_per, min((s + 1) * rows_per, n)
        groups = _group_rows(lay, r0, r1)
        acc = np.zeros((len(groups), w, w), np.float32)
        for step in range(max(len(g) for g in groups)):
            live = [i for i, g in enumerate(groups) if step < len(g)]
            v = aug[[groups[i][step] for i in live]]
            acc[live] = acc[live] + v[:, :, None] * v[:, None, :]
        if lay["kind"] == "triangle":
            acc = acc.reshape(8, 32, w, w)
            for off in (16, 8, 4, 2, 1):
                acc = acc + acc[:, np.arange(32) ^ off]
            p = acc[:, 0]
            tot = ((p[0] + p[1]) + (p[2] + p[3])) + \
                ((p[4] + p[5]) + (p[6] + p[7]))
        else:
            live = len(groups)
            while live > 1:
                half = (live + 1) // 2
                acc[:live - half] = acc[:live - half] + acc[half:live]
                live = half
            tot = acc[0]
        parts[s] = np.triu(tot)
    lanes = np.zeros((32, w, w), np.float32)
    for s in range(splits):
        lanes[s % 32] = lanes[s % 32] + parts[s]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    total = lanes[0]
    full = np.triu(total) + np.triu(total, 1).T
    return full[:k, :k], full[:k, k]


@pytest.mark.parametrize("sms,ctas", [(1, 1), (2, 2)])
@pytest.mark.parametrize("n,k", [(1, 1), (3000, 1), (2100, 3), (1500, 8),
                                 (700, 10), (600, 15), (900, 16), (500, 17),
                                 (400, 40), (300, 63), (200, 80)])
def test_narrow_plan_matches_jax_on_dyadic_data(n, k, sms, ctas):
    """The narrow kernel's plan (splits, groups' chains, trees, ordered
    reduce, mirrored triangle) gives the plain version's and the JAX
    oracle's bits on dyadic data, and a bitwise symmetric X^T X.  Every
    summation order is exact on dyadic data, so this holds the plan's
    coverage and routing of rows and entries, not its order."""
    draw = Draw(n * 131 + k)
    x, y = draw.dyadic((n, k)), draw.dyadic((n,))
    got_xtx, got_xty = _emulate_narrow(x, y, sms, ctas)
    want_xtx, want_xty = jxtx_ref.xtx_xty_ref(x, y)
    plain_xtx, plain_xty = xtx_ref.xtx_xty_ref(torch.from_numpy(x),
                                              torch.from_numpy(y))
    np.testing.assert_array_equal(got_xtx, np.asarray(want_xtx))
    np.testing.assert_array_equal(got_xty, np.asarray(want_xty))
    np.testing.assert_array_equal(got_xtx, plain_xtx.numpy())
    np.testing.assert_array_equal(got_xty, plain_xty.numpy())
    np.testing.assert_array_equal(got_xtx, got_xtx.T)


def test_xtx_routes_narrow_widths_to_the_narrow_kernel(monkeypatch):
    """On the card, K <= K_NARROW launches the narrow kernel and wider K
    the wide one; xtx_launches counts both, xtx_narrow_launches the
    narrow ones (the launch itself replaced here: there is no card)."""
    paths = []

    def launch(x, y, narrow):
        paths.append(narrow)
        k = x.shape[1]
        return torch.zeros((k, k)), torch.zeros((k,))

    monkeypatch.setattr(xtx_ops, "kernel_route", lambda t, what: "cuda")
    monkeypatch.setattr(xtx_ops, "_launch", launch)
    monkeypatch.setattr(xtx_ops, "xtx_launches", 0)
    monkeypatch.setattr(xtx_ops, "xtx_narrow_launches", 0)
    widths = [1, 8, 80, K_NARROW, K_NARROW + 1, 160, 320]
    for k in widths:
        xtx_ops.xtx_xty(torch.zeros((5, k)), torch.zeros((5,)))
    assert paths == [k <= K_NARROW for k in widths]
    assert xtx_ops.xtx_launches == len(widths)
    assert xtx_ops.xtx_narrow_launches == sum(paths) == 4


def test_narrow_cost_is_the_wide_cost():
    """One count of the work for both paths: the bound, the dry run and
    the op counter do not depend on the path."""
    x, y = torch.zeros((10, 8)), torch.zeros((10,))
    assert xtx_ops.cost(x, y) == xtx_ops.xtx_cost(10, 8) == (
        10.0 * 8 * 11, 4.0 * (10 * 9 + 8 * 9))
