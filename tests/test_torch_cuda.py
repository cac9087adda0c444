"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips with a reason when
there is no CUDA device (decided inside the fixture, never at import).
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Inputs are dyadic draws (every partial sum exact in f32), so kernel and
plain version agree bit for bit whatever their summation order.  The
sketch kernels count in integers and agree bit for bit on any items.
The end-to-end checks at the main path's size are in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    FusedAggregate, Session, run_grouped, run_local, run_stream,
    trace_execution,
)
from repro_torch.core.plan import ScanAgg, execute
from repro_torch.core.table import Table
from repro_torch.kernels import registry
from repro_torch.configs import reduced_config
from repro_torch.kernels.countmin import ops as cm_ops, ref as cm_ref
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.kmeans_assign import ops as km_ops, ref as km_ref
from repro_torch.kernels.segment_fold import ops as sf_ops, ref as sf_ref
from repro_torch.kernels.xtx import ops as xtx_ops, ref as xtx_ref
from repro_torch.methods.kmeans import kmeans_fit
from repro_torch.methods.linregr import (
    LinregrAggregate, linregr, linregr_grouped,
)
from repro_torch.launch.serve import serve
from repro_torch.methods.sketches import (
    CountMinAggregate, FMAggregate, countmin_sketch, fm_distinct_count,
)
from repro_torch.models import model as M
from strategies import Draw, group_layout

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (none present)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k", [(1, 3), (64, 7), (257, 16), (300, 63),
                                 (100_000, 80), (4099, 130)])
def test_xtx_kernel_matches_plain(cuda_device, n, k):
    draw = Draw(n + k)
    x = torch.from_numpy(draw.dyadic((n, k))).to(cuda_device)
    y = torch.from_numpy(draw.dyadic((n,))).to(cuda_device)
    before = xtx_ops.xtx_launches
    got = xtx_ops.xtx_xty(x, y)
    want = xtx_ref.xtx_xty_ref(x, y)
    torch.cuda.synchronize()
    assert xtx_ops.xtx_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [3, 63, 64, 127, 128, 130, 160, 175, 176,
                               200, 300])
def test_xtx_upper_triangle_bitwise_and_symmetric(cuda_device, k):
    """K around the 8-column micro-tile edges and past the 176-column tile
    (several units, halves of tile pairs), on dyadic data: bitwise the
    plain version, X^T X bitwise symmetric; more than one split, so the
    ordered reduce runs."""
    n = 20_000 + k
    draw = Draw(7 * k)
    x = torch.from_numpy(draw.dyadic((n, k))).to(cuda_device)
    y = torch.from_numpy(draw.dyadic((n,))).to(cuda_device)
    got = xtx_ops.xtx_xty(x, y)
    want = xtx_ref.xtx_xty_ref(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], got[0].T)


def _dyadic_rows(n, k, seed, device):
    """x (n, k) and y (n,) in {-1/8, 0, 1/8}: every partial sum of up to
    10^7 products is a multiple of 1/64 below 2^18, exact in f32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, size=(n, k)).astype(np.float32) / 8
    y = rng.integers(-1, 2, size=(n,)).astype(np.float32) / 8
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


@pytest.mark.parametrize("n", [1, 31, 4097, 1_000_003])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 10, 15, 16, 17, 31, 33, 63, 64,
                               79, 80, xtx_ops.K_NARROW + 1])
def test_xtx_narrow_bitwise_and_symmetric(cuda_device, k, n):
    """Around the register triangle's edge (K = 15, 16), the micro-tiles'
    8-column edges and one past K_NARROW (the wide kernel): bitwise the
    plain version on dyadic data, X^T X bitwise symmetric, one launch on
    the path K chooses."""
    x, y = _dyadic_rows(n, k, 1000 * k + n % 1000, cuda_device)
    before = (xtx_ops.xtx_launches, xtx_ops.xtx_narrow_launches)
    got = xtx_ops.xtx_xty(x, y)
    want = xtx_ref.xtx_xty_ref(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], got[0].T)
    narrow = int(k <= xtx_ops.K_NARROW)
    assert (xtx_ops.xtx_launches, xtx_ops.xtx_narrow_launches) == (
        before[0] + 1, before[1] + narrow)


@pytest.mark.parametrize("k", [1, 10, 16, 64])
def test_xtx_narrow_on_a_view_off_16_bytes(cuda_device, k):
    """A view whose data_ptr is 4 bytes off 16 (as a segment view starts):
    4-byte copies for x, bitwise the plain version; K = 16 and 64 would
    take 16-byte copies from an aligned base."""
    n = 50_001
    flat, y = _dyadic_rows(n * k + 1, 1, k, cuda_device)
    x = flat[1:, 0].view(n, k)
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    y = y[:n]
    got = xtx_ops.xtx_xty(x, y)
    want = xtx_ref.xtx_xty_ref(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], got[0].T)


def test_xtx_narrow_widths_in_any_order(cuda_device):
    """K = 50 and 64 share one micro-tile kernel but need 105,408 and
    92,736 bytes of shared memory, and K = 128 down the narrow path (as
    chip_smoke.py's section k runs it) 25,536: a call after any other
    width still launches and gives the plain version's bits."""
    n = 100_003
    data = {k: _dyadic_rows(n, k, 7 * k, cuda_device)
            for k in (50, 64, 128)}
    want = {k: xtx_ref.xtx_xty_ref(*data[k]) for k in data}
    for k, narrow in ((50, None), (64, None), (50, None), (64, None),
                      (128, True), (64, None)):
        got = (xtx_ops.xtx_xty(*data[k]) if narrow is None
               else xtx_ops._launch(*data[k], narrow))
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[k][0]), k
        assert torch.equal(got[1], want[k][1]), k


def test_xtx_narrow_on_two_streams(cuda_device):
    """Calls alternating between two streams, each repeated, share no
    scratch: all give the plain version's bits."""
    x, y = _dyadic_rows(3_000_001, 1, 8, cuda_device)
    want = xtx_ref.xtx_xty_ref(x, y)
    side = torch.cuda.Stream()
    outs = []
    for i in range(6):
        with torch.cuda.stream(side if i % 2 else
                               torch.cuda.current_stream()):
            outs.append(xtx_ops.xtx_xty(x, y))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_linregr_counts_its_narrow_launches(cuda_device):
    """The main path's OLS at a narrow width goes through the narrow
    kernel: one launch, counted on both counters."""
    x, y = _dyadic_rows(20_000, 8, 5, cuda_device)
    t = Table({"x": x, "y": y})
    xtx_ops.xtx_launches = xtx_ops.xtx_narrow_launches = 0
    linregr(t, use_kernel=True)
    assert (xtx_ops.xtx_launches, xtx_ops.xtx_narrow_launches) == (1, 1)
    x, y = _dyadic_rows(20_000, xtx_ops.K_NARROW + 1, 6, cuda_device)
    linregr(Table({"x": x, "y": y}), use_kernel=True)
    assert (xtx_ops.xtx_launches, xtx_ops.xtx_narrow_launches) == (2, 1)


@pytest.mark.parametrize("pattern,pad_to", [("uniform", None),
                                            ("skewed", 7), ("empty", 3),
                                            ("singleton", None)])
def test_segment_linregr_kernel_matches_plain(cuda_device, pattern, pad_to):
    draw = Draw(sum(map(ord, pattern)))
    G, n = 6, 5000
    gids, _ = group_layout(draw, n, G, pattern)
    t = Table.from_columns({"x": draw.dyadic((n, 7)),
                            "y": draw.dyadic((n,)), "g": gids},
                           device=cuda_device)
    cols, valid, bgids = t.group_by("g", G).aligned_blocks(
        64, pad_blocks_to=pad_to)
    args = (cols["x"], cols["y"], valid, bgids)
    before = sf_ops.segment_linregr_launches
    got = sf_ops.segment_linregr(*args, num_groups=G)
    want = sf_ref.segment_linregr_ref(*args, num_groups=G)
    torch.cuda.synchronize()
    assert sf_ops.segment_linregr_launches == before + 1
    assert all(torch.equal(got[q], want[q]) for q in want)


@pytest.mark.parametrize("block", [64, 4096, 9000])
@pytest.mark.parametrize("k", [1, 7, 160, 174, 175, 300])
def test_segment_linregr_upper_triangle_bitwise_and_symmetric(cuda_device, k,
                                                              block):
    """A = [x m | y m | m] below, at and past one 176-column tile (w = 162,
    176, 177 and 302: tile pairs and their halves), blocks of one row split
    (64, 4096) and of two (9000 > 8192 rows), a ragged base mask, empty
    groups and sentinel blocks: bitwise the plain version on dyadic data,
    every group's x^T x bitwise symmetric, the empty groups zero."""
    draw = Draw(31 * k + block)
    G, n = 6, 20_000
    gids, _ = group_layout(draw, n, G, "empty")
    t = Table.from_columns({"x": draw.dyadic((n, k)), "y": draw.dyadic((n,)),
                            "g": gids}, device=cuda_device)
    mask = torch.from_numpy(draw.bools((n,), p=0.8)).to(cuda_device)
    view = t.group_by("g", G)
    cols, valid, bgids = view.aligned_blocks(block, view.permute(mask),
                                             pad_blocks_to=7)
    args = (cols["x"], cols["y"], valid, bgids)
    got = sf_ops.segment_linregr(*args, num_groups=G)
    want = sf_ref.segment_linregr_ref(*args, num_groups=G)
    torch.cuda.synchronize()
    assert all(torch.equal(got[q], want[q]) for q in want)
    assert torch.equal(got["xtx"], got["xtx"].transpose(1, 2))
    empty = torch.bincount(torch.from_numpy(gids).long(), minlength=G) == 0
    assert bool(empty.any())
    assert all(float(got[q][empty.to(cuda_device)].abs().sum()) == 0.0
               for q in got)


def test_main_path_goes_through_the_kernels(cuda_device):
    draw = Draw(3)
    n = 20_000
    gids, _ = group_layout(draw, n, 8, "skewed")
    cols = {"x": draw.dyadic((n, 12)), "y": draw.dyadic((n,)), "g": gids}
    t = Table.from_columns(cols, device=cuda_device)
    cpu = Table.from_columns(cols, device="cpu")
    xtx_ops.xtx_launches = sf_ops.segment_linregr_launches = 0
    with trace_execution() as tr:
        solo = linregr(t, use_kernel=True)
        grouped = linregr_grouped(t, "g", num_groups=8, use_kernel=True)
    assert xtx_ops.xtx_launches == 1
    assert sf_ops.segment_linregr_launches == 1
    assert [e.engine for e in tr.kernels] == ["cuda", "cuda"]
    torch.testing.assert_close(solo.coef.cpu(), linregr(cpu).coef,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        grouped.coef.cpu(), linregr_grouped(cpu, "g", num_groups=8).coef,
        rtol=1e-4, atol=1e-4)


def test_forced_cuda_and_auto_agree_on_card(cuda_device):
    draw = Draw(9)
    x = torch.from_numpy(draw.dyadic((512, 5))).to(cuda_device)
    y = torch.from_numpy(draw.dyadic((512,))).to(cuda_device)
    with trace_execution() as tr:
        a = registry.dispatch("xtx", x, y, impl="auto")
        b = registry.dispatch("xtx", x, y, impl="cuda")
        c = registry.dispatch("xtx", x, y, impl="ref")
    assert [e.engine for e in tr.kernels] == ["cuda", "cuda", "ref"]
    assert all(torch.equal(p, q) and torch.equal(p, r)
               for p, q, r in zip(a, b, c))


def _items(draw, n):
    items = draw.ints((n,), -2 ** 31, 2 ** 31 - 1)
    items[: n // 2] %= 101                     # hot keys
    return items


# (depth, width) up to 8 x 16384: 512 KB of counters, the global path
# (8 x 8192, 256 KB, is the first shape past the opt-in shared memory);
# n around the kernel's 4-row chunks and 16 KB ranges, and the main path's
# 10M rows; width 1000 takes the division path
@pytest.mark.parametrize("n,depth,width", [(1, 1, 1), (4096, 4, 1024),
                                           (100_000, 8, 4096),
                                           (30_000, 8, 16384),
                                           (5000, 3, 1000),
                                           (3, 4, 1024), (4095, 4, 1024),
                                           (4097, 4, 1024),
                                           (50_000, 8, 8192),
                                           (200_003, 4, 1000),
                                           (10_000_000, 4, 1024)])
def test_countmin_kernel_matches_plain(cuda_device, n, depth, width):
    draw = Draw(n + depth)
    items = torch.from_numpy(_items(draw, n)).to(cuda_device)
    mask = torch.from_numpy(draw.bools((n,), p=0.8)).to(cuda_device)
    before = cm_ops.countmin_launches
    got = cm_ops.countmin_block(items, mask, depth, width)
    want = cm_ref.countmin_block_ref(items, mask, depth, width)
    torch.cuda.synchronize()
    assert cm_ops.countmin_launches == before + 1
    assert torch.equal(got, want)
    assert int(got.sum()) == depth * int(mask.sum())


# contiguous views that start 4 or 12 bytes into the items (the kernel's
# scalar head before its 16-byte loads), with the mask at the same offset
# (4-byte mask loads after the head) or another (byte loads)
@pytest.mark.parametrize("item_off,mask_off", [(1, 1), (3, 3), (1, 0),
                                               (2, 3)])
@pytest.mark.parametrize("depth,width", [(4, 1024), (8, 8192), (3, 1000)])
def test_countmin_kernel_on_misaligned_views(cuda_device, item_off,
                                             mask_off, depth, width):
    n = 300_001
    draw = Draw(item_off * 10 + mask_off)
    items = torch.from_numpy(_items(draw, n + 4)).to(cuda_device)
    mask = torch.from_numpy(draw.bools((n + 4,), p=0.8)).to(cuda_device)
    items, mask = items[item_off:item_off + n], mask[mask_off:mask_off + n]
    assert items.is_contiguous() and items.data_ptr() % 16 != 0
    got = cm_ops.countmin_block(items, mask, depth, width)
    want = cm_ref.countmin_block_ref(items, mask, depth, width)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,depth,width", [(1_000_000, 4, 1024),
                                           (100_000, 8, 8192),
                                           (100_000, 3, 1000)])
def test_countmin_kernel_hot_key(cuda_device, n, depth, width):
    """Every row the same item: every atomic of a warp hits one counter."""
    items = torch.full((n,), -123457, dtype=torch.int32, device=cuda_device)
    mask = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    mask[::7] = False
    got = cm_ops.countmin_block(items, mask, depth, width)
    want = cm_ref.countmin_block_ref(items, mask, depth, width)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got.max()) == int(mask.sum())


def _sketch_layout(cuda_device, pattern, pad_to, n=20_000, G=6, bs=64):
    draw = Draw(sum(map(ord, pattern)) + 1)
    gids, _ = group_layout(draw, n, G, pattern)
    t = Table.from_columns({"item": _items(draw, n), "g": gids},
                           device=cuda_device)
    view = t.group_by("g", G)
    base = view.permute(torch.from_numpy(draw.bools((n,), p=0.9)))
    cols, valid, bgids = view.aligned_blocks(bs, base, pad_blocks_to=pad_to)
    return cols["item"], valid, bgids


@pytest.mark.parametrize("pattern,pad_to", [("uniform", None),
                                            ("skewed", 7), ("empty", 3),
                                            ("singleton", None)])
def test_segment_sketch_kernels_match_plain(cuda_device, pattern, pad_to):
    items, valid, bgids = _sketch_layout(cuda_device, pattern, pad_to)
    G = 6
    cases = [(sf_ops.segment_countmin, sf_ref.segment_countmin_ref,
              "segment_countmin_launches", {"depth": 4, "width": 1024}),
             (sf_ops.segment_countmin, sf_ref.segment_countmin_ref,
              "segment_countmin_launches", {"depth": 8, "width": 16384}),
             (sf_ops.segment_countmin, sf_ref.segment_countmin_ref,
              "segment_countmin_launches", {"depth": 3, "width": 1000})]
    cases += [(sf_ops.segment_fm, sf_ref.segment_fm_ref,
               "segment_fm_launches", {"num_hashes": h, "bits": b})
              for h, b in ((8, 16), (8, 32), (5, 40), (1, 1))]
    for kern, plain, counter, kw in cases:
        before = getattr(sf_ops, counter)
        got = kern(items, valid, bgids, num_groups=G, **kw)
        want = plain(items, valid, bgids, num_groups=G, **kw)
        torch.cuda.synchronize()
        assert getattr(sf_ops, counter) == before + 1
        assert torch.equal(got, want), (kern.__name__, kw)
    if pattern == "empty":  # ids [4, 6) never occur
        assert int(got[4:].abs().sum()) == 0


@pytest.mark.parametrize("order", ["aligned", "shuffled"])
def test_segment_countmin_runs_across_cta_ranges(cuda_device, order):
    """Groups whose runs of blocks straddle the kernel's CTA ranges, 8
    empty groups and 5 sentinel blocks; shuffled, a group's blocks are no
    longer adjacent and each is flushed on its own."""
    G, bs, n = 64, 256, 600_000
    draw = Draw(29 + len(order))
    t = Table.from_columns({"item": _items(draw, n),
                            "g": draw.ints((n,), 0, G - 9)},
                           device=cuda_device)
    view = t.group_by("g", G)
    base = view.permute(torch.from_numpy(draw.bools((n,), p=0.9)))
    real = int((-(-view.counts.long() // bs)).sum())
    cols, valid, bgids = view.aligned_blocks(bs, base,
                                             pad_blocks_to=real + 5)
    items = cols["item"]
    nb = bgids.shape[0]
    assert int((bgids == G).sum()) == 5
    if order == "shuffled":
        perm = torch.from_numpy(draw.permutation(nb)).to(cuda_device)
        items = items.view(nb, bs)[perm].reshape(-1)
        valid = valid.view(nb, bs)[perm].reshape(-1)
        bgids = bgids[perm].contiguous()
    per = sf_ops.cta_blocks(nb, cm_ops.sm_count(cuda_device.index or 0))
    edges = torch.arange(per, nb, per, device=cuda_device)
    straddle = int((bgids[edges] == bgids[edges - 1]).sum())
    if order == "aligned":
        assert per > 1 and straddle > 0
    for depth, width in ((4, 1024), (8, 8192), (3, 1000)):
        kw = {"depth": depth, "width": width, "num_groups": G}
        got = sf_ops.segment_countmin(items, valid, bgids, **kw)
        want = sf_ref.segment_countmin_ref(items, valid, bgids, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (order, depth, width)
        assert int(got[G - 8:].abs().sum()) == 0


def test_session_batch_goes_through_countmin_and_xtx(cuda_device):
    draw = Draw(17)
    n = 30_000
    cols = {"x": draw.dyadic((n, 6)), "y": draw.dyadic((n,)),
            "g": draw.ints((n,), 0, 7), "item": _items(draw, n)}
    t = Table.from_columns(cols, device=cuda_device)
    cpu = Table.from_columns(cols, device="cpu")
    xtx_ops.xtx_launches = cm_ops.countmin_launches = 0
    sess = Session()
    stats = sess.profile(t, distinct_counts=True)
    ols = sess.linregr(t, use_kernel=True)
    cm = sess.scan(CountMinAggregate(use_kernel=True), t, columns=("item",),
                   label="countmin")
    fm = sess.fm_distinct_count(t)
    with trace_execution() as tr:
        sess.run()
    assert len(tr.scans) == 1
    assert (xtx_ops.xtx_launches, cm_ops.countmin_launches) == (1, 1)
    # profile: one column_stats a numeric column (x, y, g, item)
    assert sorted((e.detail["name"], e.engine) for e in tr.kernels) == [
        *[("column_stats", "cuda")] * 4, ("countmin", "cuda"),
        ("xtx", "cuda")]
    assert torch.equal(cm.result().cpu(), countmin_sketch(cpu))
    # FM estimates go through a float pow that the card and the CPU may
    # round 1 ulp apart; the states themselves are integers
    torch.testing.assert_close(fm.result().cpu(), fm_distinct_count(cpu),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(ols.result().coef.cpu(),
                               linregr(cpu).coef, rtol=1e-4, atol=1e-4)
    assert float(stats.result()["item"]["count"]) == n


def test_grouped_sketches_go_through_the_segment_kernels(cuda_device):
    draw = Draw(19)
    n = 50_000
    gids, _ = group_layout(draw, n, 8, "skewed")
    t = Table.from_columns({"item": _items(draw, n), "g": gids},
                           device=cuda_device)
    for agg, counter in ((CountMinAggregate, "segment_countmin_launches"),
                         (FMAggregate, "segment_fm_launches")):
        setattr(sf_ops, counter, 0)
        with trace_execution() as tr:
            got = run_grouped(agg(use_kernel=True), t, "g", 8,
                              finalize=False)
        assert getattr(sf_ops, counter) == 1
        assert [e.engine for e in tr.kernels] == ["cuda"]
        want = run_grouped(agg(use_kernel="ref"), t, "g", 8, finalize=False)
        assert torch.equal(got, want)


@pytest.mark.parametrize("block_size,launches", [(None, 1), (4096, 5)])
def test_countmin_launches_show_the_blocking(cuda_device, block_size,
                                             launches):
    """No block size: one countmin call over every row; a block size: one
    call per block (20,000 rows in blocks of 4,096 make 5)."""
    draw = Draw(23)
    cols = {"item": _items(draw, 20_000)}
    t = Table.from_columns(cols, device=cuda_device)
    cm_ops.countmin_launches = 0
    got = execute(ScanAgg(CountMinAggregate(use_kernel=True), t,
                          block_size=block_size))
    assert cm_ops.countmin_launches == launches
    want = countmin_sketch(Table.from_columns(cols, device="cpu"),
                           block_size=block_size)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# kmeans_assign and the fits that run it.
# ---------------------------------------------------------------------------

def _km_inputs(draw, n, d, k, cuda_device, dup=False):
    """Dyadic rows and centroids (every distance exact in f32) and a 0/1
    mask at p = 0.9; ``dup`` makes centroid 1 a copy of centroid 0."""
    x = draw.dyadic((n, d))
    c = draw.dyadic((k, d), scale=2.0)
    if dup:  # at the origin, nearest to many rows: they tie
        c[0] = 0.0
        c[1] = c[0]
    m = draw.bools((n,), p=0.9).astype("float32")
    return tuple(torch.from_numpy(a).to(cuda_device) for a in (x, c, m))


@pytest.mark.parametrize("n,d,k,dup", [
    (256, 2, 4, False), (777, 17, 9, False), (1024, 64, 32, False),
    (100, 3, 5, False), (5000, 8, 6, True), (3000, 5, 1, False),
    (70_000, 40, 100, False), (2000, 300, 700, False),
    (3000, 32, 600, True)])
def test_kmeans_assign_kernel_matches_plain(cuda_device, n, d, k, dup):
    """Bitwise on dyadic data, duplicate centroids (the lower index wins)
    and K = 1 included; (2000, 300, 700) keeps its partials in global
    memory, (70,000, 40, 100) stages x in two column chunks, and
    (3000, 32, 600) stages whole rows in the ring with the centroids, the
    partial and the row bitmaps too large for shared memory."""
    draw = Draw(n + d + k)
    x, c, m = _km_inputs(draw, n, d, k, cuda_device, dup)
    before = km_ops.kmeans_assign_launches
    got = km_ops.assign_and_reduce(x, c, m)
    want = km_ref.assign_and_reduce_ref(x, c, m)
    torch.cuda.synchronize()
    assert km_ops.kmeans_assign_launches == before + 1
    assert got[0].dtype == torch.int32
    assert torch.equal(got[0].long(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    if dup:
        assert not bool((got[0] == 1).any()) and bool((got[0] == 0).any())


@pytest.mark.parametrize("d", [1, 17, 32, 33])
@pytest.mark.parametrize("k", [1, 8, 9, 16, 17, 32, 33, 64])
def test_kmeans_assign_size_classes_bitwise(cuda_device, k, d):
    """Each size class of the register tile (1, 2 or 4 lanes a row,
    passes of 32 centroids) at, below and past its edge, rows of one
    column (4-byte copies), 17, 32 (16-byte copies) and 33 (two staged
    chunks): bitwise the plain version on dyadic data; with two equal
    centroids at the origin, ties take the lower index."""
    n = 4099
    draw = Draw(1000 * k + d)
    x, c, m = _km_inputs(draw, n, d, k, cuda_device, k > 1)
    got = km_ops.assign_and_reduce(x, c, m)
    want = km_ref.assign_and_reduce_ref(x, c, m)
    torch.cuda.synchronize()
    assert torch.equal(got[0].long(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    if k > 1:
        assert not bool((got[0] == 1).any()) and bool((got[0] == 0).any())


def test_kmeans_assign_unaligned_rows(cuda_device):
    """x whose base is off 16 bytes takes 4-byte copies: same bits."""
    draw = Draw(77)
    x, c, m = _km_inputs(draw, 3000, 32, 64, cuda_device, True)
    flat = torch.empty(x.numel() + 1, device=cuda_device)
    xu = flat[1:].view(x.shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    got = km_ops.assign_and_reduce(xu, c, m)
    want = km_ops.assign_and_reduce(x, c, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kmeans_fit_goes_through_the_kernel(cuda_device):
    draw = Draw(29)
    centers = draw.normal((5, 3)) * 10.0
    pts = (centers[draw.ints((20_000,), 0, 4)]
           + draw.normal((20_000, 3))).astype("float32")
    seed = torch.from_numpy(centers[:, ::-1].copy() * 0.5 + 1.0)
    t = Table.from_columns({"x": pts}, device=cuda_device)
    km_ops.kmeans_assign_launches = 0
    with trace_execution() as tr:
        got = kmeans_fit(t, 5, init_centroids=seed, use_kernel=True)
    assert got.converged
    # two launches per round: the assignment and the previous round's
    assert km_ops.kmeans_assign_launches == 2 * got.n_iters
    assert {e.engine for e in tr.kernels} == {"cuda"}
    want = kmeans_fit(t, 5, init_centroids=seed)
    assert want.converged and abs(got.n_iters - want.n_iters) <= 2
    torch.testing.assert_close(got.centroids, want.centroids, rtol=1e-4,
                               atol=1e-4)


def test_kmeans_assign_forced_cuda_on_cpu_raises(cuda_device):
    x, c, m = torch.ones((4, 2)), torch.ones((3, 2)), torch.ones(4)
    with pytest.raises(ValueError, match="only on the card"):
        registry.dispatch("kmeans_assign", x, c, m, impl="cuda")
    assert km_ops.assign_and_reduce(x, c, m)[0].dtype == torch.int64


# -- flash_attention and the LM serving path -----------------------------------
# f32: kernel and plain version both sum f32 products, in other orders, and
# exp is the same function: max abs error 1e-4 on unit-normal inputs.
# bf16: both compute in f32 from the same bf16 inputs and round the output
# to bf16 once, so they may differ by one bf16 step: 2^-7 x max |plain|.


def _flash_inputs(cuda_device, b, hq, hk, s, d, dtype=torch.float32):
    draw = Draw(b * 1000 + hq * 100 + s + d)
    return [torch.from_numpy(draw.normal(shape)).to(cuda_device, dtype)
            for shape in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d))]


def _bf16_row_ratio(got, want):
    """The worst row (b, h, s) of a bf16 output: max |got - want| along D
    over max |want| along D (0 where both are 0).  One bf16 step of every
    row keeps it within 2^-7, also late causal rows, whose values are far
    below the first rows'."""
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    ratio = torch.where(err == 0, torch.zeros_like(err), err / scale)
    return float(ratio.max())


@pytest.mark.parametrize("b,hq,hk,s,d,causal", [
    (1, 2, 1, 128, 64, True), (2, 4, 2, 256, 64, True),
    (1, 8, 1, 128, 128, False), (1, 2, 2, 64, 32, True),
    (1, 4, 4, 128, 64, True), (2, 4, 2, 1000, 128, True),
    (1, 2, 1, 1, 16, True), (3, 6, 2, 77, 80, False)])
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hk, s, d,
                                              causal):
    q, k, v = _flash_inputs(cuda_device, b, hq, hk, s, d)
    before = fa_ops.flash_attention_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hk", [(1, 4, 1), (3, 6, 2)])
@pytest.mark.parametrize("s", [1, 77, 300, 1000])
@pytest.mark.parametrize("d", [16, 64, 80, 96, 128])
def test_flash_attention_tc_kernel_matches_plain(cuda_device, d, s, b, hq, hk,
                                                 causal):
    """bf16 through the tensor-core kernel, every D of the repo's configs,
    ragged S, GQA; within one bf16 step (2^-7) of max |plain|, overall and
    row by row."""
    q, k, v = _flash_inputs(cuda_device, b, hq, hk, s, d, torch.bfloat16)
    before = (fa_ops.flash_attention_launches,
              fa_ops.flash_attention_tc_launches,
              fa_ops.flash_attention_ffma_launches)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention_launches,
            fa_ops.flash_attention_tc_launches,
            fa_ops.flash_attention_ffma_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -7 * float(want.abs().max())
    assert _bf16_row_ratio(got, want) <= 2.0 ** -7


@pytest.mark.parametrize("b,hq,hk,s,d,causal", [
    (2, 16, 16, 1024, 128, True), (2, 12, 2, 1024, 128, True),
    (2, 16, 16, 1024, 80, False), (3, 16, 16, 333, 80, False)])
def test_flash_attention_tc_at_the_family_shapes(cuda_device, b, hq, hk, s,
                                                 d, causal):
    """The layer shapes of moonshot-v1-16b-a3b (Hq = Hk = 16), qwen2-vl-2b
    (12/2 GQA) and hubert-xlarge (non-causal D = 80, which the kernel
    zero-pads to its D = 128 tile), at S = 1024 and a ragged S: one
    tensor-core launch, within one bf16 step of the plain version."""
    q, k, v = _flash_inputs(cuda_device, b, hq, hk, s, d, torch.bfloat16)
    before = fa_ops.flash_attention_tc_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_tc_launches == before + 1
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -7 * float(want.abs().max())
    assert _bf16_row_ratio(got, want) <= 2.0 ** -7


def test_flash_attention_bf16_odd_d_takes_the_ffma_kernel(cuda_device):
    """bf16 with D % 8 != 0 goes through the FFMA kernel, by rule."""
    q, k, v = _flash_inputs(cuda_device, 1, 4, 2, 77, 20, torch.bfloat16)
    before = (fa_ops.flash_attention_tc_launches,
              fa_ops.flash_attention_ffma_launches)
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention_tc_launches,
            fa_ops.flash_attention_ffma_launches) == (before[0],
                                                      before[1] + 1)
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -7 * float(want.abs().max())


@pytest.mark.parametrize("layout", ["stride", "pointer"])
def test_flash_attention_bf16_unaligned_takes_the_ffma_kernel(cuda_device,
                                                               layout):
    """bf16 with D % 8 == 0 that TMA cannot read (a position stride of 28
    elements, or a pointer 2 bytes past 16) goes through the FFMA kernel,
    by rule, and matches the plain version."""
    q, k, v = _flash_inputs(cuda_device, 1, 4, 2, 64, 24, torch.bfloat16)
    if layout == "stride":
        odd = torch.zeros((1, 4, 64, 28), dtype=torch.bfloat16,
                          device=cuda_device)[..., :24]
    else:
        odd = torch.zeros(1 + q.numel(), dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(q.shape)
    odd.copy_(q)
    before = (fa_ops.flash_attention_tc_launches,
              fa_ops.flash_attention_ffma_launches)
    got = fa_ops.flash_attention(odd, k, v)
    want = fa_ref.flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention_tc_launches,
            fa_ops.flash_attention_ffma_launches) == (before[0],
                                                      before[1] + 1)
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -7 * float(want.abs().max())


def test_flash_attention_tc_causality(cuda_device):
    """bf16: keys and values after position 40 do not move the outputs
    before it by a bit."""
    q, k, v = _flash_inputs(cuda_device, 1, 2, 1, 200, 128, torch.bfloat16)
    base = fa_ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] += 10.0
    v2[:, :, 40:] += 10.0
    pert = fa_ops.flash_attention(q, k2, v2)
    assert torch.equal(base[:, :, :40], pert[:, :, :40])
    assert float((base[:, :, 41:].float()
                  - pert[:, :, 41:].float()).abs().max()) > 1e-3


def test_flash_attention_kernel_bf16_and_strided(cuda_device):
    q, k, v = _flash_inputs(cuda_device, 2, 8, 2, 300, 128, torch.bfloat16)
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * float(want.float().abs().max())
    # (B, S, H, D) storage seen through transpose(1, 2): the same bits
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qt.is_contiguous()
    assert torch.equal(fa_ops.flash_attention(qt, kt, vt), got)


def test_flash_attention_kernel_causality(cuda_device):
    q, k, v = _flash_inputs(cuda_device, 1, 2, 1, 64, 32)
    base = fa_ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] += 10.0
    v2[:, :, 40:] += 10.0
    pert = fa_ops.flash_attention(q, k2, v2)
    assert torch.equal(base[:, :, :40], pert[:, :, :40])
    assert float((base[:, :, 41:] - pert[:, :, 41:]).abs().max()) > 1e-3


def test_flash_attention_rejects_on_card(cuda_device):
    q = torch.zeros((1, 4, 8, 160), device=cuda_device)
    k = torch.zeros((1, 2, 8, 160), device=cuda_device)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k)
    q = torch.zeros((1, 4, 8, 16), device=cuda_device)
    k = torch.zeros((1, 3, 8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k)


@pytest.mark.parametrize("arch", ["qwen3-8b", "stablelm-1.6b"])
def test_forward_goes_through_flash_attention(cuda_device, arch):
    """One launch per layer; the logits as the use_flash=False path gives
    them, within 1e-4 (f32 reduced configs), and as decode gives them
    within the reference's decode-vs-forward bounds."""
    cfg = reduced_config(arch)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = M.init_model(cfg, generator=gen, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                         device=cuda_device)
    fa_ops.flash_attention_launches = 0
    with trace_execution() as tr:
        fwd, _ = M.forward(model, toks)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_launches == cfg.n_layers
    assert [e.engine for e in tr.kernels] == ["cuda"] * cfg.n_layers
    plain, _ = M.forward(model, toks, use_flash=False)
    torch.testing.assert_close(fwd, plain, rtol=1e-4, atol=1e-4)
    state = M.init_decode_state(cfg, 2, 40, device=cuda_device)
    outs = []
    for t in range(40):
        lg, state = M.decode_step(model, state, toks[:, t:t + 1], t)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), fwd, rtol=2e-3,
                               atol=2e-4)


def _family_inputs(cfg, device, b=2, s=40):
    """The forward's keyword inputs for ``cfg``'s family: frame
    embeddings (audio); 4 patch embeddings, tokens and M-RoPE positions
    at (t = 0, h, w) then text (vlm); tokens."""
    draw = Draw(s + cfg.d_model)
    if cfg.family == "audio":
        return {"embeddings": torch.from_numpy(
            draw.normal((b, s, cfg.d_model))).to(device)}
    toks = torch.from_numpy(draw.ints((b, s), 0, cfg.vocab - 1)).to(device)
    if cfg.family != "vlm":
        return {"tokens": toks}
    hh, ww = torch.meshgrid(torch.arange(2), torch.arange(2), indexing="ij")
    img = torch.stack([torch.zeros(4, dtype=torch.long), hh.ravel(),
                       ww.ravel()])
    text = (torch.arange(s - 4) + 2).expand(3, s - 4)
    pos = torch.cat([img, text], 1)[:, None].expand(3, b, s)
    return {"tokens": toks[:, 4:],
            "embeddings": torch.from_numpy(
                draw.normal((b, 4, cfg.d_model))).to(device),
            "mrope_positions": pos.to(device)}


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b",
                                  "hubert-xlarge", "recurrentgemma-2b",
                                  "qwen2-vl-2b", "xlstm-350m"])
def test_family_forward_on_card_matches_cpu(cuda_device, arch):
    """The reduced config's forward (f32) on the card, through the FFMA
    flash kernel once per attention layer without a window, against the
    same weights' forward on the CPU (plain versions): rtol = atol = 1e-4,
    the flash kernel's f32 bound, as cuBLAS and the CPU sum matmuls in
    other orders; the MoE aux alike."""
    from repro_torch.interop import (model_params_from_numpy,
                                     model_params_to_numpy)
    from repro_torch.models.config import layer_kinds

    cfg = reduced_config(arch)
    cpu = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    card = model_params_from_numpy(cfg, model_params_to_numpy(cpu),
                                   device=cuda_device)
    inp = _family_inputs(cfg, "cpu")
    want, want_aux = M.forward(cpu, inp.get("tokens"), **{
        k: v for k, v in inp.items() if k != "tokens"})
    before = fa_ops.flash_attention_launches
    got, aux = M.forward(card, **{k: v.to(cuda_device)
                                  for k, v in inp.items()})
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_launches - before == sum(
        k == "attn" for k in layer_kinds(cfg))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert set(aux) == set(want_aux)
    for k in aux:
        torch.testing.assert_close(aux[k].cpu(), want_aux[k], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "recurrentgemma-2b",
                                  "qwen2-vl-2b", "xlstm-350m"])
def test_family_serve_on_card(cuda_device, arch):
    toks, timings = serve(arch, batch=2, prompt_len=4, gen_len=5)
    assert toks.shape == (2, 5) and toks.device.type == "cuda"
    assert timings["decode_tok_s"] > 0


def test_serve_on_card(cuda_device):
    toks, timings = serve("qwen3-8b", batch=2, prompt_len=4, gen_len=5)
    assert toks.shape == (2, 5) and toks.device.type == "cuda"
    assert timings["decode_tok_s"] > 0


# -- the analytics server, joins and living views on the card ---------------

def _server_table(device, n=20_000, d=24, groups=8, seed=181):
    draw = Draw(seed)
    gids, _ = group_layout(draw, n, groups, "uniform")
    return Table({"x": torch.from_numpy(draw.dyadic((n, d))).to(device),
                  "y": torch.from_numpy(draw.dyadic((n,))).to(device),
                  "item": torch.from_numpy(draw.ints((n,), 0, 5000)).to(
                      device),
                  "g": torch.from_numpy(gids).to(device)})


def _tree_equal(a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_server_mix_on_card_matches_ref(cuda_device):
    """Three sessions' analytics mix in one window: one scan through xtx
    and countmin, answers bitwise equal to the same statements forced to
    the plain versions; the next round is answered from the cache."""
    from repro_torch.core import AnalyticsServer

    t = _server_table(cuda_device)

    def mix(sess, uk):
        return [sess.profile(t), sess.linregr(t, use_kernel=uk),
                sess.scan(CountMinAggregate(use_kernel=uk), t,
                          columns=("item",), label="countmin"),
                sess.fm_distinct_count(t)]

    srv = AnalyticsServer(window_size=1024)
    try:
        before = (xtx_ops.xtx_launches, cm_ops.countmin_launches)
        handles = [mix(Session(server=srv), True) for _ in range(3)]
        with trace_execution() as tr:
            srv.flush()
        torch.cuda.synchronize()
        assert len(tr.scans) == 1
        ev = tr.admissions[0].detail
        assert (ev["window"], ev["planned"], ev["deduped"]) == (12, 4, 8)
        assert xtx_ops.xtx_launches > before[0]
        assert cm_ops.countmin_launches > before[1]
        assert {e.engine for e in tr.kernels} == {"cuda"}
        ref_sess = Session()
        want = mix(ref_sess, "ref")
        ref_sess.run()
        for hs in handles:
            for h, w in zip(hs, want):
                assert _tree_equal(h.result(timeout=60), w.result())
        with trace_execution() as tr:
            again = mix(Session(server=srv), True)
            srv.flush()
        assert len(tr.scans) == 0 and len(tr.cache_hits) == 4
        for h, w in zip(again, want):
            assert _tree_equal(h.result(timeout=60), w.result())
    finally:
        srv.close()


def _star_on_card(device, fact_rows=30_000, dim_rows=2_000, groups=16,
                  seed=191):
    draw = Draw(seed)
    keys = draw.permutation(dim_rows * 5)[:dim_rows].astype("int32") + 3
    attr = draw.ints((dim_rows,), 0, groups - 1)
    fk = keys[draw.rng.integers(0, dim_rows, fact_rows)]
    fk[::50] = -7                      # 2% dangling
    fact = Table({"x": torch.from_numpy(draw.dyadic((fact_rows, 12))).to(
                      device),
                  "y": torch.from_numpy(draw.dyadic((fact_rows,))).to(device),
                  "fk": torch.from_numpy(fk.astype("int32")).to(device)})
    dim = Table({"key": torch.from_numpy(keys).to(device),
                 "attr": torch.from_numpy(attr).to(device)})
    lut = dict(zip(keys.tolist(), attr.tolist()))
    gids = torch.tensor([lut.get(int(f), -1) for f in fk], dtype=torch.int32)
    return fact, dim, gids.to(device)


def test_joined_statement_on_card_matches_ref(cuda_device):
    from repro_torch.core import Join, JoinedGroupedScanAgg
    from repro_torch.methods.linregr import LinregrAggregate, linregr_joined

    fact, dim, gids = _star_on_card(cuda_device)
    before = sf_ops.segment_linregr_launches
    kw = dict(fact_key="fk", dim_key="key", attr_col="attr",
              on_missing="drop")
    got = linregr_joined(fact, dim, use_kernel=True, **kw)
    torch.cuda.synchronize()
    assert sf_ops.segment_linregr_launches == before + 1
    want = linregr_joined(fact, dim, use_kernel="ref", **kw)
    assert _tree_equal(got, want)
    # fold states against gathering the attribute by hand
    res = Join(fact, dim, "fk", "key", "attr", on_missing="drop").resolve()
    assert torch.equal(res.table[res.gid_col], gids)
    state = run_grouped(LinregrAggregate(use_kernel=True),
                        res.table.group_by(res.gid_col, res.num_groups),
                        finalize=False)
    manual = Table({"x": fact["x"], "y": fact["y"], "g": gids})
    oracle = run_grouped(LinregrAggregate(use_kernel="ref"), manual, "g",
                         res.num_groups, finalize=False)
    assert _tree_equal(state, oracle)
    with pytest.raises(ValueError, match="600 of 30000"):
        execute(JoinedGroupedScanAgg(
            LinregrAggregate(use_kernel=True),
            Join(fact, dim, "fk", "key", "attr"), columns=("x", "y")))


def test_joined_batch_runs_each_members_segment_kernel_on_card(cuda_device):
    """Two joined statements in one batch: one resolution, one scan, and
    each member's own segment kernel launched once over the shared
    layout, bitwise against the same batch on the plain versions."""
    from repro_torch.core import Join
    from repro_torch.methods.linregr import LinregrAggregate

    fact, dim, _ = _star_on_card(cuda_device, seed=195)
    fact = fact.with_column("item", fact["fk"].abs())

    def batch(impl):
        sess = Session()
        hs = [sess.joined_grouped_scan(
                  LinregrAggregate(use_kernel=impl),
                  Join(fact, dim, "fk", "key", "attr", on_missing="drop"),
                  columns=("x", "y")),
              sess.joined_grouped_scan(
                  CountMinAggregate(use_kernel=impl),
                  Join(fact, dim, "fk", "key", "attr", on_missing="drop"),
                  columns=("item",))]
        sess.run()
        return [h.result() for h in hs]

    before = (sf_ops.segment_linregr_launches,
              sf_ops.segment_countmin_launches)
    with trace_execution() as tr:
        got = batch(True)
    torch.cuda.synchronize()
    assert len(tr.scans) == 1 and len(tr.joins) == 1
    assert (sf_ops.segment_linregr_launches,
            sf_ops.segment_countmin_launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert sorted((e.detail["name"], e.engine) for e in tr.kernels) == [
        ("segment_countmin", "cuda"), ("segment_linregr", "cuda")]
    want = batch("ref")
    assert _tree_equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_thread_drains_two_facts_one_dim_on_card(cuda_device):
    from repro_torch.core import AnalyticsServer, Join
    from repro_torch.methods.linregr import LinregrAggregate

    fact_a, dim, gids_a = _star_on_card(cuda_device, seed=193)
    fact_b = Table({k: v.flip(0) for k, v in fact_a.columns.items()})
    gids_b = gids_a.flip(0)
    srv = AnalyticsServer(window_size=1024, window_timeout=0.02,
                          drain="thread")
    try:
        with trace_execution() as tr:
            hs = [(f, g, Session(server=srv).joined_grouped_scan(
                LinregrAggregate(use_kernel=True),
                Join(f, dim, "fk", "key", "attr", on_missing="drop"),
                columns=("x", "y")))
                for f, g in ((fact_a, gids_a), (fact_b, gids_b))
                for _ in range(2)]
            for _, _, h in hs:
                assert h.wait(60), "background drainer never fired"
        torch.cuda.synchronize()
        assert len(tr.joins) == 2
        assert tr.summary()["sorts_by_table"].get(id(dim)) == 1
        for f, g, h in hs:
            manual = Table({"x": f["x"], "y": f["y"], "g": g})
            want = run_grouped(LinregrAggregate(use_kernel="ref"), manual,
                               "g", 16)
            assert _tree_equal(h.result(timeout=10), want)
    finally:
        srv.close()


def test_grouped_view_delta_on_card_equals_rescan(cuda_device):
    from repro_torch.core import GroupedScanAgg, materialize
    from repro_torch.methods.linregr import LinregrAggregate

    t = _server_table(cuda_device, n=40_000, groups=8, seed=197)
    node = (lambda: GroupedScanAgg(LinregrAggregate(use_kernel=True), t, "g",
                                   8, columns={"x": "x", "y": "y"}))
    h = materialize(node())
    extra = _server_table(cuda_device, n=1_000, groups=8, seed=199)
    t.append(dict(extra.columns))
    before = sf_ops.segment_linregr_launches
    assert h.refresh() == "delta"
    torch.cuda.synchronize()
    assert sf_ops.segment_linregr_launches == before + 1
    assert _tree_equal(h._state, materialize(node())._state)


# -- the stream engine: blocks from host memory to the card -------------------

class _RawFused(FusedAggregate):
    """Linregr (through xtx) and Count-Min (through countmin) fused,
    ``final`` returning the fold states."""

    def __init__(self):
        super().__init__([LinregrAggregate(use_kernel=True),
                          CountMinAggregate(4, 1024, use_kernel=True)])

    def final(self, state):
        return state


def _stream_cols(n=70_001, k=24, seed=191):
    draw = Draw(seed)
    return {"x": draw.dyadic((n, k)), "y": draw.dyadic((n,)),
            "item": draw.ints((n,), -100_000, 100_000)}


def _stream_sources(cols, bs, device):
    """Block sources by kind: each yields the rows of ``cols`` in blocks
    of ``bs`` (the last one ragged)."""
    n = cols["y"].shape[0]
    starts = range(0, n, bs)
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in cols.items()}

    def reusing_numpy():
        buf = {k: np.empty((bs,) + v.shape[1:], v.dtype)
               for k, v in cols.items()}
        for i in starts:
            m = min(bs, n - i)
            for k, v in cols.items():
                buf[k][:m] = v[i:i + m]
            yield {k: v[:m] for k, v in buf.items()}

    def reusing_pinned():
        buf = {k: torch.empty((bs,) + v.shape[1:], dtype=v.dtype,
                              pin_memory=True) for k, v in pinned.items()}
        for i in starts:
            m = min(bs, n - i)
            for k, v in pinned.items():
                buf[k][:m].copy_(v[i:i + m])
            yield {k: v[:m] for k, v in buf.items()}

    return {
        "pageable numpy": lambda: ({k: v[i:i + bs] for k, v in cols.items()}
                                   for i in starts),
        "pageable tensors": lambda: ({k: torch.from_numpy(v[i:i + bs])
                                      for k, v in cols.items()}
                                     for i in starts),
        "pinned tensors": lambda: ({k: v[i:i + bs] for k, v in pinned.items()}
                                   for i in starts),
        "cuda tensors": lambda: ({k: v[i:i + bs].to(device)
                                  for k, v in pinned.items()}
                                 for i in starts),
        "float64 and int64 numpy": lambda: (
            {"x": cols["x"][i:i + bs].astype(np.float64),
             "y": cols["y"][i:i + bs].astype(np.float64),
             "item": cols["item"][i:i + bs].astype(np.int64)}
            for i in starts),
        "one reused numpy buffer": reusing_numpy,
        "one reused pinned tensor": reusing_pinned,
    }



@pytest.mark.parametrize("source", [
    "pageable numpy", "pageable tensors", "pinned tensors", "cuda tensors",
    "float64 and int64 numpy", "one reused numpy buffer",
    "one reused pinned tensor"])
def test_run_stream_from_every_source_matches_the_resident_fold(
        cuda_device, source):
    cols = _stream_cols()
    bs = 16_384
    nb = -(-cols["y"].shape[0] // bs)
    resident = Table({k: torch.from_numpy(v).to(cuda_device)
                      for k, v in cols.items()})
    want = run_local(_RawFused(), resident, block_size=bs)
    blocks = _stream_sources(cols, bs, cuda_device)[source]()
    before = (xtx_ops.xtx_launches, cm_ops.countmin_launches)
    with trace_execution() as tr:
        got = run_stream(_RawFused(), blocks)
    torch.cuda.synchronize()
    assert [e.engine for e in tr.scans] == ["stream"]
    # one launch of each kernel per block, the ragged tail's included
    assert (xtx_ops.xtx_launches - before[0],
            cm_ops.countmin_launches - before[1]) == (nb, nb)
    assert _tree_equal(got, want)


def test_stream_ragged_tail_kernels_match_plain(cuda_device):
    cols = _stream_cols()
    tail = cols["y"].shape[0] % 16_384
    assert tail
    x = torch.from_numpy(cols["x"][-tail:]).to(cuda_device)
    y = torch.from_numpy(cols["y"][-tail:]).to(cuda_device)
    items = torch.from_numpy(cols["item"][-tail:]).to(cuda_device)
    ones = torch.ones((tail,), dtype=torch.bool, device=cuda_device)
    for g, w in zip(xtx_ops.xtx_xty(x, y), xtx_ref.xtx_xty_ref(x, y)):
        assert torch.equal(g, w)
    assert torch.equal(cm_ops.countmin_block(items, ones, 4, 1024),
                       cm_ref.countmin_block_ref(items, ones, 4, 1024))


def test_stream_statements_on_card_fold_once(cuda_device):
    """Two stream statements over one pinned source: one scan, states
    bitwise equal to the resident batch."""
    cols = _stream_cols(n=40_000)
    srcs = _stream_sources(cols, 10_000, cuda_device)
    blocks = srcs["pinned tensors"]()
    sess = Session()
    h_lr = sess.stream_scan(LinregrAggregate(use_kernel=True), blocks,
                            columns=("x", "y"))
    h_fm = sess.stream_scan(FMAggregate(), blocks, columns=("item",))
    with trace_execution() as tr:
        sess.run()
    resident = Table({k: torch.from_numpy(v).to(cuda_device)
                      for k, v in cols.items()})
    assert len(tr.scans) == 1
    assert _tree_equal(h_lr.result(), linregr(resident, use_kernel=True))
    assert torch.equal(h_fm.result(), fm_distinct_count(resident))


# ---------------------------------------------------------------------------
# The calibration harness's shapes, and the tenth slice's methods on the
# card against the CPU port.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 128, 256, 512, 1024, 2048, 4096])
def test_calibration_shapes_match_plain(cuda_device, block):
    """The sweep's kernels at K = 8 and Count-Min 4 x 128, at each swept
    block: bitwise the plain versions on dyadic data (any items)."""
    draw = Draw(block)
    G, n = 64, 100_000
    gids, _ = group_layout(draw, n, G, "skewed")
    t = Table.from_columns({"x": draw.dyadic((n, 8)), "y": draw.dyadic((n,)),
                            "item": draw.ints((n,), 0, 9999), "g": gids},
                           device=cuda_device)
    cols, valid, bgids = t.group_by("g", G).aligned_blocks(block)
    args = (cols["x"], cols["y"], valid, bgids)
    got = sf_ops.segment_linregr(*args, num_groups=G)
    want = sf_ref.segment_linregr_ref(*args, num_groups=G)
    assert all(torch.equal(got[q], want[q]) for q in want)
    sk = (cols["item"], valid, bgids)
    assert torch.equal(
        sf_ops.segment_countmin(*sk, depth=4, width=128, num_groups=G),
        sf_ref.segment_countmin_ref(*sk, depth=4, width=128, num_groups=G))
    x, y, items = t["x"], t["y"], t["item"]
    for g, w in zip(xtx_ops.xtx_xty(x, y), xtx_ref.xtx_xty_ref(x, y)):
        assert torch.equal(g, w)
    ones = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    assert torch.equal(cm_ops.countmin_block(items, ones, 4, 128),
                       cm_ref.countmin_block_ref(items, ones, 4, 128))


def test_calibration_harness_on_card_launches_the_kernels(cuda_device,
                                                          tmp_path):
    from repro_torch.core import calibration
    from repro_torch.launch.calibrate import calibrate
    before = (xtx_ops.xtx_launches, sf_ops.segment_linregr_launches,
              cm_ops.countmin_launches, sf_ops.segment_countmin_launches)
    cal, path = calibrate([1 << 16], [8], 1, [64, 256], device=cuda_device,
                          out=str(tmp_path / "cuda.json"), log=lambda s: None)
    after = (xtx_ops.xtx_launches, sf_ops.segment_linregr_launches,
             cm_ops.countmin_launches, sf_ops.segment_countmin_launches)
    assert all(a > b for a, b in zip(after, before))
    assert cal.backend == "cuda"
    assert {"local", "grouped-segment", "grouped-masked"} <= set(cal.engines)
    with calibration.use(path):
        assert calibration.current().grouped_block_size(1 << 16, 8) in (64,
                                                                        256)


def _both(cols):
    return (Table.from_columns(cols, device="cpu"),
            Table.from_columns(cols, device="cuda"))


def test_new_methods_on_card_match_the_cpu_port(cuda_device):
    from repro_torch.methods import (
        assoc_rules, decision_tree, lda, naive_bayes, quantiles,
        sparse_vector, string_match, svd,
    )
    draw = Draw(2024)
    n = 20_000
    x = draw.dyadic((n, 6))
    # labels from a rule, so every split the tree takes is a clear one
    y = ((x[:, 0] > 0).astype(np.int32) + 2 * (x[:, 3] > -0.125))
    cols = {"x": x, "y": y, "v": draw.normal((n,)),
            "g": draw.ints((n,), 0, 7)}
    cpu, card = _both(cols)
    # the fold state bitwise; the model through log, which the card and
    # the CPU round apart in the last ulp
    nb = naive_bayes.NaiveBayesAggregate(4)
    sa, sb = (run_local(nb, t.select("x", "y"), block_size=4096,
                        finalize=False) for t in (cpu, card))
    assert all(torch.equal(sa[k], sb[k].cpu()) for k in sa)
    a, b = (naive_bayes.naive_bayes_fit(t, 4, block_size=4096)
            for t in (cpu, card))
    for f in ("log_prior", "mean", "var"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f).cpu(),
                                   rtol=1e-6, atol=0)
    for fn in (lambda t: quantiles.quantiles(t, [0.1, 0.5, 0.99], bins=1000),
               lambda t: quantiles.quantiles_grouped(t, "g", [0.25, 0.75],
                                                     bins=333)):
        assert torch.equal(fn(cpu), fn(card).cpu())
    ta, tb = (decision_tree.decision_tree_fit(t, num_classes=4, max_depth=3)
              for t in (cpu, card))
    for f in ("feature", "threshold", "leaf_class"):
        assert torch.equal(getattr(ta, f), getattr(tb, f).cpu())
    items = {"items": draw.bools((n, 6), p=0.3).astype(np.float32)}
    ra, rb = (assoc_rules.apriori(t, min_support=0.05) for t in _both(items))
    assert ra.supports == rb.supports and ra.rules == rb.rules
    # a spectral gap after k, so both converge whatever their random start
    # (the CPU's and the card's generators draw different numbers)
    u = np.linalg.qr(draw.normal((4000, 12)).astype(np.float64))[0]
    v = np.linalg.qr(draw.normal((12, 12)).astype(np.float64))[0]
    spec = np.array([50.0, 30.0, 20.0] + [1.0] * 9)
    mat = {"a": ((u * spec) @ v.T).astype(np.float32)}
    sa, sb = (svd.svd_power(t, 3, n_iters=30)[0] for t in _both(mat))
    torch.testing.assert_close(sa, sb.cpu(), rtol=1e-4, atol=0)
    docs = {"counts": draw.ints((300, 50), 0, 3)}
    beta = lda.dirichlet_topics(4, 50, seed=1, device="cpu")
    ea, eb = (run_local(lda.LDAEStepAggregate(beta.to(t.device).log()), t)
              for t in _both(docs))
    for k in ea:
        torch.testing.assert_close(ea[k], eb[k].cpu(), rtol=1e-5, atol=1e-5)
    strs = ["tim tebow", "tom brady", "tim duncan", "tim tebow jr"] * 50
    chars = string_match.encode_strings(strs, device="cpu")
    ia, ib = (run_local(string_match.TrigramIndexAggregate(len(strs)), t)
              for t in _both({"chars": chars, "doc_id": np.arange(len(strs))}))
    assert torch.equal(ia, ib.cpu())
    ha, hb = (string_match.approx_match(i, "tim tebow", threshold=0.4)
              for i in (ia, ib))
    assert torch.equal(ha[0], hb[0].cpu()) and torch.equal(ha[1],
                                                           hb[1].cpu())
    dense = torch.from_numpy(np.repeat(draw.dyadic((40,)), 3))
    va, vb = (sparse_vector.rle_encode(dense.to(d), 128)
              for d in ("cpu", cuda_device))
    assert torch.equal(sparse_vector.rle_dot_rle(va, va),
                       sparse_vector.rle_dot_rle(vb, vb).cpu())
    assert torch.equal(sparse_vector.rle_decode(vb).cpu(), dense)


# ---------------------------------------------------------------------------
# The convex layer and what runs on it, on the card against the CPU port.
# ---------------------------------------------------------------------------

def _logistic_cols(draw, n, d):
    x = draw.normal((n, d))
    b = draw.normal((d,))
    p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ b)))
    return {"x": x, "y": (draw.uniform((n,)) < p).astype(np.float32)}


@pytest.mark.parametrize("name", ["least_squares", "logistic"])
def test_newton_on_card_matches_the_cpu_port(cuda_device, name):
    from repro_torch.core import newton
    from repro_torch.methods.logregr import logistic_program
    from repro_torch.methods.sgd_models import least_squares_program
    draw = Draw(3030)
    cols = _logistic_cols(draw, 50_000, 12)
    prog = {"least_squares": least_squares_program(),
            "logistic": logistic_program()}[name]
    (wa, ta, ca), (wb, tb, cb) = (
        newton(prog, t, torch.zeros(12, device=t.device), max_iters=20,
               tol=1e-5, block_size=8192) for t in _both(cols))
    assert len(ta) == len(tb) and ca == cb and ca
    torch.testing.assert_close(wb.cpu(), wa, rtol=1e-4, atol=1e-5)


def test_sgd_on_card_matches_the_cpu_port(cuda_device):
    """Full batch: the shuffle only reorders the one minibatch's sum, so
    the card's and the CPU's generators cannot part them."""
    from repro_torch.core import sgd
    from repro_torch.methods.logregr import logistic_program
    from repro_torch.methods.svm import svm_fit
    draw = Draw(3031)
    cols = _logistic_cols(draw, 4096, 8)
    ws = [sgd(logistic_program(), t, torch.zeros(8, device=t.device),
              stepsize=1.0, epochs=3, batch=4096, seed=1) for t in _both(cols)]
    torch.testing.assert_close(ws[1].cpu(), ws[0], rtol=1e-4, atol=1e-5)
    card = _both(cols)[1]
    a = svm_fit(card, epochs=2, batch=64, seed=5)
    b = svm_fit(card, epochs=2, batch=64, seed=5)
    assert a.device.type == "cuda" and torch.equal(a, b)


def test_crf_on_card_matches_the_cpu_port(cuda_device):
    from repro_torch.methods import crf
    draw = Draw(3032)
    toks = draw.ints((300, 20), 0, 999)
    lengths = draw.ints((300,), 1, 20)
    mask = (np.arange(20)[None, :] < lengths[:, None]).astype(np.float32)
    dictionary = draw.ints((1000,), 0, 1)
    fa, fb = (crf.extract_features(torch.from_numpy(toks).to(dev), 1 << 12,
                                   torch.from_numpy(dictionary).to(dev))
              for dev in ("cpu", cuda_device))
    assert torch.equal(fa, fb.cpu())
    params = {"emit": torch.from_numpy(draw.normal((1 << 12, 5))),
              "trans": torch.from_numpy(draw.normal((5, 5)))}
    m = torch.from_numpy(mask)
    va = crf.viterbi_decode(params, fa, m)
    on_card = {k: v.to(cuda_device) for k, v in params.items()}
    vb = crf.viterbi_decode(on_card, fb, m.to(cuda_device))
    assert vb.dtype == torch.int32 and torch.equal(va, vb.cpu())
    labels, marg = crf.gibbs_sample(on_card, fb, m.to(cuda_device), seed=1,
                                    n_sweeps=4)
    torch.testing.assert_close(marg.sum(-1).cpu(), torch.ones(300, 20))
    _, rate = crf.mh_sample(on_card, fb, m.to(cuda_device), seed=2,
                            n_steps=50)
    assert 0.0 < float(rate) <= 1.0


def test_fit_grouped_linregr_task_on_card_launches_xtx_per_group(
        cuda_device):
    from repro_torch.core import fit_grouped
    from repro_torch.methods.linregr import LinregrTask
    draw = Draw(3033)
    n = 30_000
    gids, _ = group_layout(draw, n, 9, "empty")
    cols = {"x": draw.dyadic((n, 20)), "y": draw.dyadic((n,)), "g": gids}
    cpu, card = _both(cols)
    before = xtx_ops.xtx_launches
    got = fit_grouped(LinregrTask(use_kernel=True), card, "g", 9,
                      max_iters=1, tol=None)
    torch.cuda.synchronize()
    assert xtx_ops.xtx_launches - before == len(np.unique(gids))
    want = fit_grouped(LinregrTask(), cpu, "g", 9, max_iters=1, tol=None)
    assert torch.equal(got.result.num_rows.cpu(), want.result.num_rows)
    full = want.result.num_rows > 0
    torch.testing.assert_close(got.result.coef.cpu()[full],
                               want.result.coef[full], rtol=1e-4, atol=1e-5)
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        assert np.array_equal(np.asarray(got.stats[k]),
                              np.asarray(want.stats[k])), k


# -- the flash_attention backward kernels, and training on the card ---------
# Kernel and plain version compute in f32 from the same inputs and sum in
# other orders: f32 within 1e-4 of max |plain|; bf16 within one bf16 step
# (2^-7 of max |plain|), since both round to bf16 once (the tensor-core
# backward also rounds P and dS to bf16 as product operands, as the
# reference's bf16 gradient does).  bf16 runs the tensor-core backward
# (flash_attention_bwd_tc.cu), f32 the FFMA one (flash_attention_bwd.cu).
# The forward's log-sum-exp against torch.logsumexp of the plain version's
# f32 logits: within 2e-5 of max(1, |lse|) per row.

BWD_SHAPES = [(1, 2, 1, 64, 64, True), (2, 4, 2, 100, 16, True),
              (1, 2, 2, 37, 80, False), (1, 4, 4, 128, 128, True),
              (2, 8, 2, 70, 32, False), (1, 2, 1, 2, 8, True)]
LSE_REL = 2e-5


def _bwd_inputs(dev, dtype, b, hq, hk, s, d, seed):
    draw = Draw(seed)
    # (B, S, H, D) storage seen through transpose(1, 2), as the model has it
    q, k, v, do = (torch.from_numpy(draw.normal((b, s, h, d))).to(
        dev).to(dtype).transpose(1, 2) for h in (hq, hk, hk, hq))
    out = fa_ref.flash_attention_ref(q, k, v)
    return q, k, v, out, do


def _hold_bwd(got, want, rel):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * scale + 1e-30, (err, scale)


def _bwd_counts():
    return (fa_ops.flash_attention_bwd_launches,
            fa_ops.flash_attention_bwd_tc_launches,
            fa_ops.flash_attention_bwd_ffma_launches)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hk,s,d,causal", BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, dtype, b, hq,
                                                  hk, s, d, causal):
    dt = getattr(torch, dtype)
    q, k, v, _, do = _bwd_inputs(cuda_device, dt, b, hq, hk, s, d, s * d)
    out = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    _, lse = fa_ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    before = _bwd_counts()
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    again = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    ran = tuple(a - c for a, c in zip(_bwd_counts(), before))
    assert ran == ((2, 2, 0) if dtype == "bfloat16" else (2, 0, 2))
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, do, causal=causal)
    _hold_bwd(got, want, 1e-4 if dtype == "float32" else 2.0 ** -7)
    for a, c in zip(got, again):
        assert torch.equal(a, c)        # no atomics: the same bits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hk,s,d,causal", BWD_SHAPES + [
    (2, 4, 2, 300, 128, True), (1, 8, 8, 1000, 64, True)])
def test_flash_attention_forward_lse_matches_plain(cuda_device, dtype, b, hq,
                                                   hk, s, d, causal):
    """Both forward kernels (tensor cores in bf16, FFMA in f32) write each
    row's log-sum-exp when asked, within LSE_REL of max(1, |plain|); the
    output is bitwise the output without it."""
    dt = getattr(torch, dtype)
    q, k, v, _, _ = _bwd_inputs(cuda_device, dt, b, hq, hk, s, d, s + d)
    before = (fa_ops.flash_attention_tc_launches,
              fa_ops.flash_attention_ffma_launches)
    out, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    plain = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ran = (fa_ops.flash_attention_tc_launches - before[0],
           fa_ops.flash_attention_ffma_launches - before[1])
    assert ran == ((2, 0) if dtype == "bfloat16" else (0, 2))
    assert torch.equal(out, plain)
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                      return_lse=True)[1]
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    err = (lse - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= LSE_REL


def test_flash_attention_bwd_bf16_unaligned_takes_the_ffma_kernel(
        cuda_device):
    """bf16 whose dout TMA cannot read (a pointer 2 bytes past 16) goes
    through the FFMA backward, by the forward's rule."""
    q, k, v, out, do = _bwd_inputs(cuda_device, torch.bfloat16, 1, 4, 2, 64,
                                   32, 5)
    _, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    odd = torch.zeros(1 + do.numel(), dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(do.shape)
    odd.copy_(do)
    before = _bwd_counts()
    got = fa_ops.flash_attention_bwd(q, k, v, out, odd, lse)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_bwd_counts(), before)) == (1, 0, 1)
    _hold_bwd(got, fa_ref.flash_attention_bwd_ref(q, k, v, out, do),
              2.0 ** -7)


def test_flash_attention_autograd_runs_the_bwd_kernel(cuda_device):
    q, k, v, _, do = _bwd_inputs(cuda_device, torch.bfloat16, 2, 8, 2, 256,
                                 64, 7)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (_bwd_counts(), fa_ops.flash_attention_tc_launches)
    with trace_execution() as tr:
        out = registry.dispatch("flash_attention", *qkv, causal=True)
        grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert (tuple(a - c for a, c in zip(_bwd_counts(), before[0])),
            fa_ops.flash_attention_tc_launches - before[1]) == ((1, 1, 0), 1)
    assert [(e.detail["name"], e.engine) for e in tr.kernels] == [
        ("flash_attention", "cuda"), ("flash_attention_bwd", "cuda")]
    # the saved lse is the forward kernel's: the same bits as asking for it
    _, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    want = fa_ops.flash_attention_bwd(q, k, v, out.detach(), do, lse)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_flash_attention_bwd_rejects_on_card(cuda_device):
    q, k, v, out, do = _bwd_inputs(cuda_device, torch.float32, 1, 2, 1, 16,
                                   16, 1)
    _, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    wide = torch.zeros((1, 2, 16, 32), device=cuda_device)
    wide[..., ::2] = do
    with pytest.raises(ValueError, match="stride 1"):
        fa_ops.flash_attention_bwd(q, k, v, out, wide[..., ::2], lse)
    with pytest.raises(ValueError, match="lse"):
        fa_ops.flash_attention_bwd(q, k, v, out, do, lse.cpu())


def test_train_step_on_card_matches_the_cpu(cuda_device):
    from repro_torch.train import init_train_state, make_train_step
    cfg = reduced_config("stablelm-1.6b")
    states = [init_train_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
        for dev in ("cpu", cuda_device)]
    with torch.no_grad():
        for (_, a), (_, b) in zip(states[0].model.named_parameters(),
                                  states[1].model.named_parameters()):
            b.copy_(a)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones((4, 64), np.float32)}
    kw = dict(base_lr=1e-3, warmup=0, total_steps=10, grad_accum=2)
    start = {n: p.detach().clone()
             for n, p in states[1].model.named_parameters()}
    before = fa_ops.flash_attention_bwd_launches
    mets = []
    for st, dev in zip(states, ("cpu", cuda_device)):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        mets.append(make_train_step(cfg, **kw)(st, tb)[1])
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd_launches - before == \
        cfg.n_layers * kw["grad_accum"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mets[1][k]), float(mets[0][k]),
                                   rtol=1e-4, err_msg=k)
    # AdamW's first step is lr sign(g): a gradient within rounding of zero
    # may take either sign on the two devices
    atol = 2 * float(mets[0]["lr"]) + 1e-5
    for (n, a), (_, b) in zip(states[0].model.named_parameters(),
                              states[1].model.named_parameters()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=0, atol=atol,
                                   err_msg=n)
    # the step moved the card's parameters (by about lr each) ...
    moved = max(float((p.detach() - start[n]).abs().max())
                for n, p in states[1].model.named_parameters())
    assert moved >= 0.5 * float(mets[1]["lr"])
    # ... and its moments are the gradients' averages, held at the
    # gradients' tolerance (f32, other summation orders on the two devices)
    for got, want in ((states[1].opt.mu, states[0].opt.mu),
                      (states[1].opt.nu, states[0].opt.nu)):
        assert set(got) == set(want)
        for n, w in want.items():
            err = float((got[n].cpu() - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + 1e-30, (n, err)


# ---------------------------------------------------------------------------
# The sharded engine on one card: segment views at any row offset.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("segs,k", [(24, 160), (24, 7), (8, 33)])
def test_xtx_on_every_segment_view(cuda_device, segs, k):
    """Each segment's rows of x and y as the sharded engine hands them to
    xtx (views: y's start is 4 mod 16 bytes for odd rows per segment):
    bitwise the plain version."""
    rows = 4_167 if segs == 24 else 3_001
    draw = Draw(segs + k)
    x = torch.from_numpy(draw.dyadic((segs * rows, k))).to(cuda_device)
    y = torch.from_numpy(draw.dyadic((segs * rows,))).to(cuda_device)
    assert any(y[s * rows:].data_ptr() % 16 for s in range(segs))
    for s in range(segs):
        xs, ys = x[s * rows:(s + 1) * rows], y[s * rows:(s + 1) * rows]
        got = xtx_ops.xtx_xty(xs, ys)
        want = xtx_ref.xtx_xty_ref(xs, ys)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", [32, 33])
def test_kmeans_assign_on_every_segment_view(cuda_device, d):
    """kmeans_assign on each of 24 segments' views of x and the row
    weights (starts off 16 bytes where rows per segment are odd): bitwise
    the plain version."""
    segs, rows = 24, 1_001
    draw = Draw(d)
    x, c, m = _km_inputs(draw, segs * rows, d, 16, cuda_device, False)
    assert any(m[s * rows:].data_ptr() % 16 for s in range(segs))
    for s in range(segs):
        part = slice(s * rows, (s + 1) * rows)
        got = km_ops.assign_and_reduce(x[part], c, m[part])
        want = km_ref.assign_and_reduce_ref(x[part], c, m[part])
        torch.cuda.synchronize()
        assert torch.equal(got[0].long(), want[0])
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)


def test_sharded_engines_launch_once_per_segment(cuda_device):
    """24 segments on one card: run_sharded and the sharded GROUP BY
    launch their kernel once per segment and fold bitwise what the local
    engine folds (dyadic data)."""
    from repro_torch.core import make_mesh, run_sharded
    segs, n = 24, 24 * 2_083
    draw = Draw(24)
    cols = {"x": draw.dyadic((n, 9)), "y": draw.dyadic((n,)),
            "item": _items(draw, n), "g": draw.ints((n,), 0, 63)}
    t = Table.from_columns(cols, device=cuda_device)
    d = t.distribute(make_mesh((segs,), ("data",),
                               devices=[cuda_device] * segs))
    before = xtx_ops.xtx_launches
    got = run_sharded(LinregrAggregate(use_kernel=True), d.select("x", "y"),
                      finalize=False)
    assert xtx_ops.xtx_launches == before + segs
    want = run_local(LinregrAggregate(use_kernel=True), t.select("x", "y"),
                     finalize=False)
    for key in want:
        assert torch.equal(got[key], want[key])
    for agg, counter in ((LinregrAggregate(use_kernel=True),
                          "segment_linregr_launches"),
                         (CountMinAggregate(use_kernel=True),
                          "segment_countmin_launches"),
                         (FMAggregate(use_kernel=True),
                          "segment_fm_launches")):
        cols_of = ("x", "y", "g") if isinstance(agg, LinregrAggregate) \
            else ("item", "g")
        before = getattr(sf_ops, counter)
        got = run_grouped(agg, d.select(*cols_of), "g", 64,
                          method="segment", finalize=False)
        assert getattr(sf_ops, counter) == before + segs
        want = run_grouped(agg, t.select(*cols_of), "g", 64,
                           method="segment", finalize=False)
        got_l = got if isinstance(got, dict) else {"s": got}
        want_l = want if isinstance(want, dict) else {"s": want}
        for key in want_l:
            assert torch.equal(got_l[key], want_l[key])
