"""The port's kernels against the JAX package's oracles, and the port's
dispatch registry.

* The plain PyTorch versions (``repro_torch.kernels.*.ref``) against
  the jnp oracles (``repro.kernels.*.ref``) on the same numpy draws:
  bitwise on dyadic data (every partial sum exact in f32, so summation
  order cannot change a bit), allclose on Gaussian data (rtol 1e-5 of
  the largest entry: the two libraries sum in different orders).
* The wrappers on CPU tensors run the plain version and count no launch;
  they reject wrong dtypes, shapes and layouts.
* The sketch kernels' plain versions against the jnp oracles, bit for
  bit on any data (integer states), on real group-aligned layouts with
  sentinel blocks and empty groups.
* ``kmeans_assign``'s plain version against the jnp oracle and the
  Pallas body (interpret mode) on the reference's test shapes: bitwise
  on dyadic data; on Gaussian data the reference's own tolerances.
* The registry: ``auto`` on CPU runs ``ref`` and records it, a forced
  ``cuda`` on CPU raises, an unknown impl or kernel raises.

The CUDA kernels against their plain versions are in
``test_torch_cuda.py``, which imports no JAX so that it runs on the card.
"""

import numpy as np
import pytest
import torch

from repro.core.table import Table as JTable
from repro.kernels.countmin import ref as jcm_ref
from repro.kernels.kmeans_assign import ops as jkm_ops, ref as jkm_ref
from repro.kernels.segment_fold import ref as jsf_ref
from repro.kernels.xtx import ref as jxtx_ref
from repro_torch.core import trace_execution
from repro_torch.kernels import registry
from repro_torch.kernels.countmin import ops as cm_ops, ref as cm_ref
from repro_torch.kernels.kmeans_assign import ops as km_ops, ref as km_ref
from repro_torch.kernels.segment_fold import ops as sf_ops, ref as sf_ref
from repro_torch.kernels.xtx import ops as xtx_ops, ref as xtx_ref
from strategies import Draw, group_layout

XTX_SHAPES = [(64, 7), (300, 7), (257, 16), (1, 3)]


def _draw(draw: Draw, shape, kind: str) -> np.ndarray:
    return draw.dyadic(shape) if kind == "dyadic" else draw.normal(shape)


def _assert_match(got: np.ndarray, want: np.ndarray, kind: str) -> None:
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
@pytest.mark.parametrize("n,k", XTX_SHAPES)
def test_xtx_ref_matches_jax(n, k, kind):
    draw = Draw(n * 31 + k)
    x, y = _draw(draw, (n, k), kind), _draw(draw, (n,), kind)
    got = xtx_ref.xtx_xty_ref(torch.from_numpy(x), torch.from_numpy(y))
    want = jxtx_ref.xtx_xty_ref(x, y)
    for g, w in zip(got, want):
        _assert_match(g.numpy(), np.asarray(w), kind)


def _aligned(draw: Draw, n: int, k: int, G: int, pattern: str, bs: int,
             pad_to, kind: str):
    """A real group-aligned layout from the JAX package's GroupedView."""
    gids, _ = group_layout(draw, n, G, pattern)
    x, y = _draw(draw, (n, k), kind), _draw(draw, (n,), kind)
    view = JTable.from_columns({"x": x, "y": y, "g": gids}).group_by("g", G)
    cols, valid, bgids = view.aligned_blocks(bs, pad_blocks_to=pad_to)
    return tuple(np.array(a) for a in (cols["x"], cols["y"], valid, bgids))


@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
@pytest.mark.parametrize("pattern,k,pad_to", [
    ("uniform", 7, None), ("skewed", 7, 5), ("empty", 5, 3),
    ("singleton", 3, None), ("one_group", 7, 4), ("non_contiguous", 2, 2)])
def test_segment_linregr_ref_matches_jax(pattern, k, pad_to, kind):
    draw = Draw(sum(map(ord, pattern)) * 10 + k)
    G = 6
    x, y, valid, bgids = _aligned(draw, 203, k, G, pattern, 16, pad_to, kind)
    got = sf_ref.segment_linregr_ref(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(valid),
        torch.from_numpy(bgids), num_groups=G)
    want = jsf_ref.segment_linregr_ref(x, y, valid, bgids, num_groups=G)
    if pad_to:
        assert (bgids == G).any() or len(bgids) % pad_to == 0
    for name in want:
        _assert_match(got[name].numpy(), np.asarray(want[name]), kind)


def test_segment_linregr_empty_layout_raises_like_jax():
    x = np.zeros((0, 3), np.float32)
    y = np.zeros((0,), np.float32)
    valid = np.zeros((0,), bool)
    bgids = np.zeros((0,), np.int32)
    with pytest.raises(ValueError):
        jsf_ref.segment_linregr_ref(x, y, valid, bgids, num_groups=2)
    with pytest.raises(ValueError, match="equal"):
        sf_ref.segment_linregr_ref(
            torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(valid), torch.from_numpy(bgids), num_groups=2)
    with pytest.raises(ValueError, match="equal"):
        sf_ops.segment_linregr(
            torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(valid), torch.from_numpy(bgids), num_groups=2)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    draw = Draw(5)
    x = torch.from_numpy(draw.dyadic((40, 4)))
    y = torch.from_numpy(draw.dyadic((40,)))
    before = (xtx_ops.xtx_launches, sf_ops.segment_linregr_launches)
    for g, w in zip(xtx_ops.xtx_xty(x, y), xtx_ref.xtx_xty_ref(x, y)):
        assert torch.equal(g, w)
    valid = torch.ones(40, dtype=torch.bool)
    bgids = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    got = sf_ops.segment_linregr(x, y, valid, bgids, num_groups=2)
    want = sf_ref.segment_linregr_ref(x, y, valid, bgids, num_groups=2)
    assert all(torch.equal(got[q], want[q]) for q in want)
    assert (xtx_ops.xtx_launches,
            sf_ops.segment_linregr_launches) == before


@pytest.mark.parametrize("case", ["dtype", "shape", "layout", "mask_dtype",
                                  "gid_dtype"])
def test_wrappers_reject_bad_inputs(case):
    x = torch.zeros((8, 3))
    y = torch.zeros(8)
    valid = torch.ones(8, dtype=torch.bool)
    bgids = torch.zeros(2, dtype=torch.int32)
    if case == "dtype":
        with pytest.raises(TypeError):
            xtx_ops.xtx_xty(x.double(), y.double())
        with pytest.raises(TypeError):
            sf_ops.segment_linregr(x.double(), y, valid, bgids, num_groups=1)
    elif case == "shape":
        with pytest.raises(ValueError):
            xtx_ops.xtx_xty(x, y[:5])
        with pytest.raises(ValueError):
            sf_ops.segment_linregr(x, y[:5], valid, bgids, num_groups=1)
    elif case == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            xtx_ops.xtx_xty(torch.zeros((3, 8)).T, y)
        with pytest.raises(ValueError, match="contiguous"):
            sf_ops.segment_linregr(torch.zeros((3, 8)).T, y, valid, bgids,
                                   num_groups=1)
    elif case == "mask_dtype":
        with pytest.raises(TypeError):
            sf_ops.segment_linregr(x, y, valid.float(), bgids, num_groups=1)
    else:
        with pytest.raises(TypeError):
            sf_ops.segment_linregr(x, y, valid, bgids.long(), num_groups=1)


# ---------------------------------------------------------------------------
# Registry policy.
# ---------------------------------------------------------------------------

def test_registry_auto_on_cpu_runs_ref_and_records_it():
    x, y = torch.ones((4, 2)), torch.ones(4)
    with trace_execution() as t:
        out = registry.dispatch("xtx", x, y, impl="auto")
    assert torch.equal(out[0], torch.full((2, 2), 4.0))
    assert [(e.engine, e.detail["name"], e.detail["requested"])
            for e in t.kernels] == [("ref", "xtx", "auto")]
    assert registry.get("segment_linregr").resolve(
        "auto", x, y, torch.ones(4, dtype=torch.bool),
        torch.zeros(1, dtype=torch.int32)) == "ref"


def test_registry_forced_cuda_on_cpu_raises():
    x, y = torch.ones((4, 2)), torch.ones(4)
    with pytest.raises(ValueError, match="only on the card"):
        registry.dispatch("xtx", x, y, impl="cuda")


def test_registry_and_wrappers_share_one_device_rule():
    """A device that is neither the card nor the CPU is refused alike by
    the registry and by a direct call of each wrapper."""
    x, y = torch.ones((4, 2), device="meta"), torch.ones(4, device="meta")
    valid = torch.ones(4, dtype=torch.bool, device="meta")
    bgids = torch.zeros(1, dtype=torch.int32, device="meta")
    for call in (lambda: registry.dispatch("xtx", x, y, impl="auto"),
                 lambda: xtx_ops.xtx_xty(x, y),
                 lambda: sf_ops.segment_linregr(x, y, valid, bgids,
                                                num_groups=1)):
        with pytest.raises(ValueError, match="no kernel and no plain"):
            call()


def test_registry_rejects_unknown_impl_and_kernel():
    x, y = torch.ones((4, 2)), torch.ones(4)
    with pytest.raises(ValueError, match="impl must be one of"):
        registry.dispatch("xtx", x, y, impl="pallas")
    with pytest.raises(KeyError):
        registry.get("no_such_kernel")
    assert registry.available() == ("countmin", "flash_attention",
                                    "kmeans_assign", "segment_countmin",
                                    "segment_fm", "segment_linregr", "xtx")
    assert registry.IMPLS == ("auto", "ref", "cuda")
    assert [registry.resolve_impl(u) for u in (False, True, "ref", "cuda")] \
        == [None, "auto", "ref", "cuda"]
    with pytest.raises(ValueError):
        registry.resolve_impl("pallas")


# ---------------------------------------------------------------------------
# Sketch kernels: plain versions against the jnp oracles, bit for bit.
# ---------------------------------------------------------------------------

def _sketch_items(draw: Draw, n: int) -> np.ndarray:
    items = draw.ints((n,), -2 ** 31, 2 ** 31 - 1)
    items[: n // 2] %= 97                      # repeated keys
    edges = np.array([0, -1, 2 ** 31 - 1, -2 ** 31], np.int32)
    items[:4] = edges[:n]
    return items


@pytest.mark.parametrize("n,depth,width", [(1, 1, 1), (300, 4, 1024),
                                           (1000, 8, 4096), (257, 3, 7)])
def test_countmin_ref_matches_jax(n, depth, width):
    draw = Draw(n + depth + width)
    items, mask = _sketch_items(draw, n), draw.bools((n,), p=0.7)
    got = cm_ref.countmin_block_ref(torch.from_numpy(items),
                                    torch.from_numpy(mask), depth, width)
    want = jcm_ref.countmin_block_ref(items, mask, depth, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def _sketch_layout(pattern: str, pad_to, n: int = 403, G: int = 6,
                   bs: int = 16):
    """A real group-aligned layout of an item column, from the JAX
    package's GroupedView, with a ragged base mask."""
    draw = Draw(sum(map(ord, pattern)) + 3)
    gids, _ = group_layout(draw, n, G, pattern)
    view = JTable.from_columns({"item": _sketch_items(draw, n),
                                "g": gids}).group_by("g", G)
    base = view.permute(draw.bools((n,), p=0.8))
    cols, valid, bgids = view.aligned_blocks(bs, base, pad_blocks_to=pad_to)
    return tuple(np.array(a) for a in (cols["item"], valid, bgids))


LAYOUTS = [("uniform", None), ("skewed", 5), ("empty", 3),
           ("singleton", None), ("one_group", 4), ("non_contiguous", 2)]


@pytest.mark.parametrize("pattern,pad_to", LAYOUTS)
def test_segment_countmin_ref_matches_jax(pattern, pad_to):
    items, valid, bgids = _sketch_layout(pattern, pad_to)
    got = sf_ref.segment_countmin_ref(
        torch.from_numpy(items), torch.from_numpy(valid),
        torch.from_numpy(bgids), depth=4, width=128, num_groups=6)
    want = jsf_ref.segment_countmin_ref(items, valid, bgids, depth=4,
                                        width=128, num_groups=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [16, 32, 40])
@pytest.mark.parametrize("pattern,pad_to", LAYOUTS)
def test_segment_fm_ref_matches_jax(pattern, pad_to, bits):
    items, valid, bgids = _sketch_layout(pattern, pad_to)
    got = sf_ref.segment_fm_ref(
        torch.from_numpy(items), torch.from_numpy(valid),
        torch.from_numpy(bgids), num_hashes=8, bits=bits, num_groups=6)
    want = jsf_ref.segment_fm_ref(items, valid, bgids, num_hashes=8,
                                  bits=bits, num_groups=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sketch_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    items, valid, bgids = (torch.from_numpy(a)
                           for a in _sketch_layout("skewed", 5))
    before = (cm_ops.countmin_launches, sf_ops.segment_countmin_launches,
              sf_ops.segment_fm_launches)
    assert torch.equal(cm_ops.countmin_block(items, valid, 4, 64),
                       cm_ref.countmin_block_ref(items, valid, 4, 64))
    kw = {"num_groups": 6}
    assert torch.equal(
        sf_ops.segment_countmin(items, valid, bgids, depth=2, width=9, **kw),
        sf_ref.segment_countmin_ref(items, valid, bgids, depth=2, width=9,
                                    **kw))
    assert torch.equal(
        sf_ops.segment_fm(items, valid, bgids, num_hashes=3, bits=12, **kw),
        sf_ref.segment_fm_ref(items, valid, bgids, num_hashes=3, bits=12,
                              **kw))
    assert (cm_ops.countmin_launches, sf_ops.segment_countmin_launches,
            sf_ops.segment_fm_launches) == before


@pytest.mark.parametrize("case", ["mask_dtype", "shape", "depth", "width",
                                  "gid_dtype", "layout", "bits"])
def test_sketch_wrappers_reject_bad_inputs(case):
    items = torch.arange(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    bgids = torch.zeros(2, dtype=torch.int32)
    seg = {"num_groups": 1}
    if case == "mask_dtype":
        with pytest.raises(TypeError):
            cm_ops.countmin_block(items, valid.int(), 4, 16)
        with pytest.raises(TypeError):
            sf_ops.segment_fm(items, valid.int(), bgids, num_hashes=2,
                              bits=8, **seg)
    elif case == "shape":
        with pytest.raises(ValueError):
            cm_ops.countmin_block(items[:5], valid, 4, 16)
        with pytest.raises(ValueError):
            sf_ops.segment_countmin(items.reshape(4, 2), valid, bgids,
                                    depth=2, width=4, **seg)
    elif case == "depth":
        with pytest.raises(ValueError, match="depth"):
            cm_ops.countmin_block(items, valid, 9, 16)
        with pytest.raises(ValueError, match="depth"):
            sf_ops.segment_countmin(items, valid, bgids, depth=9, width=4,
                                    **seg)
    elif case == "width":
        with pytest.raises(ValueError, match="width"):
            cm_ops.countmin_block(items, valid, 4, 0)
    elif case == "gid_dtype":
        with pytest.raises(TypeError):
            sf_ops.segment_countmin(items, valid, bgids.long(), depth=2,
                                    width=4, **seg)
    elif case == "layout":
        with pytest.raises(ValueError, match="equal"):
            sf_ops.segment_fm(items, valid, torch.zeros(3, dtype=torch.int32),
                              num_hashes=2, bits=8, **seg)
    else:
        with pytest.raises(ValueError, match="bits"):
            sf_ops.segment_fm(items, valid, bgids, num_hashes=2, bits=0,
                              **seg)


def test_sketch_kernels_forced_cuda_on_cpu_raise():
    items = torch.arange(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    bgids = torch.zeros(2, dtype=torch.int32)
    for name, args, kw in (
            ("countmin", (items, valid, 4, 16), {}),
            ("segment_countmin", (items, valid, bgids),
             {"depth": 4, "width": 16, "num_groups": 1}),
            ("segment_fm", (items, valid, bgids),
             {"num_hashes": 8, "bits": 32, "num_groups": 1})):
        with pytest.raises(ValueError, match="only on the card"):
            registry.dispatch(name, *args, impl="cuda", **kw)
        with trace_execution() as t:
            registry.dispatch(name, *args, impl="auto", **kw)
        assert [e.engine for e in t.kernels] == ["ref"]


# ---------------------------------------------------------------------------
# kmeans_assign: the plain version against the jnp oracle and the Pallas
# body (interpret mode), on the reference's test shapes.
# ---------------------------------------------------------------------------

KMEANS_SHAPES = [(256, 2, 4), (777, 17, 9), (1024, 64, 32), (100, 3, 5)]


def _km_draw(n, d, k, kind, dup=False):
    """Rows, centroids at twice the rows' scale (as the reference's test
    draws them) and a 0/1 mask at p = 0.9."""
    draw = Draw(n + d + k + (kind == "dyadic"))
    if kind == "dyadic":
        x, c = draw.dyadic((n, d)), draw.dyadic((k, d), scale=2.0)
    else:
        x, c = draw.normal((n, d)), 2.0 * draw.normal((k, d))
    if dup:  # at the origin, nearest to many rows: they tie
        c[0] = 0.0
        c[1] = c[0]
    return x, c, draw.bools((n,), p=0.9).astype(np.float32)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
@pytest.mark.parametrize("n,d,k", KMEANS_SHAPES)
def test_kmeans_assign_ref_matches_jax(n, d, k, kind, oracle):
    x, c, m = _km_draw(n, d, k, kind)
    got = [a.numpy() for a in km_ref.assign_and_reduce_ref(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(m))]
    fn = jkm_ref.assign_and_reduce_ref if oracle == "ref" \
        else jkm_ops.assign_and_reduce
    want = [np.asarray(a) for a in fn(x, c, m)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    if kind == "dyadic":
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    else:  # the reference test's tolerances (tests/test_kernels.py)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)


def test_kmeans_assign_ties_take_the_lowest_index():
    """Centroid 1 is a copy of centroid 0: argmin's tie rule sends every
    row that would go to either to 0, in both packages."""
    x, c, m = _km_draw(500, 6, 5, "dyadic", dup=True)
    got = km_ref.assign_and_reduce_ref(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(m))
    want = jkm_ref.assign_and_reduce_ref(x, c, m)
    assert not bool((got[0] == 1).any()) and bool((got[0] == 0).any())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kmeans_assign_wrapper_on_cpu_and_bad_inputs():
    x, c, m = (torch.from_numpy(a) for a in _km_draw(64, 3, 4, "dyadic"))
    before = km_ops.kmeans_assign_launches
    for g, w in zip(km_ops.assign_and_reduce(x, c, m),
                    km_ref.assign_and_reduce_ref(x, c, m)):
        assert torch.equal(g, w)
    assert km_ops.kmeans_assign_launches == before
    with pytest.raises(TypeError):
        km_ops.assign_and_reduce(x.double(), c, m)
    with pytest.raises(ValueError, match="disagree"):
        km_ops.assign_and_reduce(x, c[:, :2], m)
    with pytest.raises(ValueError, match="contiguous"):
        km_ops.assign_and_reduce(torch.zeros((3, 64)).T, c, m)
    with pytest.raises(ValueError, match="must lie in"):
        km_ops.assign_and_reduce(x, torch.zeros((0, 3)), m)
    with pytest.raises(ValueError, match="only on the card"):
        registry.dispatch("kmeans_assign", x, c, m, impl="cuda")
    with trace_execution() as t:
        registry.dispatch("kmeans_assign", x, c, m, impl="auto")
    assert [e.engine for e in t.kernels] == ["ref"]


def test_kmeans_assign_splits_bound_the_scratch():
    """The persistent grid never exceeds the row tiles, fills the card
    otherwise, and keeps the partials within the scratch cap."""
    assert km_ops.splits_for(100, 64, 32, 132) == 1
    assert km_ops.splits_for(10_000_000, 64, 32, 132) == 4 * 132
    big = km_ops.splits_for(1_000_000, 1024, 256, 132)
    assert big * 4 * (1024 * 256 + 1024) <= km_ops.SCRATCH_BYTES
    assert big >= 100
