"""The column_stats kernel (``csrc/column_stats.cu``) and the profile
transition that calls it.

On the CPU: the registry entry, its cost, the dispatch policy (the plain
version on CPU tensors, the shape path on meta tensors), the wrapper's
checks and launch plan, and that the plain version and the transition
give, bit for bit, what the transition's eager arithmetic gave before it
went through the registry (``_old_transition`` below).

On the card (the ``cuda`` marker; skipped with a reason where there is
no card, decided inside the fixture): the kernel against its plain
version on the same card.  Dyadic draws here are multiples of 1/4 with
a standard deviation of 1/2, so every f32 sum and sum of squares is
exact up to 4 million rows in any order, and the two agree bit for bit.
The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_column_stats.py
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import run_local, trace_execution
from repro_torch.core.table import Table
from repro_torch.core.templates import ProfileAggregate
from repro_torch.kernels import registry
from repro_torch.kernels.column_stats import ops as cs_ops
from repro_torch.kernels.column_stats import ref as cs_ref
from repro_torch.methods.profile import profile
from strategies import Draw

STATS = ("count", "sum", "sumsq", "min", "max")


def _old_transition(state, block, mask):
    """``ProfileAggregate.transition`` as it was before the kernel: the
    eager per-column arithmetic, with the inf scalar made on the column's
    device."""
    out = {}
    for name, st in state.items():
        col = block[name].to(torch.float32)
        mr = mask.reshape((-1,) + (1,) * (col.dim() - 1))
        m = mr.to(torch.float32)
        inf = torch.tensor(float("inf"), device=col.device)
        out[name] = {
            "count": st["count"] + mask.to(torch.float32).sum(),
            "sum": st["sum"] + (col * m).sum(dim=0),
            "sumsq": st["sumsq"] + (col * col * m).sum(dim=0),
            "min": torch.minimum(st["min"],
                                 torch.where(mr, col, inf).amin(dim=0)),
            "max": torch.maximum(st["max"],
                                 torch.where(mr, col, -inf).amax(dim=0)),
        }
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _draw(draw: Draw, shape, kind: str) -> np.ndarray:
    if kind == "dyadic":
        return draw.dyadic(shape)
    return draw.normal(shape)


# ---------------------------------------------------------------------------
# CPU: registry, dispatch, checks, plan.
# ---------------------------------------------------------------------------

def test_registry_lists_column_stats_with_its_cost():
    assert "column_stats" in registry.available()
    entry = registry.get("column_stats")
    assert entry.ref is cs_ref.column_stats_ref
    assert entry.cuda is cs_ops.column_stats
    col, mask = torch.ones((10, 4)), torch.ones(10, dtype=torch.bool)
    assert entry.cost(col, mask) == cs_ops.column_stats_cost(10, 4)
    assert entry.cost(torch.ones(10), mask) == cs_ops.column_stats_cost(10, 1)
    # per value: 2 (sum) + 3 (sumsq) + 1 (min) + 1 (max); a count a row
    assert cs_ops.column_stats_cost(10, 4) == (
        7.0 * 40 + 10, 4.0 * 40 + 10 + 4.0 * 17)
    # folded into a state: its 17 values read and added to
    state = ProfileAggregate().init({"c": col})["c"]
    assert entry.cost(col, mask, state) == cs_ops.column_stats_cost(
        10, 4, True) == (7.0 * 40 + 10 + 17, 4.0 * 40 + 10 + 8.0 * 17)
    assert entry.cost(torch.ones((10, 2, 3)), mask) == \
        cs_ops.column_stats_cost(10, 6)


@pytest.mark.parametrize("shape", [(9,), (9, 1), (9, 5)])
def test_cpu_dispatch_runs_the_plain_version_and_records_it(shape):
    draw = Draw(3)
    col = torch.from_numpy(draw.dyadic(shape))
    mask = torch.from_numpy(draw.bools((9,), 0.6))
    before = cs_ops.column_stats_launches
    with trace_execution() as tr:
        got = registry.dispatch("column_stats", col, mask)
    assert cs_ops.column_stats_launches == before
    assert [(e.engine, e.detail["name"], e.detail["requested"])
            for e in tr.kernels] == [("ref", "column_stats", "auto")]
    want = cs_ref.column_stats_ref(col, mask)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert got[0].shape == () and all(g.shape == shape[1:] for g in got[1:])


@pytest.mark.parametrize("shape", [(9,), (9, 5)])
def test_meta_dispatch_returns_the_shapes_and_launches_nothing(shape):
    col = torch.empty(shape, device="meta")
    mask = torch.empty((9,), dtype=torch.bool, device="meta")
    before = cs_ops.column_stats_launches
    with trace_execution() as tr:
        got = registry.dispatch("column_stats", col, mask)
    assert cs_ops.column_stats_launches == before
    assert [e.engine for e in tr.kernels] == ["meta"]
    assert [(tuple(g.shape), g.dtype, g.is_meta) for g in got] == [
        ((), torch.float32, True)] + [
        (shape[1:], torch.float32, True)] * 4


def test_meta_transition_keeps_the_state_shapes():
    block = {"x": torch.empty((16, 2, 3), device="meta"),
             "y": torch.empty((16,), device="meta"),
             "k": torch.empty((16,), dtype=torch.int32, device="meta")}
    mask = torch.empty((16,), dtype=torch.bool, device="meta")
    agg = ProfileAggregate()
    state = agg.init(block)
    before = cs_ops.column_stats_launches
    out = agg.transition(state, block, mask)
    assert cs_ops.column_stats_launches == before
    assert {c: {s: (tuple(v.shape), v.dtype) for s, v in st.items()}
            for c, st in out.items()} == \
        {c: {s: (tuple(v.shape), v.dtype) for s, v in st.items()}
         for c, st in state.items()}


@pytest.mark.parametrize("col,mask,err", [
    (torch.ones((4, 2), dtype=torch.float64), torch.ones(4, dtype=torch.bool),
     TypeError),
    (torch.tensor(1.0), torch.ones(1, dtype=torch.bool), ValueError),
    (torch.ones((4, 0)), torch.ones(4, dtype=torch.bool), ValueError),
    (torch.ones((4, 2)), torch.ones(4), ValueError),
    (torch.ones((4, 2)), torch.ones(5, dtype=torch.bool), ValueError),
    (torch.ones((4, 2)), torch.ones(4, dtype=torch.bool, device="meta"),
     ValueError),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(col, mask, err):
    with pytest.raises(err):
        cs_ops.column_stats(col, mask)


@pytest.mark.parametrize("key,bad", [
    ("sum", torch.zeros(3)),                       # another width
    ("count", torch.zeros(1)),                     # not a scalar
    ("min", torch.zeros(2, dtype=torch.float64)),  # not float32
    ("max", torch.zeros(2, device="meta")),        # another device
])
def test_wrapper_raises_on_a_state_the_kernel_does_not_take(key, bad):
    col, mask = torch.ones((4, 2)), torch.ones(4, dtype=torch.bool)
    state = ProfileAggregate().init({"c": col})["c"]
    cs_ops.column_stats(col, mask, state)
    with pytest.raises(ValueError, match=key):
        cs_ops.column_stats(col, mask, dict(state, **{key: bad}))


@pytest.mark.parametrize("shape", [(9,), (9, 5), (9, 2, 3)])
def test_dispatch_folds_into_a_state_as_the_old_transition(shape):
    draw = Draw(11)
    col = torch.from_numpy(draw.dyadic(shape))
    mask = torch.from_numpy(draw.bools((9,), 0.6))
    agg = ProfileAggregate()
    state = _old_transition(agg.init({"c": col}), {"c": col}, ~mask)["c"]
    got = registry.dispatch("column_stats", col, mask, state)
    want = _old_transition({"c": state}, {"c": col}, mask)["c"]
    for s, g in zip(STATS, got):
        assert g.shape == want[s].shape, s
        assert torch.equal(_bits(g), _bits(want[s])), s


@pytest.mark.parametrize("k,vec,want", [
    (320, True, (80, 3, 1)),      # the Fig. 4 table's x
    (1, False, (1, 256, 1)),      # a 1-D column: threads down the rows
    (3, False, (3, 85, 1)),
    (5, False, (5, 51, 1)),
    (4, True, (1, 256, 1)),
    (1000, True, (250, 1, 1)),
    (1100, True, (256, 1, 2)),    # past one CTA's lanes: column tiles
    (2050, False, (256, 1, 9)),
])
def test_layout_picks_the_mapping_from_the_width(k, vec, want):
    groups, lanes, tiles = cs_ops.layout(k, vec)
    assert (groups, lanes, tiles) == want
    assert groups * lanes <= 256 and groups * tiles * (4 if vec else 1) >= k


@pytest.mark.parametrize("n,lanes,tiles", [
    (0, 3, 1), (1, 256, 1), (7, 3, 1), (4099, 85, 1), (4096, 256, 1),
    (10_000_000, 3, 1), (10_000_000, 256, 1), (1_000_003, 1, 9),
    (2 ** 20, 6, 1)])
def test_splits_cover_the_rows_and_shrink_for_small_blocks(n, lanes, tiles):
    sms = 132
    ctas, rows = cs_ops.splits(n, lanes, tiles, sms)
    assert ctas >= 1 and rows >= 1
    assert ctas * rows >= n and (ctas - 1) * rows < max(n, 1)
    assert ctas * tiles <= max(tiles, 4 * sms)
    if n <= lanes * 32:
        assert ctas == 1
    if n >= 4 * sms * lanes * 32:
        assert ctas == 4 * sms // tiles


# ---------------------------------------------------------------------------
# CPU: the plain version and the transition are the old arithmetic.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dyadic", "gaussian"])
@pytest.mark.parametrize("shape", [(1,), (37,), (37, 1), (37, 6),
                                   (37, 2, 3)])
@pytest.mark.parametrize("p_valid", [1.0, 0.5, 0.0])
def test_plain_version_is_the_old_transition_bit_for_bit(kind, shape,
                                                         p_valid):
    draw = Draw(sum(shape) * 10 + int(p_valid * 4) + (kind == "gaussian"))
    n = shape[0]
    block = {"c": torch.from_numpy(_draw(draw, shape, kind)),
             "i": torch.from_numpy(draw.ints((n,), -9, 9))}
    mask = torch.from_numpy(draw.bools((n,), p_valid)) if 0 < p_valid < 1 \
        else torch.full((n,), bool(p_valid))
    agg = ProfileAggregate()
    state = agg.init(block)
    # a state already folded once, so the merge with it is exercised too
    state = _old_transition(state, block, ~mask)
    with trace_execution() as tr:
        got = agg.transition(state, block, mask)
    want = _old_transition(state, block, mask)
    assert [e.engine for e in tr.kernels] == ["ref", "ref"]
    for c in want:
        for s in STATS:
            assert got[c][s].shape == want[c][s].shape, (c, s)
            assert torch.equal(_bits(got[c][s]), _bits(want[c][s])), (c, s)


def test_transition_takes_a_column_with_a_non_unit_inner_stride():
    draw = Draw(5)
    x = torch.from_numpy(draw.dyadic((6, 40))).T      # (40, 6), stride (1, 40)
    mask = torch.from_numpy(draw.bools((40,), 0.7))
    agg = ProfileAggregate()
    state = agg.init({"x": x})
    got = agg.transition(state, {"x": x}, mask)
    want = _old_transition(state, {"x": x}, mask)
    for s in STATS:
        assert torch.equal(_bits(got["x"][s]), _bits(want["x"][s])), s


@pytest.mark.parametrize("where", ["valid", "masked"])
def test_plain_version_keeps_nan_as_the_old_transition(where):
    col = torch.tensor([[1.0, 2.0], [3.0, -4.0], [5.0, 6.0]])
    mask = torch.tensor([True, False, True])
    col[1 if where == "masked" else 0, 0] = float("nan")
    col[1 if where == "masked" else 2, 1] = float("inf")
    state = ProfileAggregate().init({"c": col})
    got = ProfileAggregate().transition(state, {"c": col}, mask)["c"]
    want = _old_transition(state, {"c": col}, mask)["c"]
    for s in STATS:
        torch.testing.assert_close(got[s], want[s], rtol=0, atol=0,
                                   equal_nan=True)
    # a NaN (or an inf times 0) in a masked row still reaches the sums;
    # min and max see only valid rows
    assert torch.isnan(got["sum"][0]) and torch.isnan(got["sumsq"][0])
    assert torch.isnan(got["min"][0]) == (where == "valid")


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (none present)")
    return torch.device("cuda")


def _card_dyadic(shape, seed: int, device) -> torch.Tensor:
    """Multiples of 1/4 with sd 1/2, made on the card: sums and sums of
    squares exact in f32 up to 4 million rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.round(2 * torch.randn(shape, generator=g,
                                       device=device)) / 4


def _card_mask(n: int, p: float, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n,), generator=g, device=device) < p


def _assert_bitwise(got, want, what=""):
    assert len(got) == len(want) == 5
    for s, g, w in zip(STATS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, s)
        assert torch.equal(g, w), (what, s)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4099, 1_000_003])
@pytest.mark.parametrize("k", [1, 3, 4, 5, 33, 320, 1000])
def test_kernel_is_the_plain_version_bitwise_on_dyadic_data(cuda_device, k,
                                                            n):
    shape = (n,) if k == 1 else (n, k)
    col = _card_dyadic(shape, 1000 * k + n % 997, cuda_device)
    mask = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    before = cs_ops.column_stats_launches
    got = cs_ops.column_stats(col, mask)
    want = cs_ref.column_stats_ref(col, mask)
    torch.cuda.synchronize()
    assert cs_ops.column_stats_launches == before + 1
    _assert_bitwise(got, want, (k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 320, 1100, 2050])
@pytest.mark.parametrize("case", ["random", "all_masked", "offset_view"])
def test_kernel_masks_and_strides(cuda_device, k, case):
    n = 50_021
    if case == "offset_view":
        # a row-strided view 4 bytes off 16-byte alignment: the scalar path
        base = _card_dyadic((n, k + 3), k, cuda_device)
        col = base[:, 1:k + 1] if k > 1 else base[:, 1]
        assert col.data_ptr() % 16 != 0
    else:
        col = _card_dyadic((n,) if k == 1 else (n, k), k, cuda_device)
    p = 0.0 if case == "all_masked" else 0.6
    mask = _card_mask(n, p, k + 1, cuda_device)
    got = cs_ops.column_stats(col, mask)
    want = cs_ref.column_stats_ref(col, mask)
    torch.cuda.synchronize()
    _assert_bitwise(got, want, (k, case))
    if case == "all_masked":
        assert float(got[0]) == 0.0
        assert bool((got[3] == float("inf")).all())
        assert bool((got[4] == float("-inf")).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 320])
def test_padded_tail_of_the_blocked_fold_matches_the_cpu(cuda_device, k):
    """A profile in blocks whose last one is padded with masked zero rows
    (``_blocked_fold``), against the same fold on the CPU: bitwise."""
    n = 10_007
    x = _card_dyadic((n,) if k == 1 else (n, k), 77 + k, cuda_device)
    mask = _card_mask(n, 0.8, 78, cuda_device)
    cols = {"x": x, "y": _card_dyadic((n,), 79, cuda_device)}
    before = cs_ops.column_stats_launches
    got = run_local(ProfileAggregate(), Table(cols), block_size=4096,
                    mask=mask, finalize=False)
    torch.cuda.synchronize()
    assert cs_ops.column_stats_launches == before + 2 * 3
    cpu = {c: v.cpu() for c, v in cols.items()}
    want = run_local(ProfileAggregate(), Table(cpu), block_size=4096,
                     mask=mask.cpu(), finalize=False)
    for c in want:
        for s in STATS:
            assert torch.equal(got[c][s].cpu(), want[c][s]), (c, s)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4099, 320), (1_000_003, 320),
                                 (1_000_003, 1), (200_000, 33)])
def test_kernel_on_gaussian_data(cuda_device, n, k):
    g = torch.Generator(device=cuda_device).manual_seed(n + k)
    shape = (n,) if k == 1 else (n, k)
    col = torch.randn(shape, generator=g, device=cuda_device)
    mask = _card_mask(n, 0.9, n, cuda_device)
    got = cs_ops.column_stats(col, mask)
    again = cs_ops.column_stats(col, mask)
    want = cs_ref.column_stats_ref(col, mask)
    torch.cuda.synchronize()
    # deterministic: a fixed order of every sum
    for a, b in zip(got, again):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for i in (1, 2):
        m = mask.double().reshape((-1,) + (1,) * (col.dim() - 1))
        exact = (col.double() ** i * m).sum(0)
        scale = (col.double() ** 2).sum(0).sqrt() if i == 1 \
            else exact.abs()
        for v in (got[i], want[i]):
            assert float(((v.double() - exact).abs() / scale).max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["valid", "masked"])
def test_kernel_keeps_nan_as_the_plain_version(cuda_device, where):
    n, k = 4099, 8
    col = _card_dyadic((n, k), 5, cuda_device)
    mask = _card_mask(n, 0.5, 6, cuda_device)
    valid = int(torch.nonzero(mask)[0])
    masked = int(torch.nonzero(~mask)[0])
    row = valid if where == "valid" else masked
    col[row, 0] = float("nan")
    col[row, 1] = float("inf")
    col[row, 2] = float("-inf")
    got = cs_ops.column_stats(col, mask)
    want = cs_ref.column_stats_ref(col, mask)
    torch.cuda.synchronize()
    for s, g, w in zip(STATS, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{where} {s}")
    assert bool(torch.isnan(got[1][0]))
    assert bool(torch.isnan(got[3][0])) == (where == "valid")


class _WholeColumnOps(TorchDispatchMode):
    """Records every op (but allocations and views) whose output has at
    least ``n`` elements."""

    def __init__(self, n: int):
        super().__init__()
        self.n, self.seen = n, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = out if isinstance(out, (tuple, list)) else (out,)
        big = any(isinstance(o, torch.Tensor) and o.numel() >= self.n
                  for o in outs)
        if big and name not in ("empty", "new_empty", "view", "_unsafe_view",
                                "slice", "select", "reshape", "alias",
                                "detach", "t", "transpose", "as_strided"):
            self.seen.append(name)
        return out


@pytest.mark.cuda
def test_profile_launches_once_a_column_and_no_whole_column_op(cuda_device):
    n = 100_003
    t = Table({"x": _card_dyadic((n, 12), 1, cuda_device),
               "y": _card_dyadic((n,), 2, cuda_device)})
    before = cs_ops.column_stats_launches
    with trace_execution() as tr:
        stats = profile(t)
    torch.cuda.synchronize()
    assert cs_ops.column_stats_launches == before + 2
    assert [(e.detail["name"], e.engine) for e in tr.kernels] == [
        ("column_stats", "cuda")] * 2
    cpu = profile(Table({c: v.cpu() for c, v in t.columns.items()}))
    for c in cpu:
        for s in STATS:
            assert torch.equal(stats[c][s].cpu(), cpu[c][s]), (c, s)
    agg = ProfileAggregate()
    block = dict(t.columns)
    mask = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    state = agg.init(block)
    with _WholeColumnOps(n) as seen:
        agg.transition(state, block, mask)
    assert seen.seen == []


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4099,), (4099, 5), (50_021, 320),
                                   (4099, 2, 3)])
def test_kernel_folds_into_a_state_as_the_plain_version(cuda_device, shape):
    """The reduce kernel adds the block into a running state as the eager
    fold did; the state holds NaN, infinities and signed values."""
    n = shape[0]
    col = _card_dyadic(shape, n + len(shape), cuda_device)
    mask = _card_mask(n, 0.7, n, cuda_device)
    prior = cs_ref.column_stats_ref(
        _card_dyadic(shape, 7, cuda_device), ~mask)
    state = dict(zip(STATS, prior))
    flat = state["sum"].view(-1)
    if flat.numel() > 2:
        flat[1] = float("nan")
        state["min"].view(-1)[2] = float("nan")
        state["max"].view(-1)[0] = float("-inf")
    before = cs_ops.column_stats_launches
    got = cs_ops.column_stats(col, mask, state)
    want = cs_ref.column_stats_ref(col, mask, state)
    torch.cuda.synchronize()
    assert cs_ops.column_stats_launches == before + 1
    for s, g, w in zip(STATS, got, want):
        assert g.shape == w.shape, s
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=s)
        # bit for bit but NaN's payload (min.NaN gives the canonical NaN)
        nan = torch.isnan(w)
        assert torch.equal(_bits(g)[~nan], _bits(w)[~nan]), s


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["transposed", "every_other", "three_d",
                                  "three_d_strided"])
def test_kernel_reads_strided_columns_where_they_lie(cuda_device, view):
    n = 50_021
    if view == "transposed":          # (n, 6), strides (1, n)
        col = _card_dyadic((6, n), 1, cuda_device).T
    elif view == "every_other":       # (n, 7), strides (14, 2)
        col = _card_dyadic((n, 14), 2, cuda_device)[:, ::2]
    elif view == "three_d":           # (n, 2, 3), one stride apart
        col = _card_dyadic((n, 2, 3), 3, cuda_device)
    else:                             # (n, 2, 3) out of (n, 2, 4): copied
        col = _card_dyadic((n, 2, 4), 4, cuda_device)[:, :, :3]
    mask = _card_mask(n, 0.6, 5, cuda_device)
    got = cs_ops.column_stats(col, mask)
    want = cs_ref.column_stats_ref(col, mask)
    torch.cuda.synchronize()
    _assert_bitwise(got, want, view)


@pytest.mark.cuda
def test_profile_reads_a_transposed_column_without_a_copy(cuda_device):
    n = 100_003
    x = _card_dyadic((12, n), 1, cuda_device).T
    agg = ProfileAggregate()
    block = {"x": x}
    mask = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    state = agg.init(block)
    with _WholeColumnOps(n) as seen:
        got = agg.transition(state, block, mask)
    assert seen.seen == []
    want = _old_transition(state, block, mask)
    for s in STATS:
        assert torch.equal(got["x"][s], want["x"][s]), s
