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

import pytest
import torch

from repro_torch.core import Session, run_grouped, trace_execution
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
from repro_torch.methods.linregr import linregr, linregr_grouped
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
@pytest.mark.parametrize("n,depth,width", [(1, 1, 1), (4096, 4, 1024),
                                           (100_000, 8, 4096),
                                           (30_000, 8, 16384),
                                           (5000, 3, 1000)])
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
    assert sorted((e.detail["name"], e.engine) for e in tr.kernels) == [
        ("countmin", "cuda"), ("xtx", "cuda")]
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
    (70_000, 40, 100, False), (2000, 300, 700, False)])
def test_kmeans_assign_kernel_matches_plain(cuda_device, n, d, k, dup):
    """Bitwise on dyadic data, duplicate centroids (the lower index wins)
    and K = 1 included; (2000, 300, 700) keeps its partials in global
    memory, (70,000, 40, 100) stages x in two column chunks."""
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


def test_serve_on_card(cuda_device):
    toks, timings = serve("qwen3-8b", batch=2, prompt_len=4, gen_len=5)
    assert toks.shape == (2, 5) and toks.device.type == "cuda"
    assert timings["decode_tok_s"] > 0
