"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips with a reason when
there is no CUDA device (decided inside the fixture, never at import).
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Inputs are dyadic draws (every partial sum exact in f32), so kernel and
plain version agree bit for bit whatever their summation order.  The
end-to-end checks at the main path's size are in ``chip_smoke.py``.
"""

import pytest
import torch

from repro_torch.core import trace_execution
from repro_torch.core.table import Table
from repro_torch.kernels import registry
from repro_torch.kernels.segment_fold import ops as sf_ops, ref as sf_ref
from repro_torch.kernels.xtx import ops as xtx_ops, ref as xtx_ref
from repro_torch.methods.linregr import linregr, linregr_grouped
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
