"""The port's GPipe schedule (``distributed/pipeline.py``) against the
sequential run and against the JAX package's ``make_pipeline``.

The reference's pipeline runs over ``pod = 4`` of a (4, 2) mesh in the
shared 8-device subprocess (``torch_dist_reference``) with its own
test's stage function.  Tolerances: against the sequential run of the
same micro-batches through the same stages, bitwise (the schedule only
reorders whole stage calls); against JAX, rtol 1e-6, atol 1e-6 in f32
(``tanh`` and a 16-wide product in each of four stages).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_reference as R
from repro.distributed.pipeline import bubble_fraction as j_bubble
from repro_torch.configs import base as tbase
from repro_torch.core.compat import make_mesh
from repro_torch.distributed.pipeline import bubble_fraction, make_pipeline
from repro_torch.models import model as M


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.load(tmp_path_factory)


def _mesh(shape, names=("pod", "model")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _stage(p, a):
    return a + torch.tanh(a @ p["w"] + p["b"])


def _sequential(stage_fn, params, x, n_stages):
    out = []
    for mb in x:
        for s in range(n_stages):
            mb = stage_fn({k: v[s] for k, v in params.items()}, mb)
        out.append(mb)
    return torch.stack(out)


def test_gpipe_matches_sequential_bitwise_and_jax(ref):
    params = {k: torch.from_numpy(ref[f"pipe/{k}"]) for k in ("w", "b")}
    x = torch.from_numpy(ref["pipe/x"])
    pipe = make_pipeline(_mesh((4, 2)), _stage, stage_axis="pod")
    out = pipe(params, x)
    assert torch.equal(out, _sequential(_stage, params, x, 4))
    np.testing.assert_allclose(out.numpy(), ref["pipe/out"], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("stages,micro", [(1, 3), (2, 1), (2, 5), (3, 4)])
def test_gpipe_runs_every_stage_every_tick(stages, micro):
    calls = []

    def stage_fn(p, a):
        calls.append(1)
        return a * p["w"] + 1.0

    w = torch.arange(1.0, stages + 1.0)
    x = torch.randn(micro, 2, 3, generator=torch.Generator().manual_seed(0))
    out = make_pipeline(_mesh((stages, 1)), stage_fn)({"w": w}, x)
    assert len(calls) == stages * (micro + stages - 1)
    calls.clear()
    assert torch.equal(out, _sequential(stage_fn, {"w": w}, x, stages))


class _Stage(torch.nn.Module):
    """A run of model blocks as one stage function's module."""

    def __init__(self, cfg, blocks):
        super().__init__()
        self.cfg, self.blocks = cfg, blocks

    def forward(self, x):
        positions = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
        for blk in self.blocks:
            x, _ = M._run_block(self.cfg, blk, x, positions)
        return x


def test_gpipe_over_model_blocks_is_bitwise_sequential():
    cfg = dataclasses.replace(tbase.reduced_config("stablelm-1.6b"),
                              n_layers=4)
    model = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    stages = [_Stage(cfg, model.blocks[2 * s:2 * s + 2]) for s in range(2)]
    names = [n for n, _ in stages[0].named_parameters()]
    stacked = {n: torch.stack([dict(st.named_parameters())[n]
                               for st in stages]) for n in names}

    def stage_fn(p, a):
        return torch.func.functional_call(stages[0], p, (a,))

    toks = torch.randint(0, cfg.vocab, (3, 1, 8),
                         generator=torch.Generator().manual_seed(1))
    x = model.embed[toks]
    got = make_pipeline(_mesh((2,), ("pod",)), stage_fn)(stacked, x)
    want = torch.stack([stages[1](stages[0](mb)) for mb in x])
    assert torch.equal(got, want)


def test_bubble_fraction_matches_jax():
    for s, m in [(1, 8), (4, 8), (4, 16), (8, 3)]:
        assert bubble_fraction(s, m) == j_bubble(s, m)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
