"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's, on the CPU, from the same numpy trees.

Tolerances: f32 parameters, moments, clipped gradients and schedule
values within rtol 1e-6 (atol 1e-7 for entries near zero): the same f32
formulas, where the two libraries may round a power, a square root or a
fused multiply-add in another place.  bf16 parameters within one bf16
step of the value (rtol 2^-7): both update in f32 and round once, so a
last-bit difference in f32 can move that rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from strategies import Draw

SHAPES = {"w": (8, 16), "b": (16,), "e": (3, 5, 2)}
RTOL, ATOL = 1e-6, 1e-7
BF16_STEP = 2.0 ** -7


def _tree(draw, scale=1.0):
    return {k: draw.normal(s) * scale for k, s in SHAPES.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _j(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_steps(dtype):
    draw = Draw(11)
    p0 = _tree(draw)
    tp, jp = _t(p0, getattr(torch, dtype)), _j(p0, jnp.dtype(dtype))
    tstate, jstate = topt.adamw_init(tp), jopt.adamw_init(jp)
    for step in range(3):
        g = _tree(draw, scale=0.1 * (step + 1))
        lr = 1e-2 * (step + 1)
        tp, tstate = topt.adamw_update(_t(g, getattr(torch, dtype)), tstate,
                                       tp, lr=lr)
        jp, jstate = jopt.adamw_update(_j(g, jnp.dtype(dtype)), jstate, jp,
                                       lr=lr)
        assert all(v.dtype == getattr(torch, dtype) for v in tp.values())
        _close(tstate.mu, jstate.mu)
        _close(tstate.nu, jstate.nu)
        assert int(tstate.count) == int(jstate.count) == step + 1
        if dtype == "float32":
            _close(tp, jp)
        else:
            _close(tp, jp, rtol=BF16_STEP, atol=0)


def test_adamw_takes_a_tensor_lr_and_updates_in_place():
    draw = Draw(12)
    p = _t(_tree(draw))
    ids = {k: id(v) for k, v in p.items()}
    state = topt.adamw_init(p)
    g = _t(_tree(draw))
    lr = topt.linear_warmup_cosine(torch.tensor(5, dtype=torch.int32),
                                   base_lr=1e-2, warmup_steps=2,
                                   total_steps=10)
    p2, _ = topt.adamw_update(g, state, p, lr=lr)
    assert p2 is p and {k: id(v) for k, v in p.items()} == ids
    jp, _ = jopt.adamw_update(_j({k: v.numpy() for k, v in g.items()}),
                              jopt.adamw_init(_j(_tree(Draw(12)))),
                              _j(_tree(Draw(12))),
                              lr=float(lr))
    _close(p, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgdm_matches_jax(dtype):
    draw = Draw(13)
    p0 = _tree(draw)
    tp, jp = _t(p0, getattr(torch, dtype)), _j(p0, jnp.dtype(dtype))
    tm, jm = topt.sgdm_init(tp), jopt.sgdm_init(jp)
    for step in range(3):
        g = _tree(draw)
        tp, tm = topt.sgdm_update(_t(g, getattr(torch, dtype)), tm, tp,
                                  lr=0.05)
        jp, jm = jopt.sgdm_update(_j(g, jnp.dtype(dtype)), jm, jp, lr=0.05)
        _close(tm, jm)
        if dtype == "float32":
            _close(tp, jp)
        else:
            _close(tp, jp, rtol=BF16_STEP, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    g0 = _tree(Draw(14))
    tg, tnorm = topt.clip_by_global_norm(_t(g0, getattr(torch, dtype)),
                                         max_norm)
    jg, jnorm = jopt.clip_by_global_norm(_j(g0, jnp.dtype(dtype)), max_norm)
    assert tnorm.dtype == torch.float32 and tnorm.dim() == 0
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=RTOL)
    assert all(v.dtype == getattr(torch, dtype) for v in tg.values())
    if dtype == "float32":
        _close(tg, jg)
    else:
        _close(tg, jg, rtol=BF16_STEP, atol=0)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 99, 100, 250])
def test_schedules_match_jax(step):
    ts = torch.tensor(step, dtype=torch.int32)
    js = jnp.asarray(step, jnp.int32)
    got = topt.cosine_schedule(ts, base_lr=3e-4, total_steps=100)
    want = jopt.cosine_schedule(js, base_lr=3e-4, total_steps=100)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    got = topt.linear_warmup_cosine(ts, base_lr=3e-3, warmup_steps=10,
                                    total_steps=100)
    want = jopt.linear_warmup_cosine(js, base_lr=3e-3, warmup_steps=10,
                                     total_steps=100)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    jax.block_until_ready(want)
