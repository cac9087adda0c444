"""The port's tagged loops (``repro_torch.launch.scan_registry``) against
the JAX package's, on the CPU.

* ``tagged_scan`` is ``jax.lax.scan`` as a Python loop: on seeded numpy
  draws its carry and stacked ys are bitwise the reference's, forward
  and with ``reverse`` (the body adds and takes maxima only, so neither
  library can contract it into another rounding);
* the registry is length-qualified, as the reference's test checks it;
* the model stack registers the reference's tags with the reference's
  trip counts: the port's forward, decode and train step of the reduced
  dense, MoE and xLSTM configs against ``jax.eval_shape`` of the
  reference's (its ``tagged_scan`` registers at trace time).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.launch.scan_registry import clear_registry as jclear
from repro.launch.scan_registry import get_registry as jget
from repro.launch.scan_registry import tagged_scan as jscan
from repro.models import model as JM
from repro.train import trainer as JT
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.scan_registry import (
    clear_registry, current_scope, get_registry, tag_scope, tagged_scan)
from repro_torch.models import model as M
from repro_torch.train import trainer as T
from strategies import Draw


def _body(c, x):
    a, b = x
    c2 = jnp.maximum(c, a) + b if isinstance(c, jax.Array) \
        else torch.maximum(c, a) + b
    return c2, (c2 + a, c2 + c)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("length", [1, 7])
def test_tagged_scan_is_bitwise_lax_scan(reverse, length):
    draw = Draw(11 + length)
    c0 = draw.normal((5,))
    xs = (draw.normal((length, 5)), draw.normal((length, 5)))
    jc, (jy1, jy2) = jscan("tagscan_test", _body, jnp.asarray(c0),
                           tuple(map(jnp.asarray, xs)), reverse=reverse)
    tc, (ty1, ty2) = tagged_scan("tagscan_test", _body,
                                 torch.from_numpy(c0),
                                 tuple(map(torch.from_numpy, xs)),
                                 reverse=reverse)
    for got, want in ((tc, jc), (ty1, jy1), (ty2, jy2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tagged_scan_without_xs_or_ys():
    clear_registry()
    carry, ys = tagged_scan("tagscan_count", lambda c, _: (c + 1, None),
                            torch.zeros(()), length=3)
    assert float(carry) == 3.0 and ys is None
    assert get_registry() == {"tagscan_count_L3": 3}
    clear_registry()


def test_scan_registry_length_qualified():
    """Same tag at two lengths registers two distinct qualified entries
    (no cross-trace corruption)."""
    clear_registry()

    def body(c, x):
        return c + x, None

    tagged_scan("tagscan_test_a", body, torch.zeros(()), torch.ones(4),
                length=4)
    tagged_scan("tagscan_test_a", body, torch.zeros(()), torch.ones(5),
                length=5)
    reg = get_registry()
    assert reg["tagscan_test_a_L4"] == 4
    assert reg["tagscan_test_a_L5"] == 5
    clear_registry()
    assert get_registry() == {}


def test_tag_scope_nests_and_names_the_innermost():
    clear_registry()
    assert current_scope() == ""
    with tag_scope("tagscan_outer", 2):
        assert current_scope() == "tagscan_outer_L2"
        with tag_scope("tagscan_inner", 3):
            assert current_scope() == "tagscan_inner_L3"
        assert current_scope() == "tagscan_outer_L2"
    assert current_scope() == ""
    assert get_registry() == {"tagscan_outer_L2": 2, "tagscan_inner_L3": 3}
    clear_registry()


# ---------------------------------------------------------------------------
# The model stack's tags against the reference's
# ---------------------------------------------------------------------------

# (arch, config changes): dense, MoE with token chunks (64 tokens in
# chunks of 16), xLSTM with its mLSTM chunks and sLSTM time loop
CASES = [("qwen3-8b", {}),
         ("moonshot-v1-16b-a3b", {"moe_token_chunk": 16}),
         ("xlstm-350m", {})]
B, S, ACCUM = 4, 16, 2


def _configs(arch, change):
    return (dataclasses.replace(reduced_config(arch), **change),
            dataclasses.replace(jreduced(arch), **change))


def _jax_tags(fn, *args) -> dict:
    jclear()
    jax.eval_shape(fn, *args)
    return jget()


def _torch_tags(fn) -> dict:
    clear_registry()
    fn()
    return get_registry()


@pytest.mark.parametrize("arch,change", CASES)
def test_forward_tags_match_jax(arch, change):
    cfg, jcfg = _configs(arch, change)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    toks = np.zeros((B, S), np.int32)
    want = _jax_tags(lambda p, t: JM.forward(p, jcfg, t), params, toks)
    model = M.Model(cfg, "meta")
    got = _torch_tags(lambda: M.forward(
        model, torch.zeros((B, S), dtype=torch.int32, device="meta")))
    assert got == want and any(k.startswith("tagscan_layers_fwd")
                               for k in got)


@pytest.mark.parametrize("arch,change", CASES)
def test_decode_tags_match_jax(arch, change):
    cfg, jcfg = _configs(arch, change)
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    state = JM.init_decode_state(jcfg, B, S)
    want = _jax_tags(lambda p, c: JM.decode_step(
        p, jcfg, c, jnp.zeros((B, 1), jnp.int32), jnp.int32(3)),
        params, state)
    model = M.Model(cfg, "meta")
    cache = M.init_decode_state(cfg, B, S, device="meta")
    got = _torch_tags(lambda: M.decode_step(
        model, cache, torch.zeros((B, 1), dtype=torch.int32,
                                  device="meta"), 3))
    assert got == want and any(k.startswith("tagscan_layers_dec")
                               for k in got)


@pytest.mark.parametrize("arch,change", CASES)
def test_train_step_tags_match_jax(arch, change):
    cfg, jcfg = _configs(arch, change)
    jstate, _ = JT.init_train_state(jcfg, jax.random.PRNGKey(0))
    batch = synthetic_batch(cfg, B, S, generator=torch.Generator())
    want = _jax_tags(JT.make_train_step(jcfg, grad_accum=ACCUM), jstate,
                     {k: v.numpy() for k, v in batch.items()})
    state = T.init_train_state(cfg, generator=torch.Generator().manual_seed(
        0), device="cpu")
    step = T.make_train_step(cfg, grad_accum=ACCUM)
    got = _torch_tags(lambda: step(state, batch))
    assert got == want and got["tagscan_grad_accum_L2"] == 2
