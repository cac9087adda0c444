"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU in f32, at the reduced MoE configs.

Weights come from the reference's ``init_moe`` and cross as numpy arrays
(``interop.params_from_numpy``); activations are numpy draws.  Tolerance
rtol = atol = 1e-5: the order of operations is the reference's (the
combine sums each token's slots in slot order, as its scatter-add does),
and the two libraries differ only in how their matmuls sum f32
products, about 1e-6 here.  The routing itself (top-k, capacity, drops)
must agree exactly: ``drop_frac`` is a count over N k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch.configs import base as tbase
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe as MOE
from strategies import Draw

RTOL = ATOL = 1e-5


def _moe_pair(arch, seed=0, **change):
    """(port cfg, JAX cfg, port MoE, JAX params) for ``arch``'s reduced
    config with ``change`` applied to both."""
    cfg = dataclasses.replace(tbase.reduced_config(arch), **change)
    jcfg = dataclasses.replace(jbase.reduced_config(arch), **change)
    store = JL.ParamStore(jax.random.PRNGKey(seed), jnp.float32)
    JMOE.init_moe(store, jcfg, "moe")
    jp = store.params["moe"]
    mod = MOE.MoE(cfg, torch.float32, "cpu")
    params_from_numpy(mod, jax.tree.map(np.asarray, jp))
    return cfg, jcfg, mod, jp


def _check(cfg, jcfg, mod, jp, x):
    got, aux = MOE.run_moe(mod, cfg, torch.from_numpy(x))
    want, jaux = JMOE.run_moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert set(aux) == set(jaux) == {"aux_loss", "drop_frac"}
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=RTOL, atol=ATOL)
    assert float(aux["drop_frac"]) == pytest.approx(
        float(jaux["drop_frac"]), abs=1e-7)
    return aux


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
@pytest.mark.parametrize("b,s", [(2, 16), (1, 3)])
def test_run_moe_matches_jax(arch, b, s):
    cfg, jcfg, mod, jp = _moe_pair(arch)
    _check(cfg, jcfg, mod, jp, Draw(b * 100 + s).normal((b, s, cfg.d_model)))


def test_run_moe_drops_tokens_as_jax():
    """capacity_factor 0.25 over 64 tokens, top-2 of 8: a capacity of 8
    slots an expert against 16 assignments each on average."""
    cfg, jcfg, mod, jp = _moe_pair("moonshot-v1-16b-a3b",
                                   capacity_factor=0.25)
    aux = _check(cfg, jcfg, mod, jp, Draw(7).normal((2, 32, cfg.d_model)))
    assert float(aux["drop_frac"]) > 0.2


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_run_moe_token_chunks_match_jax(capacity_factor):
    """moe_token_chunk = 16 over 64 tokens: four chunks, each with its own
    capacity, the aux stats averaged over them."""
    cfg, jcfg, mod, jp = _moe_pair("dbrx-132b", moe_token_chunk=16,
                                   capacity_factor=capacity_factor)
    _check(cfg, jcfg, mod, jp, Draw(8).normal((4, 16, cfg.d_model)))


def test_run_moe_tied_router_keeps_the_lower_expert():
    """Experts 2k and 2k + 1 have equal router columns, so every token's
    probabilities tie in pairs: the lower expert of a pair must be taken
    first, as jax.lax.top_k takes it."""
    cfg, jcfg, mod, jp = _moe_pair("moonshot-v1-16b-a3b")
    router = np.asarray(jp["router"]).copy()
    router[:, 1::2] = router[:, 0::2]
    jp = dict(jp, router=jnp.asarray(router))
    mod.router.copy_(torch.from_numpy(router))
    x = Draw(9).normal((2, 16, cfg.d_model))
    _check(cfg, jcfg, mod, jp, x)
    # top-2 of tied pairs: both members of the best pair, every token
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model)
                          @ mod.router, -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    assert torch.equal(top_p[:, 0], top_p[:, 1])
    assert torch.equal(top_e[:, 1], top_e[:, 0] + 1)
