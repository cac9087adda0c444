"""The port's all-to-all MoE (``distributed/ep_a2a.py``) against the JAX
package on CPU meshes.

The reference's ``make_run_moe_a2a`` runs on a (2, 2) mesh in the
shared 8-device subprocess (``torch_dist_reference``) at a capacity that
drops; its per-shard routing ``_local_dispatch`` needs no mesh and runs
here.  Tolerances:

* the layer's output, ``aux_loss`` and ``drop_frac``: rtol 1e-5, atol
  1e-5 in f32 (the same products summed in other orders);
* kept masks and the kept slots' tokens: equal, on the same router
  logits; their weights rtol 1e-6 (a softmax and a division);
* with ``capacity_factor = E / k`` nothing drops, and the a2a layer
  equals the port's gather MoE within rtol 1e-5, atol 1e-5;
* the a2a layer on a repeat: bitwise (the combine is an ordered gather).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_reference as R
from repro.distributed import ep_a2a as JA
from repro_torch.configs import base as tbase
from repro_torch.core.compat import make_mesh
from repro_torch.distributed import ep_a2a as A
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe as MOE

RTOL = ATOL = 1e-5


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.load(tmp_path_factory)


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _cfg(**change):
    return dataclasses.replace(tbase.reduced_config("moonshot-v1-16b-a3b"),
                               **change)


def _moe(cfg, tree=None, seed=0):
    p = MOE.MoE(cfg, torch.float32, "cpu")
    if tree is not None:
        params_from_numpy(p, tree)
    else:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for w in p.parameters():
                w.copy_(torch.randn(w.shape, generator=g) * 0.3)
    return p


def test_a2a_layer_matches_jax(ref):
    cfg = _cfg(capacity_factor=R.A2A_CF)
    p = _moe(cfg, ref.tree("a2a/p"))
    x = torch.from_numpy(ref["a2a/x"])
    fn = A.make_run_moe_a2a(_mesh((2, 2)), cfg, batch_axes=("data",))
    out, aux = fn(p, x)
    np.testing.assert_allclose(out.numpy(), ref["a2a/out"], rtol=RTOL,
                               atol=ATOL)
    for k in ("aux_loss", "drop_frac"):
        np.testing.assert_allclose(aux[k].numpy(), ref[f"a2a/{k}"],
                                   rtol=RTOL, atol=ATOL)
    assert 0.0 < float(aux["drop_frac"]) < 1.0
    again, aux2 = fn(p, x)
    assert torch.equal(again, out)
    assert all(torch.equal(aux[k], aux2[k]) for k in aux)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_local_dispatch_keeps_what_jax_keeps(ref, cf):
    cfg = _cfg(capacity_factor=cf)
    x = ref["a2a/x"]
    router = ref["a2a/p/router"]
    e, k = cfg.n_experts, cfg.top_k
    # each (batch shard, sequence shard) of the (2, 2) mesh
    for xs in (x[b:b + 2, s:s + 32] for b in (0, 2) for s in (0, 32)):
        xf = xs.reshape(-1, x.shape[-1])
        n = xf.shape[0]
        cap = MOE._capacity(n, cfg)
        assert cap == max(8, -(-int(n * k * cf / e) // 8) * 8)
        logits = np.asarray(jnp.asarray(xf) @ jnp.asarray(router),
                            np.float32)
        jt, jw, jv, jaux = (np.asarray(a) for a in JA._local_dispatch(
            jnp.asarray(xf), jnp.asarray(logits), e, k, cap))
        tok, w, valid, aux, _, _ = A._local_dispatch(
            torch.from_numpy(xf), torch.from_numpy(logits), e, k, cap)
        np.testing.assert_array_equal(valid.numpy(), jv)
        kept = jv > 0
        np.testing.assert_array_equal(tok.numpy()[kept], jt[kept])
        np.testing.assert_allclose(w.numpy(), jw, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_a2a_equals_gather_when_nothing_drops():
    cfg = _cfg()
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    p = _moe(cfg)
    x = torch.randn(4, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    out, aux = A.make_run_moe_a2a(_mesh((2, 4)), cfg,
                                  batch_axes=("data",))(p, x)
    want, want_aux = MOE.run_moe(p, cfg, x)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert float(aux["drop_frac"]) == 0.0 == float(want_aux["drop_frac"])


@pytest.mark.parametrize("shape,x_shape,match", [
    ((2, 2), (4, 15, 64), "sequence"),        # S on the expert axis
    ((4, 2), (2, 16, 64), "batch"),           # B on the batch axis
    ((1, 3), (2, 12, 64), "experts"),         # E on the expert axis
])
def test_a2a_raises_where_shard_map_would(shape, x_shape, match):
    cfg = _cfg()
    p = _moe(cfg)
    with pytest.raises(ValueError, match=match):
        A.make_run_moe_a2a(_mesh(shape), cfg, batch_axes=("data",))(
            p, torch.zeros(x_shape))


def test_a2a_gradient_flows_through_the_shards():
    cfg = _cfg()
    p = _moe(cfg)
    p.requires_grad_(True)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    out, aux = A.make_run_moe_a2a(_mesh((1, 2)), cfg,
                                  batch_axes=("data",))(p, x)
    g = torch.autograd.grad(out.sum() + aux["aux_loss"],
                            list(p.parameters()))
    assert all(torch.isfinite(t).all() for t in g)
    assert float(g[1].abs().sum()) > 0.0          # w_gate took a gradient
